"""PyTorch / CUDA port of the TrajNet++ baselines, for one NVIDIA H100.

Counterpart of ``trajnetplusplusbaselines_tpu``, module for module under the
same paths, with the JAX package as the reference it is tested against.  The
framework-free host code of that package (``data``, ``metrics`` and the
evaluator's writing and scoring) holds only numpy; the port keeps its own
copy of what it uses of it.  Nothing in this package imports ``jax`` or the
JAX package.

Ported so far: the serving and training paths of the LSTM family with every
interaction pool (``models/lstm.py``, ``ops/pooling``, batched prediction,
the TrajNet++ evaluator CLIs, ``losses``, Adam, the ``trainers.lstm`` CLI),
of the SGAN and of the VAE (``models/sgan.py``, ``models/vae.py``,
``trainers.sgan``, ``trainers.vae``), with the fused D-LSTM step and its
grid stage as hand-written CUDA kernels (``ops/cuda/fused_step.py``,
``csrc/``); and the classical predictors (``models/classical``: constant
velocity, the Kalman filter and social force folded over whole test sets
on the device, ORCA on the host; ``evaluator.classical_cli``,
``socialforce_eval``, ``tools.get_dest``); multi-device training and
serving over ``torch.distributed`` (``parallel``: ``--dp`` / ``--tp`` in
the trainers, the multi-process evaluator); and the tools (``tools``),
``eval_reference_checkpoint`` among them, which scores a checkpoint of the
reference implementation on the port's evaluator.  Every module of the JAX
package has its counterpart here (``tests/test_torch_surface.py``), apart
from code that exists only for the TPU toolchain (Orbax, the compile cache,
the scan recipe).
"""

__version__ = "0.1.0"
