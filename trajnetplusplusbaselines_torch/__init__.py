"""PyTorch / CUDA port of the TrajNet++ baselines, for one NVIDIA H100.

Counterpart of ``trajnetplusplusbaselines_tpu``, module for module under the
same paths, with the JAX package as the reference it is tested against.  The
framework-free host code of that package (``data``, ``metrics`` and the
evaluator's writing and scoring) holds only numpy; the port keeps its own
copy of what it uses of it.  Nothing in this package imports ``jax`` or the
JAX package.

Ported so far: the serving path of the D-LSTM (directional grid pooling,
``LSTM`` autoregressive rollout, batched prediction, the TrajNet++ evaluator
CLI), with the fused D-LSTM step as a hand-written CUDA kernel
(``ops/cuda/fused_step.py``, ``csrc/fused_step.cu``), and its training path
(teacher forcing, ``losses``, Adam, the ``trainers.lstm`` CLI), whose steps
run the kernel's grid stage under autograd.
"""

__version__ = "0.1.0"
