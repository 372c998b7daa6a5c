"""Fused D-LSTM step: the CUDA kernel's wrappers and their plain versions.

Replaces the Pallas TPU kernel ``trajnetplusplusbaselines_tpu/ops/pallas/
fused_step.py:_kernel`` (launched by ``fused_dlstm_step``).  One launch
computes a whole goal-free D-LSTM step of a directional ``one_layer`` grid
model: the velocity and input embedding, the 12x12x2 directional grid,
``relu(grid @ W_grid + b)``, the LSTM cell, Hidden2Normal and the masked
state update.  The kernel is ``csrc/fused_step.cu``; what bounds it on the
card (L2 reads of the weights, f32 FMAs on CUDA cores, no tensor cores yet)
is written at its head.

Layout is scene-major ``[S, A, F]`` contiguous, as in ``models/lstm.py``.

- ``fused_dlstm_step`` / ``directional_grid`` take tensors on the card to the
  kernel, and tensors on the CPU to the plain version.  A tensor on the card
  launches the kernel or raises; there is no fallback.
- ``fused_dlstm_step_plain`` / ``directional_grid_plain`` are the plain
  PyTorch versions, built from the port's ops (``ops/core.py``,
  ``ops/embeddings.py``, ``ops/pooling/grid.py``).  ``lstm_step_plain`` is
  the step around the pool, shared with the models' other grid pools and
  with the pool-less LSTM.
- ``check_weights`` checks a weight dict against the kernel once; the
  wrapper takes the ``KernelWeights`` it returns without checking again.
- Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

import functools
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..core import lstm_pointwise, mlp
from ..embeddings import hidden2normal, input_embedding
from ..pooling.grid import GridBasedPooling

WEIGHT_NAMES = ("w_emb", "b_emb", "w_grid", "b_grid", "w_ih", "w_hh",
                "b_gates", "w_h2n", "b_h2n")


def weights_from_params(params: Dict, cell: str = "decoder") -> Dict:
    """The step's weight dict from LSTM params (encoder or decoder cell).
    A model without a pool has no ``w_grid`` / ``b_grid``."""
    weights = {
        "w_emb": params["input_embedding"]["linear"]["w"].contiguous(),
        "b_emb": params["input_embedding"]["linear"]["b"].contiguous(),
        "w_ih": params[cell]["w_ih"].contiguous(),
        "w_hh": params[cell]["w_hh"].contiguous(),
        "b_gates": (params[cell]["b_ih"] + params[cell]["b_hh"]).contiguous(),
        "w_h2n": params["hidden2normal"]["linear"]["w"].contiguous(),
        "b_h2n": params["hidden2normal"]["linear"]["b"].contiguous(),
    }
    if "pool" in params:
        weights["w_grid"] = params["pool"]["embedding"][0]["w"].contiguous()
        weights["b_grid"] = params["pool"]["embedding"][0]["b"].contiguous()
    return weights


# ------------------------------------------------------------ plain versions
def lstm_step_plain(weights: Mapping, obs1, obs2, present1, present2, h, c,
                    pooled: Optional[torch.Tensor] = None):
    """One LSTM step around a pooled input; returns (h' [S,A,H], c' [S,A,H],
    normal [S,A,5], mask [S,A] bool).

    The LSTM reads ``[input embedding of the masked velocity || pooled]``;
    h and c keep their old values, and the normal is zero, where the agent
    is not present at both t-1 and t."""
    w = weights
    mask = present1 & present2
    m = mask[..., None]
    inp = input_embedding({"linear": {"w": w["w_emb"], "b": w["b_emb"]}}, (obs2 - obs1) * m)
    if pooled is not None:
        inp = torch.cat([inp, pooled], dim=-1)
    gates = inp @ w["w_ih"] + h @ w["w_hh"] + w["b_gates"]
    h_new, c_new = lstm_pointwise(gates, c)
    normal = hidden2normal({"linear": {"w": w["w_h2n"], "b": w["b_h2n"]}}, h_new)
    return torch.where(m, h_new, h), torch.where(m, c_new, c), normal * m, mask


def directional_grid_plain(obs1, obs2, present1, present2, *, n=12, cell_side=0.6,
                           constant=0.0) -> torch.Tensor:
    """The flattened directional grid ``[S, A, 2*n*n]``, channel-major."""
    pool = GridBasedPooling(type_="directional", n=n, cell_side=cell_side, constant=constant)
    s, a = obs2.shape[:2]
    return pool.make_grid(obs1, obs2, present1, present2).reshape(s, a, -1)


def fused_dlstm_step_plain(obs1, obs2, present1, present2, h, c, weights: Mapping, *,
                           n=12, cell_side=0.6, constant=0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One D-LSTM step; returns (h' [S,A,H], c' [S,A,H], normal [S,A,5],
    mask [S,A] bool)."""
    grid = directional_grid_plain(obs1, obs2, present1, present2, n=n,
                                  cell_side=cell_side, constant=constant)
    pooled = mlp([{"w": weights["w_grid"], "b": weights["b_grid"]}], grid)
    return lstm_step_plain(weights, obs1, obs2, present1, present2, h, c, pooled)


# ------------------------------------------------------------------ wrappers
def _check_inputs(obs1, obs2, present1, present2, *state):
    """Raise on anything the kernel does not take."""
    s, a = obs2.shape[:2] if obs2.dim() == 3 else (0, 0)
    if s * a == 0:
        raise ValueError(f"positions must be [S, A, 2] with S, A >= 1, got {tuple(obs2.shape)}")
    device = obs2.device
    for name, x, shape, dtype in (
        ("obs1", obs1, (s, a, 2), torch.float32),
        ("obs2", obs2, (s, a, 2), torch.float32),
        ("present1", present1, (s, a), torch.bool),
        ("present2", present2, (s, a), torch.bool),
        *((f"state{i}", x, (s, a, x.shape[-1]), torch.float32) for i, x in enumerate(state)),
    ):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return s, a


@functools.lru_cache(maxsize=None)
def _kernel_shapes():
    """(n, hidden_dim, {weight name: shape}) the kernel was compiled for."""
    from . import build

    k_n, k_emb, k_pool, k_hidden = build.kernel_dims()
    return k_n, k_hidden, {
        "w_emb": (2, k_emb - 2), "b_emb": (k_emb - 2,),
        "w_grid": (2 * k_n * k_n, k_pool), "b_grid": (k_pool,),
        "w_ih": (k_emb + k_pool, 4 * k_hidden), "w_hh": (k_hidden, 4 * k_hidden),
        "b_gates": (4 * k_hidden,), "w_h2n": (k_hidden, 5), "b_h2n": (5,)}


def _check_n(n):
    k_n = _kernel_shapes()[0]
    if n != k_n:
        raise ValueError(f"the kernel is built for n={k_n}, got n={n}")


class KernelWeights(Mapping):
    """A weight dict checked against the kernel on ``device``, read-only."""

    __slots__ = ("_weights", "device")

    def __init__(self, weights: Dict[str, torch.Tensor], device: torch.device):
        self._weights = weights
        self.device = device

    def __getitem__(self, name):
        return self._weights[name]

    def __iter__(self):
        return iter(self._weights)

    def __len__(self):
        return len(self._weights)


def check_weights(weights: Mapping, device) -> KernelWeights:
    """Raise unless every weight is a contiguous float32 tensor on ``device``
    of the shape the kernel was compiled for."""
    device = torch.device(device)
    shapes = _kernel_shapes()[2]
    checked = {}
    for name in WEIGHT_NAMES:
        x = weights.get(name)
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"weight {name} is missing")
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"weight {name} must be contiguous float32 on {device}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"weight {name} must have shape {shapes[name]}, got {tuple(x.shape)}")
        checked[name] = x
    return KernelWeights(checked, device)


def directional_grid(obs1, obs2, present1, present2, *, n=12, cell_side=0.6,
                     constant=0.0) -> torch.Tensor:
    """The flattened directional grid ``[S, A, 2*n*n]``: the kernel's grid
    stage on the card, the plain version on the CPU."""
    if obs2.device.type == "cpu":
        return directional_grid_plain(obs1, obs2, present1, present2, n=n,
                                      cell_side=cell_side, constant=constant)
    if obs2.device.type != "cuda":
        raise ValueError(f"no kernel for device {obs2.device}")
    from . import build

    s, a = _check_inputs(obs1, obs2, present1, present2)
    _check_n(n)
    out = torch.empty((s, a, 2 * n * n), dtype=torch.float32, device=obs2.device)
    with torch.cuda.device(obs2.device):
        status = build.load_library().dlstm_directional_grid(
            obs1.data_ptr(), obs2.data_ptr(), present1.data_ptr(), present2.data_ptr(),
            out.data_ptr(), s, a, float(cell_side), float(constant),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "directional_grid")
    directional_grid.launches += 1
    return out


directional_grid.launches = 0


def fused_dlstm_step(obs1, obs2, present1, present2, h, c, weights: Mapping, *, n=12,
                     cell_side=0.6, constant=0.0):
    """One fused D-LSTM step; returns (h' [S,A,H], c' [S,A,H], normal
    [S,A,5], mask [S,A] bool).  The kernel on the card, the plain version on
    the CPU.  ``weights`` made by ``check_weights`` for this device are
    taken as they are; any other mapping is checked here."""
    if obs2.device.type == "cpu":
        return fused_dlstm_step_plain(obs1, obs2, present1, present2, h, c, weights,
                                      n=n, cell_side=cell_side, constant=constant)
    if obs2.device.type != "cuda":
        raise ValueError(f"no kernel for device {obs2.device}")
    from . import build

    s, a = _check_inputs(obs1, obs2, present1, present2, h, c)
    _check_n(n)
    hidden = _kernel_shapes()[1]
    if h.shape[-1] != hidden or c.shape[-1] != hidden:
        raise ValueError(f"the kernel is built for hidden_dim={hidden}, got {h.shape[-1]}")
    if not (isinstance(weights, KernelWeights) and weights.device == obs2.device):
        weights = check_weights(weights, obs2.device)

    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    normal = torch.empty((s, a, 5), dtype=torch.float32, device=obs2.device)
    mask = torch.empty((s, a), dtype=torch.bool, device=obs2.device)
    with torch.cuda.device(obs2.device):
        status = build.load_library().dlstm_fused_step(
            obs1.data_ptr(), obs2.data_ptr(), present1.data_ptr(), present2.data_ptr(),
            h.data_ptr(), c.data_ptr(),
            *(weights[name].data_ptr() for name in WEIGHT_NAMES),
            h_out.data_ptr(), c_out.data_ptr(), normal.data_ptr(), mask.data_ptr(),
            s, a, float(cell_side), float(constant),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "fused_dlstm_step")
    fused_dlstm_step.launches += 1
    return h_out, c_out, normal, mask


fused_dlstm_step.launches = 0
