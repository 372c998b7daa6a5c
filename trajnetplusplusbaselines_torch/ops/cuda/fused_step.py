"""Fused D-LSTM step: the CUDA kernel's wrappers and their plain versions.

Replaces the Pallas TPU kernel ``trajnetplusplusbaselines_tpu/ops/pallas/
fused_step.py:_kernel`` (launched by ``fused_dlstm_step``).  One launch
computes a whole goal-free D-LSTM step of a directional ``one_layer`` grid
model: the velocity and input embedding, the 12x12x2 directional grid,
``relu(grid @ W_grid + b)``, the LSTM cell, Hidden2Normal and the masked
state update.  The kernel is ``csrc/fused_step.cu``: its three products run
on the tensor cores (wgmma, TF32 split into high and low parts, f32
accuracy), a cluster of two blocks per 64-row tile, with the weights
streamed into shared memory.  The grid stage alone, ``directional_grid``, is
``csrc/directional_grid.cu``: scene rows staged in shared memory once, the
last write per cell found by a warp per row, the tile stored in 16-byte
stores.  Each source's head says what bounds it on the card.

Layout is scene-major ``[S, A, F]`` contiguous, as in ``models/lstm.py``.

- ``fused_dlstm_step`` / ``directional_grid`` take tensors on the card to the
  kernel, and tensors on the CPU to the plain version.  A tensor on the card
  launches the kernel or raises; there is no fallback.
- The fused step is compiled for the flagship's widths (``FUSED_DIMS``); the
  grid stage alone takes the grid's side at run time, up to ``GRID_MAX_N``,
  and the ``front`` offset.  ``models/lstm.py`` routes each configuration by
  these constants before any launch; the first launch checks them, and the
  packed weights' layout (``PACK_LAYOUT``), against the library.
- Neither kernel has a backward: the JAX package has no backward kernel to
  port, and the grid needs none (its positions are data or detached).  So
  ``fused_dlstm_step`` raises where autograd would record it
  (``autograd_records``), and ``directional_grid`` raises on positions that
  require grad.  Where autograd records, a D-LSTM step takes the model's
  grid route: the kernel's grid stage, then the grid embedding and
  ``lstm_step_plain`` under autograd.
- ``fused_dlstm_step_plain`` / ``directional_grid_plain`` are the plain
  PyTorch versions, built from the port's ops (``ops/core.py``,
  ``ops/embeddings.py``, ``ops/pooling/grid.py``).  ``lstm_step_plain`` is
  the step around the pool, shared with the models' other grid pools and
  with the pool-less LSTM.
- ``check_weights`` checks a weight dict against the kernel once and packs
  the three products' weights for it (``pack_weights``: transposed, split
  into TF32 high and low parts, gate columns reordered; cached on the
  source tensors' identity and version by ``packed_weights``); the wrapper
  takes the ``KernelWeights`` it returns without checking again.
- Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

import functools
from collections import OrderedDict
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..core import lstm_pointwise, mlp
from ..embeddings import hidden2normal, input_embedding
from ..pooling.grid import GridBasedPooling

WEIGHT_NAMES = ("w_emb", "b_emb", "w_grid", "b_grid", "w_ih", "w_hh",
                "b_gates", "w_h2n", "b_h2n")

# what csrc/fused_step.cu is compiled for: the fused step's grid side and
# widths, and the largest grid side of the grid stage alone
FUSED_DIMS = {"n": 12, "embedding_dim": 64, "pool_dim": 256, "hidden_dim": 128}
GRID_MAX_N = 32
# the layout of the fused step's packed weights: blocks per row tile (a
# cluster), warpgroups per block, and the K of one streamed chunk
PACK_LAYOUT = {"cluster": 2, "warpgroups": 2, "k_slice": 16}
PACK_CACHE_SIZE = 8  # packed weight sets kept by packed_weights


def lstm_weights(params: Dict, cell: str = "decoder") -> Dict:
    """``lstm_step_plain``'s weight dict from LSTM params (encoder or
    decoder cell)."""
    return {
        "w_emb": params["input_embedding"]["linear"]["w"].contiguous(),
        "b_emb": params["input_embedding"]["linear"]["b"].contiguous(),
        "w_ih": params[cell]["w_ih"].contiguous(),
        "w_hh": params[cell]["w_hh"].contiguous(),
        "b_gates": (params[cell]["b_ih"] + params[cell]["b_hh"]).contiguous(),
        "w_h2n": params["hidden2normal"]["linear"]["w"].contiguous(),
        "b_h2n": params["hidden2normal"]["linear"]["b"].contiguous(),
    }


def weights_from_params(params: Dict, cell: str = "decoder") -> Dict:
    """The fused step's weight dict from LSTM params (encoder or decoder
    cell): ``lstm_weights`` and the first layer of the grid embedding as
    ``w_grid`` / ``b_grid``.  A model without a pool has no ``w_grid`` /
    ``b_grid``."""
    weights = lstm_weights(params, cell)
    if "pool" in params:
        weights["w_grid"] = params["pool"]["embedding"][0]["w"].contiguous()
        weights["b_grid"] = params["pool"]["embedding"][0]["b"].contiguous()
    return weights


def autograd_records(*tensors) -> bool:
    """True when autograd would record an op on ``tensors``: grad mode is on
    and one of them requires grad.  The model's one switch between the fused
    step and its grid route."""
    return torch.is_grad_enabled() and any(getattr(t, "requires_grad", False) for t in tensors)


# ------------------------------------------------------------ plain versions
def lstm_step_plain(weights: Mapping, obs1, obs2, present1, present2, h, c,
                    *inputs: torch.Tensor, h_in: Optional[torch.Tensor] = None):
    """One LSTM step; returns (h' [S,A,H], c' [S,A,H], normal [S,A,5],
    mask [S,A] bool).

    The LSTM reads ``[input embedding of the masked velocity || *inputs]``
    (a goal embedding, a pooled input) and the recurrent state ``h_in``, by
    default ``h``; h and c keep their old values, and the normal is zero,
    where the agent is not present at both t-1 and t."""
    w = weights
    mask = present1 & present2
    m = mask[..., None]
    inp = input_embedding({"linear": {"w": w["w_emb"], "b": w["b_emb"]}}, (obs2 - obs1) * m)
    if inputs:
        inp = torch.cat([inp, *inputs], dim=-1)
    gates = inp @ w["w_ih"] + (h if h_in is None else h_in) @ w["w_hh"] + w["b_gates"]
    h_new, c_new = lstm_pointwise(gates, c)
    normal = hidden2normal({"linear": {"w": w["w_h2n"], "b": w["b_h2n"]}}, h_new)
    return torch.where(m, h_new, h), torch.where(m, c_new, c), normal * m, mask


def directional_grid_plain(obs1, obs2, present1, present2, *, n=12, cell_side=0.6,
                           constant=0.0, front=False) -> torch.Tensor:
    """The flattened directional grid ``[S, A, 2*n*n]``, channel-major."""
    pool = GridBasedPooling(type_="directional", n=n, cell_side=cell_side, constant=constant,
                            front=front)
    s, a = obs2.shape[:2]
    return pool.make_grid(obs1, obs2, present1, present2).reshape(s, a, -1)


def fused_dlstm_step_plain(obs1, obs2, present1, present2, h, c, weights: Mapping, *,
                           n=12, cell_side=0.6, constant=0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One D-LSTM step: the plain directional grid, ``relu(grid @ W_grid +
    b)`` and ``lstm_step_plain``; returns (h' [S,A,H], c' [S,A,H], normal
    [S,A,5], mask [S,A] bool)."""
    grid = directional_grid_plain(obs1, obs2, present1, present2, n=n, cell_side=cell_side,
                                  constant=constant)
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
def _library_dims():
    """The library's ``dlstm_kernel_dims``; raises unless they are the
    widths this module routes by (``FUSED_DIMS``, ``GRID_MAX_N``) and the
    layout it packs for (``PACK_LAYOUT``)."""
    from . import build

    dims = build.kernel_dims()
    want = (*FUSED_DIMS.values(), GRID_MAX_N, *PACK_LAYOUT.values())
    if dims != want:
        raise RuntimeError(f"the kernel library reports dims {dims}, the wrapper expects {want}")
    return dims


def _kernel_shapes():
    """(n, hidden_dim, {weight name: shape}) the fused step was compiled for."""
    k_n, k_emb, k_pool, k_hidden = _library_dims()[:4]
    return k_n, k_hidden, {
        "w_emb": (2, k_emb - 2), "b_emb": (k_emb - 2,),
        "w_grid": (2 * k_n * k_n, k_pool), "b_grid": (k_pool,),
        "w_ih": (k_emb + k_pool, 4 * k_hidden), "w_hh": (k_hidden, 4 * k_hidden),
        "b_gates": (4 * k_hidden,), "w_h2n": (k_hidden, 5), "b_h2n": (5,)}


def _check_n(n):
    k_n = _kernel_shapes()[0]
    if n != k_n:
        raise ValueError(f"the kernel is built for n={k_n}, got n={n}")


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x``: hi is x rounded to TF32 (10 mantissa bits,
    to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), lo = x - hi,
    exact in f32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


@functools.lru_cache(maxsize=None)
def gate_order(hidden: int, parts: int, device=None) -> torch.Tensor:
    """The gate columns (gate-major i, f, g, o of ``hidden`` units) in the
    kernel's order: ``parts`` warpgroups of ``4 * hidden / parts`` columns,
    and within one, column 16p + 8e + 2q + b is gate 2e + b of its unit
    4p + q, so that a thread's wgmma accumulators hold all four gates of its
    units."""
    units = hidden // parts
    j = torch.arange(4 * units, device=device)
    p, e, q, b = j // 16, (j // 8) % 2, (j // 2) % 4, j % 2
    unit = torch.arange(parts, device=device)[:, None] * units + (4 * p + q)[None]
    return ((2 * e + b)[None] * hidden + unit).reshape(-1)


def _core_matrices(w: torch.Tensor, k_slice: int) -> torch.Tensor:
    """[P, N, K] -> [P, K / k_slice, N / 8, k_slice / 4, 8, 4]: per K slice,
    wgmma's K-major core matrices (8 rows of 4 values), 8-row groups
    outermost."""
    p, n, k = w.shape
    return w.reshape(p, n // 8, 8, k // k_slice, k_slice // 4, 4).permute(0, 3, 1, 4, 2, 5)


def pack_weights(w_grid: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, *,
                 cluster: int, warpgroups: int, k_slice: int) -> torch.Tensor:
    """The fused kernel's weight streams, flat: for each of the
    ``cluster * warpgroups`` warpgroups of a row tile, its grid-embedding
    columns (``w_grid`` [288, 256] cut in as many parts) then its gate
    columns (``[w_ih; w_hh]`` [448, 512] in ``gate_order``), each as
    chunks of ``k_slice`` K: the TF32 high part, then the low part
    (``split_tf32``), as wgmma's K-major core matrices.  The plain
    function behind ``packed_weights``, for any device."""
    parts = cluster * warpgroups
    hidden = w_hh.shape[0]
    grid_t = w_grid.t().reshape(parts, w_grid.shape[1] // parts, w_grid.shape[0])
    gates = torch.cat([w_ih, w_hh])[:, gate_order(hidden, parts, w_ih.device)]
    gates_t = gates.t().reshape(parts, 4 * hidden // parts, gates.shape[0])
    streams = []
    for w in (grid_t, gates_t):
        hi, lo = split_tf32(w)
        tiles = torch.stack([_core_matrices(hi, k_slice), _core_matrices(lo, k_slice)], dim=2)
        streams.append(tiles.reshape(parts, -1))
    return torch.cat(streams, dim=1).reshape(-1)


_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()


def packed_weights(w_grid: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """``pack_weights`` in ``PACK_LAYOUT``, cached on the source tensors'
    identity and version: an in-place update (an optimizer step) packs
    again.  The last ``PACK_CACHE_SIZE`` packings are kept, each with its
    sources, so that an id is not reused while its entry lives."""
    sources = (w_grid, w_ih, w_hh)
    key = tuple((id(t), t._version) for t in sources)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[1]
    packed = pack_weights(*sources, **PACK_LAYOUT)
    _PACKED[key] = (sources, packed)
    if len(_PACKED) > PACK_CACHE_SIZE:
        _PACKED.popitem(last=False)
    return packed


class KernelWeights(Mapping):
    """A weight dict checked against the kernel on ``device``, read-only,
    and ``packed``: its three products' weights as the kernel reads them."""

    __slots__ = ("_weights", "device", "packed")

    def __init__(self, weights: Dict[str, torch.Tensor], device: torch.device,
                 packed: torch.Tensor):
        self._weights = weights
        self.device = device
        self.packed = packed

    def __getitem__(self, name):
        return self._weights[name]

    def __iter__(self):
        return iter(self._weights)

    def __len__(self):
        return len(self._weights)


def check_weights(weights: Mapping, device) -> KernelWeights:
    """Raise unless every weight is a contiguous float32 tensor on ``device``
    of the shape the kernel was compiled for; pack them for the kernel
    (``packed_weights``)."""
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
    return KernelWeights(checked, device,
                         packed_weights(checked["w_grid"], checked["w_ih"], checked["w_hh"]))


def directional_grid(obs1, obs2, present1, present2, *, n=12, cell_side=0.6,
                     constant=0.0, front=False) -> torch.Tensor:
    """The flattened directional grid ``[S, A, 2*n*n]`` of side ``n`` (1 to
    ``GRID_MAX_N``), with the agent at the grid's centre or, with ``front``,
    on its edge: the kernel's grid stage on the card, the plain version on
    the CPU.  It has no gradient, so positions that require grad raise."""
    if obs1.requires_grad or obs2.requires_grad:
        raise ValueError("directional_grid has no gradient: pass detached positions")
    if obs2.device.type == "cpu":
        return directional_grid_plain(obs1, obs2, present1, present2, n=n,
                                      cell_side=cell_side, constant=constant, front=front)
    if obs2.device.type != "cuda":
        raise ValueError(f"no kernel for device {obs2.device}")
    from . import build

    s, a = _check_inputs(obs1, obs2, present1, present2)
    grid_max_n = _library_dims()[4]
    if not 1 <= n <= grid_max_n:
        raise ValueError(f"the grid stage takes 1 <= n <= {grid_max_n}, got n={n}")
    out = torch.empty((s, a, 2 * n * n), dtype=torch.float32, device=obs2.device)
    with torch.cuda.device(obs2.device):
        status = build.load_library().dlstm_directional_grid(
            obs1.data_ptr(), obs2.data_ptr(), present1.data_ptr(), present2.data_ptr(),
            out.data_ptr(), s, a, n, float(cell_side), int(front), float(constant),
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
    taken as they are; any other mapping is checked here.  The step has no
    backward, so it raises where autograd would record it."""
    if autograd_records(obs1, obs2, h, c, *weights.values()):
        raise RuntimeError("fused_dlstm_step has no backward: run it under torch.no_grad(), "
                           "or take the model's grid route where autograd records")
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
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned: the kernel reads it in 16-byte loads")
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
            weights["w_emb"].data_ptr(), weights["b_emb"].data_ptr(), weights.packed.data_ptr(),
            weights["b_grid"].data_ptr(), weights["b_gates"].data_ptr(),
            weights["w_h2n"].data_ptr(), weights["b_h2n"].data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), normal.data_ptr(), mask.data_ptr(),
            s, a, float(cell_side), float(constant),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "fused_dlstm_step")
    fused_dlstm_step.launches += 1
    return h_out, c_out, normal, mask


fused_dlstm_step.launches = 0
