"""The (data, model) layout of the ranks, its shardings and collectives.

Port of ``trajnetplusplusbaselines_tpu/parallel/mesh.py``.  JAX lays one
process's chips out as a ``Mesh``; here each rank of the process group is
one device, and ``make_mesh(n, dp, tp)`` lays the ranks out row-major as
JAX's ``create_device_mesh((dp, tp))`` lays devices: rank ``d * tp + m``
sits at data index ``d``, model index ``m``.  The ranks of one model index
form a ``data`` group, those of one data index a ``model`` group
(``torch.distributed.new_group``).

- Scenes shard over ``data``: each rank runs its ``scene_rows`` of a batch,
  and ``gather_scenes`` puts the outputs of every rank of its data group
  together, an all-gather whose backward keeps this rank's rows.  The loss
  is then the one-process loss of the whole batch on every rank, and the
  gradients of the rank's rows sum over ``data`` (``sum_over_data``) to the
  whole batch's.
- Parameters shard over ``model`` by ``param_sharding_rule``, JAX's rule:
  a 2-D leaf whose last axis divides by tp and is at least 4 tp is split in
  column blocks, every other leaf is replicated.  ``shard_params`` keeps
  this rank's block; ``gather_params`` rebuilds the full leaves for the
  forward, an all-gather over ``model`` whose backward keeps the block's
  columns, so a block's gradient is its slice of the full gradient.

With one process there is no mesh: the trainers take ``mesh=None`` and run
none of this.
"""

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .multihost import all_gather, all_reduce_sum, process_info


class Mesh:
    """This rank's place in a (dp, tp) layout of the process group, with
    its device and the groups of its data and model axes."""

    def __init__(self, dp: int, tp: int, device):
        rank, world = process_info()
        if dp < 1 or tp < 1 or dp * tp != world:
            raise ValueError(f"mesh {dp}x{tp} != {world} processes")
        self.shape = {"data": dp, "model": tp}
        self.rank = rank
        self.index = {"data": rank // tp, "model": rank % tp}
        self.device = torch.device(device)
        self.groups = {"data": None, "model": None}
        # every rank creates every group, in the same order
        if dp > 1:
            for m in range(tp):
                group = dist.new_group([d * tp + m for d in range(dp)])
                if m == self.index["model"]:
                    self.groups["data"] = group
        if tp > 1:
            for d in range(dp):
                group = dist.new_group([d * tp + m for m in range(tp)])
                if d == self.index["data"]:
                    self.groups["model"] = group

    # --------------------------------------------------------------- scenes
    def scene_rows(self, x, dim: int):
        """This rank's rows of ``x`` along its scene axis ``dim`` (None
        stays None); the axis divides over ``data``."""
        if x is None or self.shape["data"] == 1:
            return x
        n = x.shape[dim] // self.shape["data"]
        return x.narrow(dim, self.index["data"] * n, n)

    def gather_scenes(self, x, dim: int):
        """The rows of every rank of this rank's data group along ``dim``;
        autograd passes back only this rank's rows (None stays None)."""
        if x is None or self.shape["data"] == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.groups["data"], self.shape["data"],
                             self.index["data"])

    def sum_over_data(self, tensors):
        """Each tensor summed over the data group, in one collective."""
        tensors = list(tensors)
        if self.shape["data"] == 1 or not tensors:
            return tensors
        flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), self.groups["data"])
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                   tensors)]

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model group."""
        if self.shape["model"] == 1:
            return x
        return all_reduce_sum(x, self.groups["model"])

    def gather_columns(self, block: torch.Tensor, autograd: bool = True) -> torch.Tensor:
        """A model-split leaf rebuilt from the column blocks of its model
        group; with ``autograd``, the backward keeps this rank's columns."""
        if autograd:
            return _Gather.apply(block, block.dim() - 1, self.groups["model"],
                                 self.shape["model"], self.index["model"])
        return all_gather(block.detach(), block.dim() - 1, self.groups["model"],
                          self.shape["model"])


class _Gather(torch.autograd.Function):
    """All-gather of equal blocks along ``dim``; the gradient of a block is
    its own slice of the gradient of the whole (every rank computes the
    same function of the whole, so nothing is summed here)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        ctx.dim, ctx.start, ctx.length = dim, index * x.shape[dim], x.shape[dim]
        return all_gather(x.detach(), dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.length), None, None, None, None


class Sharding(NamedTuple):
    """How a global array lies on ``mesh``: split in equal blocks along
    ``dim`` over mesh axis ``axis`` (``"data"`` or ``"model"``), or whole on
    every rank (``axis`` None)."""

    mesh: Mesh
    dim: Optional[int] = None
    axis: Optional[str] = None

    @property
    def split(self) -> bool:
        return self.axis is not None and self.mesh.shape[self.axis] > 1


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
              device=None) -> Mesh:
    """A (data, model) mesh over the ranks of the process group; ``device``
    is this rank's (default: the current card, else the CPU)."""
    n = n_devices if n_devices is not None else process_info()[1]
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(dp, tp, device)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Scene axis (axis 1 of [T, S, A, ...]) over the data axis."""
    return Sharding(mesh, 1, "data")


def scene_sharding(mesh: Mesh) -> Sharding:
    """Leading scene axis (e.g. goals [S, A, 2]) over the data axis."""
    return Sharding(mesh, 0, "data")


def replicated(mesh: Mesh) -> Sharding:
    """The whole array on every rank."""
    return Sharding(mesh)


def param_sharding_rule(mesh: Mesh, path, leaf) -> Sharding:
    """Tensor-parallel layout, JAX's rule: a 2-D leaf (``[in, out]``) whose
    last axis divides by tp and is at least 4 tp is split in column blocks
    over ``model``; everything else is replicated."""
    del path  # classification is by shape alone, as in JAX
    tp = mesh.shape["model"]
    shape = tuple(getattr(leaf, "shape", ()))
    if tp > 1 and len(shape) == 2 and shape[-1] % tp == 0 and shape[-1] >= 4 * tp:
        return Sharding(mesh, 1, "model")
    return Sharding(mesh)


def local_block(sharding: Sharding, arr):
    """This rank's block of ``arr`` (numpy or torch) under ``sharding``:
    the array itself where it is replicated."""
    if not sharding.split:
        return arr
    mesh = sharding.mesh
    size = arr.shape[sharding.dim]
    parts = mesh.shape[sharding.axis]
    if size % parts:
        raise ValueError(f"axis {sharding.dim} of size {size} does not divide over "
                         f"{sharding.axis} {parts}")
    n = size // parts
    start = mesh.index[sharding.axis] * n
    if isinstance(arr, torch.Tensor):
        return arr.detach().narrow(sharding.dim, start, n).clone()
    return np.ascontiguousarray(np.take(arr, np.arange(start, start + n), axis=sharding.dim))


def tree_map_with_path(fn, tree, prefix=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, paths joined with
    "/" as the trainers name parameters (``encoder/w_ih``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn("/".join(map(str, prefix)), tree)


def param_shardings(mesh: Mesh, params) -> Dict[str, Sharding]:
    """``param_sharding_rule`` of every leaf of the full ``params``, by path."""
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(
        path, param_sharding_rule(mesh, path, leaf)), params)
    return out


def shard_params(mesh: Mesh, params):
    """``params`` with each leaf the rule splits cut to this rank's column
    block (numpy leaves stay numpy, tensors stay on their device)."""
    return tree_map_with_path(
        lambda path, leaf: local_block(param_sharding_rule(mesh, path, leaf), leaf), params)


def gather_params(mesh: Mesh, params, shardings: Dict[str, Sharding], autograd: bool = True):
    """The full params from this rank's blocks (``shardings`` of the full
    tree, ``param_shardings``); replicated leaves as they are."""
    return tree_map_with_path(
        lambda path, leaf: (mesh.gather_columns(leaf, autograd) if shardings[path].split
                            else leaf), params)
