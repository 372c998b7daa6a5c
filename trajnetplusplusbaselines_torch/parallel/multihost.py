"""Multi-process placement and collectives over ``torch.distributed``.

Port of ``trajnetplusplusbaselines_tpu/parallel/multihost.py``.  A JAX
process addresses several chips; here one process drives one device, so a
multi-device run is one process per rank, launched by
``python -m torch.distributed.run`` (``init_from_env``):

- ``process_info()``: (rank, world size); with no process group, or a group
  of one process, ``(0, 1)``, so a single process pays nothing;
- ``process_slice(n)`` / ``shard_items(items)``: this rank's contiguous share
  of n work items, the first ``n % p`` ranks taking one more (the JAX
  partition);
- ``all_processes_agree(x)`` (every rank passed the same array) and
  ``broadcast_from_zero(value)``: object collectives, for host decisions that
  must be the same on every rank;
- ``put_global(sharding, arr)``: this rank's block of a global host array
  (``parallel.mesh.Sharding``), on this rank's device; ``put_global_tree``
  over a tree;
- ``all_gather`` / ``all_reduce_sum`` / ``barrier``: the tensor collectives
  of the mesh and the evaluator.  Gloo has no CUDA path for every
  collective, so where ranks share a card (gloo) a CUDA tensor goes through
  the host explicitly (``collective_route`` reports ``"gloo-host"``).
"""

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 300  # every collective of a rank that waits longer raises


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group
    of more than one process."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_from_env(device="cuda", timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group ``torch.distributed.run`` describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) and
    return this rank's device.

    A process launched alone (no ``WORLD_SIZE``, or 1) starts no group and
    gets ``device`` back as it is.  Under the launcher, ``cuda`` becomes
    ``cuda:(LOCAL_RANK % device_count)``; the backend is NCCL where each
    local rank has a card of its own and gloo where ranks share one (NCCL
    refuses two ranks on one card), gloo for ``cpu``.  A rank asked for a
    card where there is none raises.  Joining twice returns the device."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device
    backend = "gloo"
    if device.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(f"--device {device} asked for, but CUDA is not available")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % count)
        torch.cuda.set_device(device)
        if int(os.environ.get("LOCAL_WORLD_SIZE", str(world))) <= count:
            backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def collective_route(device, group=None) -> Optional[str]:
    """How the tensor collectives of ``group`` run for tensors on
    ``device``: ``"nccl"``, ``"gloo"`` (host tensors) or ``"gloo-host"``
    (CUDA tensors copied through the host); None without a process group."""
    if process_info()[1] == 1:
        return None
    backend = dist.get_backend(group)
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo-host"
    return backend


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, dim: int, group=None, size: Optional[int] = None) -> torch.Tensor:
    """The blocks ``t`` of every rank of ``group`` (``size`` of them, all
    of one shape), concatenated along ``dim`` in rank order."""
    size = dist.get_world_size(group) if size is None else size
    src = t.contiguous()
    host = _through_host(src, group)
    if host:
        src = src.cpu()
    as_bool = src.dtype == torch.bool  # not every backend reduces or gathers bools
    if as_bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    if as_bool:
        out = out.bool()
    return out.to(t.device) if host else out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, as a new tensor."""
    src = t.detach().clone().contiguous()
    host = _through_host(src, group)
    if host:
        src = src.cpu()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
    return src.to(t.device) if host else src


def barrier() -> None:
    """Wait for every rank; nothing in a single process."""
    if process_info()[1] > 1:
        dist.barrier()


def put_global(sharding, arr) -> torch.Tensor:
    """This rank's block of the global array ``arr`` (host or device)
    under ``sharding`` (``parallel.mesh.Sharding``), on the mesh's device.
    Every rank passes the same global value."""
    from .mesh import local_block

    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    return torch.as_tensor(local_block(sharding, arr), device=sharding.mesh.device)


def put_global_tree(sharding_fn, tree):
    """``put_global`` over a tree of dicts and lists; sharding_fn(leaf) ->
    ``Sharding``."""
    if isinstance(tree, dict):
        return {k: put_global_tree(sharding_fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(put_global_tree(sharding_fn, v) for v in tree)
    return put_global(sharding_fn(tree), tree)


def process_slice(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> slice:
    """This process's contiguous share of ``n`` items (balanced, deterministic).

    The first ``n % p`` processes take one extra item, so sizes differ by at
    most one and every item is covered exactly once.
    """
    if process_index is None or process_count is None:
        pi, pc = process_info()
        process_index = pi if process_index is None else process_index
        process_count = pc if process_count is None else process_count
    base, extra = divmod(n, process_count)
    start = process_index * base + min(process_index, extra)
    stop = start + base + (1 if process_index < extra else 0)
    return slice(start, stop)


def shard_items(items: Sequence, process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> Sequence:
    """The subsequence of ``items`` this process owns (see process_slice)."""
    return items[process_slice(len(items), process_index, process_count)]


def all_processes_agree(x) -> bool:
    """True iff every process passed an identical array or scalar (dtype,
    shape and bytes); True in a single process without a collective."""
    if process_info()[1] == 1:
        return True
    x = np.ascontiguousarray(x)
    mine = (x.dtype.str, x.shape, x.tobytes())
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    return all(g == gathered[0] for g in gathered)


def broadcast_from_zero(value):
    """Process 0's host value on every process (a single process: the
    value).  For decisions taken from the filesystem, which must be the same
    on every rank lest the collectives that follow diverge."""
    if process_info()[1] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]
