"""Shared trainer infrastructure: scenes, the device-resident epoch, logging,
Adam and the StepLR schedule.

Port of the host parts of ``trajnetplusplusbaselines_tpu/trainers/common.py``
(that module imports optax, so it is reimplemented here, not imported):

- ``SceneDataset``: scenes as NaN-padded arrays and their goals,
  ``drop_distant``-filtered once at load;
- ``ResidentDataset``: per (T, A-bucket) tensors on the device, goals
  included, with the JAX package's ``epoch_plan``: the same bucket order and
  the same ``rng.permutation`` calls, so an epoch visits the same batches;
- ``bucket_batches``: the epoch runner's loop over one bucket's plan as a
  Python loop, with rotation (of the scenes and their goals) and
  neighbour-noise augmentation drawn on the device from a
  ``torch.Generator``, yielding each batch's goals and slot mask;
- ``EpochLoop``: what every trainer's epochs share (resident datasets,
  their batches, the epoch loop with checkpoints, the train log records);
- ``SceneDataset.epoch_batches`` / ``group_batches`` / ``packed_batch``:
  the chunked host path of ``--obs_dropout``, batches packed on the host
  with rotation and noise drawn from the trainer's numpy generator in the
  JAX package's order of draws (the permutation, then per scene its
  rotation and its noise), then grouped by shape as JAX groups them;
- ``make_optimizer`` / ``clip_by_global_norm`` / ``set_lr``: optax's
  ``clip_by_global_norm -> add_decayed_weights -> scale_by_adam ->
  scale_by_learning_rate`` as a global-norm clip written to optax's formula
  (per member for the ensemble's stacked leaves) followed by
  ``torch.optim.Adam`` with coupled weight decay;
- ``cast_compute`` / ``outputs_f32`` / ``f32_model``: mixed precision as
  the JAX package's ``--bf16`` runs it, f32 masters and optimizer state,
  the forward and backward in the model's compute dtype, losses in f32, and
  predictor pickles saved with compute dtype None;
- ``step_lr`` and the JSON logging that ``tools/plot_log.read_log`` reads;
- the mesh helpers (``parallel/mesh.py``): ``validate_mesh_batch``,
  ``place_plan_on_mesh`` (every rank's epoch plan, held to rank 0's by an
  order-sensitive digest), ``replicate_on_mesh``, ``shard_carry_on_mesh``,
  and ``EpochLoop``'s part of them: each rank runs its scene rows of every
  batch, gathers the outputs, scores the whole batch and sums its gradients
  over ``data``; under tensor parallelism it holds its column blocks of the
  split leaves and their Adam moments, rebuilds the full leaves for the
  forward, clips by the norm over the model group, and checkpoints the full
  leaves from rank 0.  The resident datasets need no placing: every rank
  holds them whole on its device, as JAX's ``ResidentDataset.place``
  replicates them, and draws the same augmentation for them.

The lax-scan chunking (``chunk_sizes_for`` splits a group into scan chunks,
which changes nothing when one step is applied per batch in order) and the
compile cache exist only for the TPU toolchain and are not ported.
"""

import copy
import hashlib
import json
import logging
import socket
import sys
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..data import Reader, augmentation, batching
from ..parallel.mesh import gather_params, local_block, param_shardings, shard_params
from ..parallel.multihost import all_processes_agree

NOISE_THRESH = 0.02  # --augment_noise: uniform noise bound in metres


class SceneDataset:
    """Preprocessed scenes held as arrays ``[T, n, 2]``, NaN where absent,
    and their goals ``[n, 2]``: from ``goals_dict`` (``prepare_data``'s,
    by file and scene id), else zeros.  Goals are filtered and centred with
    their scene."""

    def __init__(self, scenes, obs_length: int, normalize_scene: bool, goals_dict=None):
        self.xys: List[np.ndarray] = []
        self.goals: List[np.ndarray] = []
        for filename, scene_id, paths in scenes:
            xy = Reader.paths_to_xy(paths)
            goal = (np.array(goals_dict[filename][scene_id]) if goals_dict is not None
                    else np.zeros((xy.shape[1], 2)))
            xy, keep = augmentation.drop_distant(xy)
            goal = goal[keep]
            if normalize_scene:
                xy, _, _, goal = augmentation.center_scene(xy, obs_length, goals=goal)
            self.xys.append(xy.astype(np.float64))
            self.goals.append(goal.astype(np.float64))

    def __len__(self):
        return len(self.xys)

    def epoch_batches(self, batch_size: int, rng: np.random.Generator, augment: bool = False,
                      augment_noise: bool = False,
                      shuffle: bool = True) -> Iterator[batching.PackedScenes]:
        """Yield each batch of an epoch packed on the host
        (``batching.pack_scenes``, padded to ``batch_size`` scenes), in the
        order of ``rng.permutation``, each scene and its goals rotated
        (``augment``) and its neighbours' observed frames noised
        (``augment_noise``, +-``NOISE_THRESH``), drawn from ``rng`` as it is
        consumed, in the JAX package's order."""
        order = rng.permutation(len(self.xys)) if shuffle else np.arange(len(self.xys))
        for start in range(0, len(order), batch_size):
            xs, gs = [], []
            for i in order[start:start + batch_size]:
                xy, goal = self.xys[i], self.goals[i]
                if augment:
                    xy, goal = augmentation.random_rotation(xy, goals=goal, rng=rng)
                if augment_noise:
                    xy = augmentation.add_noise(xy.copy(), thresh=NOISE_THRESH, ped="neigh",
                                                rng=rng)
                xs.append(xy)
                gs.append(goal)
            yield batching.pack_scenes(xs, gs, pad_scenes_to=batch_size)


def group_batches(items, key_fn) -> Dict:
    """Items grouped by ``key_fn`` (a batch's shape), groups in the order of
    their first item, items in their order: the JAX package's visit order of
    the chunked host path."""
    groups: Dict = {}
    for item in items:
        groups.setdefault(key_fn(item), []).append(item)
    return groups


class ResidentDataset:
    """Scenes resident on ``device``, one dense tensor set per (T, A-bucket):
    ``xs [N, T, A, 2]`` float32, ``mask [N, T, A]`` bool, ``goals [N, A, 2]``
    float32, ``num_agents [N]``.  Per epoch the host makes only the shuffled
    batch plan."""

    def __init__(self, dataset: SceneDataset, device,
                 buckets: Sequence[int] = batching.DEFAULT_AGENT_BUCKETS):
        by_key = {}
        for i, xy in enumerate(dataset.xys):
            t, n = xy.shape[0], xy.shape[1]
            a = max(batching.agent_bucket(n, buckets), n)
            by_key.setdefault((t, a), []).append(i)

        self.buckets = {}
        for (t, a), ids in sorted(by_key.items()):
            xs = np.zeros((len(ids), t, a, 2), dtype=np.float32)
            mask = np.zeros((len(ids), t, a), dtype=bool)
            goals = np.zeros((len(ids), a, 2), dtype=np.float32)
            num_agents = np.zeros((len(ids),), dtype=np.int64)
            for j, i in enumerate(ids):
                xy = dataset.xys[i]
                n = xy.shape[1]
                xs[j, :, :n], mask[j, :, :n] = batching.nan_to_mask(xy)
                goals[j, :n] = dataset.goals[i]
                num_agents[j] = n
            self.buckets[(t, a)] = {
                "xs": torch.from_numpy(xs).to(device),
                "mask": torch.from_numpy(mask).to(device),
                "goals": torch.from_numpy(goals).to(device),
                "num_agents": torch.from_numpy(num_agents).to(device),
            }

    def epoch_plan(self, batch_size: int, rng: np.random.Generator,
                   shuffle: bool = True) -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]:
        """Per bucket: (idx [nb, S] int64, valid [nb, S] bool).  The last
        batch of a bucket is padded with scene 0, switched off in ``valid``."""
        plan = {}
        for key, data in self.buckets.items():
            n = int(data["num_agents"].shape[0])
            order = rng.permutation(n) if shuffle else np.arange(n)
            nb = -(-n // batch_size)
            idx = np.zeros((nb * batch_size,), dtype=np.int64)
            idx[:n] = order
            valid = np.arange(nb * batch_size) < n
            plan[key] = (idx.reshape(nb, batch_size), valid.reshape(nb, batch_size))
        return plan


def rotate(xy: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """xy [..., 2] rotated by theta (``augmentation.theta_rotation``)."""
    ct, st = torch.cos(theta), torch.sin(theta)
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([x * ct - y * st, x * st + y * ct], dim=-1)


class Batch(NamedTuple):
    """One training batch, in the order ``Trainer.train_step`` takes it."""

    xy: torch.Tensor  # [T, S, A, 2]
    mask: torch.Tensor  # [T, S, A] bool
    scene_mask: torch.Tensor  # [S] bool: the scene is real
    goals: torch.Tensor  # [S, A, 2]
    slot_mask: torch.Tensor  # [S, A] bool: the slot is a real track of a real scene


def bucket_batches(data: Dict[str, torch.Tensor], idx: np.ndarray, valid: np.ndarray, *,
                   augment: bool = False, augment_noise: bool = False, obs_length: int = 9,
                   generator: Optional[torch.Generator] = None) -> Iterator[Batch]:
    """Yield a ``Batch`` for each batch of one bucket's plan, on the bucket's
    device.

    Augmentation is drawn once for the whole bucket, as in the JAX epoch
    runner: a uniform rotation of every scene and its goals and, with
    ``augment_noise``, uniform noise in +-``NOISE_THRESH`` on the
    neighbours' observed frames.  Padded scenes keep scene 0's positions and
    goals with every mask off, their slots included."""
    xs, mask, goals, num_agents = data["xs"], data["mask"], data["goals"], data["num_agents"]
    device = xs.device
    if augment:
        theta = torch.rand(xs.shape[0], generator=generator, device=device,
                           dtype=xs.dtype) * (2.0 * np.pi)
        xs = rotate(xs, theta[:, None, None])
        goals = rotate(goals, theta[:, None])
    if augment_noise:
        noise = torch.rand(xs[:, :obs_length, 1:].shape, generator=generator, device=device,
                           dtype=xs.dtype) * (2.0 * NOISE_THRESH) - NOISE_THRESH
        xs = xs.clone()
        xs[:, :obs_length, 1:] += noise
    slot_all = torch.arange(xs.shape[2], device=device)[None] < num_agents[:, None]  # [N, A]
    idx = torch.from_numpy(idx).to(device)
    valid = torch.from_numpy(valid).to(device)
    for i, v in zip(idx, valid):
        xy = xs[i].transpose(0, 1).contiguous()
        m = mask[i].transpose(0, 1) & v[None, :, None]
        yield Batch(xy, m.contiguous(), (num_agents[i] > 0) & v, goals[i].contiguous(),
                    slot_all[i] & v[:, None])


def packed_batch(packed: batching.PackedScenes, device) -> Batch:
    """A host-packed batch (``SceneDataset.epoch_batches``) as a ``Batch`` on
    ``device``: padded scenes have no real slot and are switched off."""
    slot = np.arange(packed.xy.shape[2])[None] < packed.num_agents[:, None]
    return Batch(*(torch.from_numpy(x).to(device) for x in (
        packed.xy, packed.mask, packed.num_agents > 0, packed.goals, slot)))


class EpochLoop:
    """What the trainers' epochs share: each dataset made resident on the
    trainer's ``device`` once, its batches (augmented from ``generator``),
    the epoch loop with its checkpoints, the train log records, and the
    trainer's part of a mesh (``attach_mesh``).  A trainer sets ``device``,
    ``generator``, ``batch_size``, ``obs_length``, ``save_every``,
    ``val_flag``, ``log`` and ``_resident = {}``, and has ``train``,
    ``val`` and ``save_checkpoint``."""

    mesh = None  # one process
    shardings: Dict = {}

    # ------------------------------------------------------------------ mesh
    def attach_mesh(self, mesh, params, batch_size: int):
        """Train on ``mesh`` (None: one process); returns this rank's blocks
        of the full ``params``."""
        self.mesh = mesh
        if mesh is None:
            return params
        validate_mesh_batch(mesh, batch_size)
        self.shardings = param_shardings(mesh, params)
        return shard_carry_on_mesh(mesh, params)

    @property
    def writes(self) -> bool:
        """Whether this rank writes checkpoints (rank 0, or one process)."""
        return self.mesh is None or self.mesh.rank == 0

    def _rows(self, x, dim: int):
        """This rank's scene rows of ``x`` along ``dim``."""
        return x if self.mesh is None else self.mesh.scene_rows(x, dim)

    def _gather(self, x, dim: int):
        """Every rank's scene rows of ``x`` along ``dim``, autograd keeping
        this rank's."""
        return x if self.mesh is None else self.mesh.gather_scenes(x, dim)

    def _full(self, params, autograd: bool = True):
        """The full params from this rank's blocks (``shardings`` paths
        from the root of ``self.params``)."""
        if self.mesh is None or self.mesh.shape["model"] == 1:
            return params
        return gather_params(self.mesh, params, self.shardings, autograd)

    def _summed(self, grads):
        """The rank's gradients summed over ``data``: the whole batch's."""
        return list(grads) if self.mesh is None else self.mesh.sum_over_data(grads)

    def _split(self, paths, prefix: str = ""):
        """Per path, whether the leaf is split over ``model``."""
        return [self.shardings[prefix + p].split if self.shardings else False for p in paths]

    def _full_adam_state(self, optimizer, paths, prefix: str = "") -> Dict:
        """``adam_state_to_numpy`` with the split leaves' moments gathered
        over ``model``: the one-process state."""
        split = dict(zip(paths, self._split(paths, prefix)))
        return adam_state_to_numpy(optimizer, paths, gather=lambda path, x: (
            self.mesh.gather_columns(x, autograd=False) if split[path] else x))

    def _block(self, prefix: str = ""):
        """fn(path, array): this rank's block of a full array of leaf
        ``path`` (``restore_optimizer``'s ``block``)."""
        if not self.shardings:
            return None
        return lambda path, arr: local_block(self.shardings[prefix + path], arr)

    def _get_resident(self, scenes):
        # keyed by id, with a strong reference so a freed object's reused
        # address never aliases a stale entry
        if id(scenes) not in self._resident:
            self._resident[id(scenes)] = (scenes, ResidentDataset(scenes, self.device))
        return self._resident[id(scenes)][1]

    def _batches(self, resident, plan, augment=False, augment_noise=False):
        for key, (idx, valid) in plan.items():
            idx, valid = place_plan_on_mesh(self.mesh, idx, valid)
            yield from bucket_batches(resident.buckets[key], idx, valid, augment=augment,
                                      augment_noise=augment_noise,
                                      obs_length=self.obs_length, generator=self.generator)

    def loop(self, train_scenes: SceneDataset, val_scenes, out: str, epochs=25,
             start_epoch=0):
        for epoch in range(start_epoch, epochs):
            if epoch % self.save_every == 0:
                self.save_checkpoint(epoch, out + f".epoch{epoch}")
            self.train(train_scenes, epoch)
            if self.val_flag and val_scenes is not None:
                self.val(val_scenes, epoch)
        self.save_checkpoint(epochs, out + f".epoch{epochs}")
        self.save_checkpoint(epochs, out)

    def log_train(self, scenes: SceneDataset, epoch: int, losses: np.ndarray,
                  start_time: float, lr: float, **per_batch) -> None:
        """The epoch's "train" records, one per 10 batches, and its
        "train-epoch" record; ``per_batch`` fields go into each "train"."""
        n_batches = len(losses)
        per_batch_time = (time.time() - start_time) / max(n_batches, 1)
        for b in range(10, n_batches + 1, 10):
            self.log.info({
                "type": "train",
                "epoch": epoch, "batch": b * self.batch_size,
                "n_batches": len(scenes),
                "time": round(per_batch_time, 4),
                **per_batch,
                "lr": lr,
                "loss": round(float(losses[b - 1]), 3),
            })
        self.log.info({
            "type": "train-epoch",
            "epoch": epoch + 1,
            "loss": round(float(losses.sum()) / max(len(scenes), 1), 5),
            "time": round(time.time() - start_time, 1),
        })


# ------------------------------------------------------------------ optimizer
def param_items(tree, prefix: Tuple = ()) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of a nested params dict, in a fixed order; paths join
    keys and list indices with "/" (``encoder/w_ih``, ``pool/embedding/0/w``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in param_items(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in param_items(v, prefix + (i,))]
    return [("/".join(map(str, prefix)), tree)]


def make_optimizer(leaves: Sequence[torch.Tensor], lr: float = 1e-3,
                   weight_decay: float = 1e-4) -> torch.optim.Adam:
    """Adam with coupled weight decay (``grad + wd * p``), as optax's
    ``add_decayed_weights -> scale_by_adam``; the learning rate is set per
    epoch with ``set_lr``."""
    return torch.optim.Adam(list(leaves), lr=lr, weight_decay=weight_decay)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        members: bool = False, split: Optional[Sequence[bool]] = None,
                        mesh=None) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: every gradient becomes
    ``(g / norm) * max_norm`` where the global norm is at least ``max_norm``.
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead.)
    With ``members``, the leaves are stacked ``[E, ...]`` and each member
    has its own norm, as if clipped alone.  Decided on the device, with no
    host sync.  Returns new tensors: autograd may hand one tensor to two
    leaves (``b_ih`` and ``b_hh`` reach the loss through their sum), so
    scaling in place would scale it twice.  Under tensor parallelism
    (``split`` flags the leaves this rank holds a column block of, ``mesh``
    their model group) the split leaves' squares are summed over the model
    group, each once, and the replicated leaves' counted once."""
    if split is not None and any(split):
        own = sum(torch.sum(g * g) for g, s in zip(grads, split) if s)
        rest = sum(torch.sum(g * g) for g, s in zip(grads, split) if not s)
        norm = [torch.sqrt(mesh.sum_over_model(own) + rest)] * len(grads)
    elif members:
        norm = torch.sqrt(sum(torch.sum((g * g).flatten(1), dim=1) for g in grads))  # [E]
        norm = [norm.reshape(-1, *[1] * (g.dim() - 1)) for g in grads]
    else:
        norm = [torch.sqrt(sum(torch.sum(g * g) for g in grads))] * len(grads)
    return [torch.where(n < max_norm, g, (g / n) * max_norm) for g, n in zip(grads, norm)]


def optimizer_step(optimizer: torch.optim.Optimizer, leaves: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor], clip_grad: Optional[float] = None,
                   members: bool = False, split: Optional[Sequence[bool]] = None,
                   mesh=None) -> None:
    """One step of ``optimizer`` on ``leaves`` with ``grads``, clipped by
    their global norm first where ``clip_grad`` is set (per member of
    stacked leaves with ``members``; over the model group for the ``split``
    leaves of a ``mesh``)."""
    if clip_grad:
        grads = clip_by_global_norm(grads, clip_grad, members, split, mesh)
    for leaf, grad in zip(leaves, grads):
        leaf.grad = grad
    optimizer.step()


def cast_compute(tree, compute_dtype: Optional[torch.dtype]):
    """Mixed precision: every floating tensor of ``tree`` (the params) cast
    to ``compute_dtype``, inside the differentiated loss, so the gradients
    come back in the masters' dtype; the tree itself where it is None."""
    if compute_dtype is None:
        return tree
    return tree_map(lambda x: x.to(compute_dtype)
                    if isinstance(x, torch.Tensor) and x.is_floating_point() else x, tree)


def outputs_f32(tree, compute_dtype: Optional[torch.dtype]):
    """The tensors of a forward's outputs in ``compute_dtype`` cast back to
    float32, so every loss accumulates in full precision; the tree itself
    where ``compute_dtype`` is None."""
    if compute_dtype is None:
        return tree
    return tree_map(lambda x: x.float()
                    if isinstance(x, torch.Tensor) and x.dtype == compute_dtype else x, tree)


def f32_model(model):
    """A copy of ``model`` (its generator and discriminator copied too) that
    computes in its params' dtype: predictor pickles are saved with compute
    dtype None, as the JAX package saves them, and evaluate in f32."""
    model = copy.copy(model)
    for part in ("generator", "discriminator"):
        if hasattr(model, part):
            setattr(model, part, copy.copy(getattr(model, part)))
    return model.with_dtype(None)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def step_lr(lr: float, step_size: Optional[int], gamma: float = 0.1):
    """StepLR schedule over epochs: lr * gamma^(epoch // step_size)."""

    def schedule(epoch: int) -> float:
        if not step_size:
            return lr
        return lr * (gamma ** (epoch // step_size))

    return schedule


def adam_state_to_numpy(optimizer: torch.optim.Adam, paths: Sequence[str],
                        gather=None) -> Dict:
    """The Adam moments as numpy, keyed by parameter path:
    ``{path: {"step", "exp_avg", "exp_avg_sq"}}`` (paths in the optimizer's
    parameter order), each moment passed through ``gather(path, tensor)``
    where given.  A parameter not stepped yet has no entry."""
    state = optimizer.state_dict()["state"]
    gather = gather or (lambda path, x: x)
    return {path: {"step": float(state[i]["step"]),
                   **{k: gather(path, state[i][k].detach()).cpu().numpy()
                      for k in ("exp_avg", "exp_avg_sq")}}
            for i, path in enumerate(paths) if i in state}


def adam_state_from_numpy(optimizer: torch.optim.Adam, paths: Sequence[str],
                          saved: Dict) -> None:
    """Restore moments written by ``adam_state_to_numpy``; a path of the
    optimizer that ``saved`` lacks raises."""
    missing = [p for p in paths if p not in saved]
    if missing:
        raise KeyError(f"the saved optimizer state has no entry for {missing}")
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(saved[p]["step"], dtype=torch.float32),
                       "exp_avg": torch.from_numpy(saved[p]["exp_avg"]),
                       "exp_avg_sq": torch.from_numpy(saved[p]["exp_avg_sq"])}
                   for i, p in enumerate(paths)}
    optimizer.load_state_dict(sd)


# ----------------------------------------------------------------------- mesh
def validate_mesh_batch(mesh, batch_size: int) -> None:
    """Mesh batches shard scene-wise: batch_size must divide over 'data'."""
    if mesh is not None and batch_size % mesh.shape["data"] != 0:
        raise ValueError(f"batch_size {batch_size} must divide over data axis "
                         f"{mesh.shape['data']}")


def _agree_or_raise(mesh, *arrays, what: str) -> None:
    """Raise unless every rank of ``mesh`` holds the same ``arrays``: an
    order-sensitive sha256 of their bytes, all-gathered.  A check that
    survives ``python -O``, not an assert."""
    if mesh is None:
        return
    h = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).digest()
    if not all_processes_agree(np.frombuffer(h[:16], dtype=np.uint8)):
        raise RuntimeError(f"{what} differs across processes (seed drift?)")


def place_plan_on_mesh(mesh, idx: np.ndarray, valid: np.ndarray):
    """An epoch plan's ``[nb, S]`` index and valid arrays on ``mesh``:
    every rank keeps the whole plan (each builds the same one from the same
    seed, and runs its rows of each batch), after a digest check that turns
    a rank's drift into an error instead of a silently wrong gather (a sum
    would miss a reordering).  ``mesh`` None: the plan as it is."""
    _agree_or_raise(mesh, idx, valid, what="epoch plan")
    return idx, valid


def replicate_on_mesh(mesh, arr) -> np.ndarray:
    """A per-batch host array (flags) that every rank holds whole, checked
    to be the same on every rank of ``mesh``."""
    arr = np.asarray(arr)
    _agree_or_raise(mesh, arr, what="per-batch flags")
    return arr


def shard_carry_on_mesh(mesh, tree):
    """The tensor-parallel rule (``parallel/mesh.py``) applied to a params
    or optimizer tree: this rank's block of each split leaf."""
    return shard_params(mesh, tree)


# -------------------------------------------------------------------- logging
class JsonFormatter(logging.Formatter):
    """Single-line JSON records."""

    def format(self, record):
        payload = {}
        if isinstance(record.msg, dict):
            payload.update(record.msg)
        else:
            payload["message"] = record.getMessage()
        payload.update({"levelname": record.levelname, "name": record.name,
                        "asctime": self.formatTime(record)})
        return json.dumps(payload)


def setup_logging(output: str, append: bool = False, rank: int = 0) -> None:
    """JSON records to ``output.log`` and stdout; a rank other than 0 of a
    multi-process run logs warnings only, and to stdout."""
    stdout_handler = logging.StreamHandler(sys.stdout)
    if rank != 0:
        logging.basicConfig(level=logging.WARNING, handlers=[stdout_handler], force=True)
        return
    file_handler = logging.FileHandler(output + ".log", mode="a" if append else "w")
    file_handler.setFormatter(JsonFormatter())
    logging.basicConfig(level=logging.INFO, handlers=[stdout_handler, file_handler], force=True)


def log_process_record(args, version: str) -> None:
    logging.info({
        "type": "process",
        "argv": sys.argv,
        "args": vars(args),
        "version": version,
        "hostname": socket.gethostname(),
    })
