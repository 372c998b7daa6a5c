"""Command-line LSTM trainer.

Port of ``trajnetplusplusbaselines_tpu/trainers/lstm.py``: the same flags
and defaults, every ``--type`` and ``--goals``, output naming
(``OUTPUT_BLOCK/<path>/lstm_<type>_<o>.pkl``, ``lstm_goals_...`` with goals),
JSON log records (process / train / train-epoch / val-epoch), checkpoints
every ``save_every`` epochs and the three restore modes, plus ``--device``
(default ``cuda``; it raises where no card is present, and never trains on
another device than the one asked for).  JAX's ``--cpu`` is ``--device cpu``.

One train step is a teacher-forced ``LSTM.forward`` under autograd, with
each batch's goals (``--goals``: ``goal_files/{train,val}/<file>.pkl``, as
the JAX trainer reads them) and slot mask, the primary-only loss (x batch
size, with an optional collision term), its gradients, the optional
global-norm clip and an Adam update.  The epoch visits the buckets of
``ResidentDataset.epoch_plan``, batch by batch, with the losses kept on the
device and read once at the end of the epoch.

On one card in one process (``graphs.takes_graphs``) the step replays a
CUDA graph, one per batch shape (``graphs.StepGraphs``: three eager steps
on a side stream, then a capture, then replays into static buffers).  On
the card Adam takes its capturable form (``graphs.capturable_optimizer``:
the step count and the learning rate there, the rate filled in place by
``set_lr``), on a mesh too, where the step stays eager, so that sharded
ranks step as one process does.  A replay computes the eager step's
numbers; ``loss_and_grads`` and validation stay eager, and so does every
step on the CPU.

Where each step runs is ``models/lstm.LSTM.route``.  On the card every
directional grid within the grid stage's range (a goal D-LSTM, other
embeddings, other n) launches the grid stage of the fused kernel
(``ops/cuda/fused_step.directional_grid``) once per recurrence step, 19 times
per train step, in training and in validation; validation records no
autograd, so a flagship D-LSTM's teacher-forced pass and free rollout launch
the whole fused step instead (in f32; in bf16 they take the grid stage).
The other pools run in PyTorch.

The JAX trainer's training options:

- ``--bf16``: f32 master params and Adam state; the params cast to bf16
  inside the differentiated loss (``common.cast_compute``), the positions,
  carry and pool state with them, the outputs cast back to f32 for the
  losses (``common.outputs_f32``); a directional grid's grid stage runs in
  bf16.  Pickles are saved with compute dtype None (``common.f32_model``).
- ``--remat``: ``LSTM.remat``, each recurrence step checkpointed.
- ``--obs_dropout``: the chunked host path: batches packed on the host
  (``SceneDataset.epoch_batches``, augmentation from the numpy generator),
  one ``start_length`` drawn per batch right after it, the epoch trained in
  JAX's grouped order (``group_batches`` by scenes, agents and
  ``start_length``), each ``start_length`` logged; validation starts at 0.
- ``--load-full-state`` of a JAX sidecar: its optax Adam state converted
  (``utils/checkpoint.adam_state_from_optax``), resumed from its epoch.
- ``--dp`` / ``--tp``: one process per rank, ``dp * tp`` of them, launched
  by ``python -m torch.distributed.run`` (``join_ranks``; NCCL where each
  rank has a card, gloo where ranks share one).  Every rank builds the same
  epoch plan and augmentation, runs its ``batch_size / dp`` scenes of each
  batch, gathers the outputs and scores the whole batch, so the loss is the
  one-process loss; the gradients sum over ``data``.  Under ``--tp`` a rank
  holds the column blocks of the leaves JAX's rule splits, with their Adam
  moments, and the forward gathers the full leaves.  Rank 0 logs and writes
  the checkpoints, full leaves and moments, as one process writes them.
  ``--obs_dropout`` with a mesh raises (the host path is single-device).

``--orbax`` is refused for good (ROADMAP, "Do not port").

Usage:
    python -m trajnetplusplusbaselines_torch.trainers.lstm --path trajdata \
        --type directional --epochs 25 --device cuda
    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m trajnetplusplusbaselines_torch.trainers.lstm --path trajdata \
        --type directional --dp 2 --tp 1 --device cuda
"""

import argparse
import logging
import os
import random
import time

import numpy as np
import torch

from .. import __version__ as VERSION
from ..data.load import prepare_data
from ..losses import collision_loss, l2_loss
from ..models.lstm import LSTM, LSTMPredictor
from ..ops.cuda import fused_train
from ..ops.pooling import POOL_TYPES, make_pool
from ..parallel.mesh import make_mesh
from ..parallel.multihost import init_from_env, process_info
from ..utils import checkpoint as ckpt
from ..utils.convert import params_from_jax, params_to_numpy
from .common import (
    EpochLoop,
    SceneDataset,
    adam_state_from_numpy,
    cast_compute,
    f32_model,
    group_batches,
    log_process_record,
    make_optimizer,
    optimizer_step,
    outputs_f32,
    packed_batch,
    param_items,
    set_lr,
    setup_logging,
    step_lr,
)
from .graphs import StepGraphs, capturable_optimizer, takes_graphs


# the scene axis of ``LSTM.forward``'s (and ``VAE.forward``'s) tensor arguments
SCENE_DIMS = {"prediction_truth": 1, "prediction_truth_mask": 1, "goals": 0, "slot_mask": 0,
              "eps": 1}


class Trainer(EpochLoop):
    """Trains an ``LSTM`` whose params (a nested dict of tensors in the JAX
    layout) live on one device; the leaves are trained in place."""

    predictor_class = LSTMPredictor  # what ``save_checkpoint`` pickles
    # on the card, Adam in the form a CUDA graph can hold (``capturable_optimizer``)
    capturable_adam = True
    # the scene axis of each forward output: rel_pred, pred, valid [T', S, A, ...]
    output_scene_dims = (1, 1, 1)

    def __init__(self, model, params, lr_schedule, criterion="pred", batch_size=8,
                 obs_length=9, pred_length=12, augment=True, save_every=1, start_length=0,
                 augment_noise=False, val_flag=True, col_wt=0.0, col_distance=0.2, seed=42,
                 clip_grad=None, obs_dropout=False, mesh=None):
        if mesh is not None and obs_dropout:
            raise ValueError("--obs_dropout uses the chunked host path, which is "
                             "single-device; drop --dp/--tp")
        self.model = model
        self.params = self.attach_mesh(mesh, params, batch_size)
        self.paths, self.leaves = zip(*param_items(self.params))
        self.split = self._split(self.paths)
        for leaf in self.leaves:
            leaf.requires_grad_()
        self.device = self.leaves[0].device
        # on the card Adam keeps its step count and rate there (a graph can
        # hold it), on a mesh too, so that ranks step as one process does
        capturable = self.capturable_adam and self.device.type == "cuda"
        self.optimizer = (capturable_optimizer if capturable else make_optimizer)(self.leaves)
        # in one process on the card ``train_step`` replays CUDA graphs
        self.graphs = StepGraphs(self.optimizer) if takes_graphs(self.device, self.mesh) else None
        self.clip_grad = clip_grad
        self.lr_schedule = lr_schedule
        self.criterion = criterion
        self.log = logging.getLogger(self.__class__.__name__)

        self.batch_size = batch_size
        self.obs_length = obs_length
        self.pred_length = pred_length
        self.seq_length = obs_length + pred_length
        self.augment = augment
        self.augment_noise = augment_noise
        self.save_every = save_every
        self.start_length = start_length
        self.obs_dropout = obs_dropout
        self.val_flag = val_flag
        self.col_wt = col_wt
        self.col_distance = col_distance

        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._resident = {}
        self.epoch_losses = np.zeros(0)  # the last epoch's per-batch losses

    @property
    def compute_dtype(self):
        """The model's compute dtype (``--bf16``), None for its params'."""
        return self.model.compute_dtype

    # ------------------------------------------------------------------ step
    def _loss_from_outputs(self, rel, pred, valid, xy, mask, scene_mask):
        """Primary-only criterion (+ optional collision term), x batch size;
        the ``pred`` criterion as ``fused_train.criterion_loss``, whichever
        route made ``rel``."""
        targets = (xy[self.obs_length:self.seq_length, :, 0]
                   - xy[self.obs_length - 1:self.seq_length - 1, :, 0])  # [pred, S, 2]
        if self.criterion == "L2":
            loss = l2_loss(rel[-self.pred_length:, :, 0], targets, scene_mask)
        else:
            loss = fused_train.criterion_loss(rel, targets, scene_mask)

        if self.col_wt:
            # the primary's own predictions in the data's dtype, as JAX's
            # ``.at[].set`` casts them
            positions = xy[-self.pred_length:].clone()
            positions[:, :, 0] = pred[-self.pred_length:, :, 0]
            position_mask = mask[-self.pred_length:].clone()
            position_mask[:, :, 0] = valid[-self.pred_length:, :, 0]
            loss = loss + collision_loss(positions, position_mask, scene_mask, self.col_wt,
                                         self.col_distance)
        return loss * self.batch_size

    def _forward(self, params, xy, mask, start_length, **kwargs):
        """``LSTM.forward`` of ``xy[start_length:obs_length]`` in the compute
        dtype, its outputs in f32; on a mesh, of this rank's scenes, with
        every rank's outputs gathered (``output_scene_dims``)."""
        dtype = self.compute_dtype
        kwargs = {k: self._rows(v, SCENE_DIMS[k]) if k in SCENE_DIMS else v
                  for k, v in kwargs.items()}
        out = outputs_f32(self.model.forward(
            cast_compute(self._full(params), dtype),
            self._rows(xy[start_length:self.obs_length], 1),
            self._rows(mask[start_length:self.obs_length], 1), **kwargs), dtype)
        return tuple(self._gather(x, d) for x, d in zip(out, self.output_scene_dims))

    def _forward_train(self, params, xy, mask, start_length, goals, slot_mask):
        return self._forward(params, xy, mask, start_length,
                             prediction_truth=xy[self.obs_length:self.seq_length - 1],
                             prediction_truth_mask=mask[self.obs_length:self.seq_length - 1],
                             goals=goals, slot_mask=slot_mask)

    def loss_and_grads(self, xy, mask, scene_mask, goals=None, slot_mask=None,
                       start_length=None):
        """The teacher-forced loss of one batch and its gradient for every
        leaf (zeros for a leaf the loss does not reach, as in JAX).  goals
        [S, A, 2] and slot_mask [S, A] as ``LSTM.forward`` takes them;
        ``start_length`` (the first observed frame), the trainer's by
        default."""
        sl = self.start_length if start_length is None else start_length
        rel, pred, valid = self._forward_train(self.params, xy, mask, sl, goals, slot_mask)
        loss = self._loss_from_outputs(rel, pred, valid, xy, mask, scene_mask)
        grads = torch.autograd.grad(loss, self.leaves, materialize_grads=True)
        return loss.detach(), self._summed(grads)

    def train_step(self, xy, mask, scene_mask, goals=None, slot_mask=None, start_length=None):
        """One optimizer step on one batch (a ``common.Batch``'s fields);
        returns the loss, on the device.  A replay of the batch shape's CUDA
        graph where the trainer has ``graphs``, else eager."""
        sl = self.start_length if start_length is None else start_length
        batch = (xy, mask, scene_mask, goals, slot_mask)
        if self.graphs is None:
            return self._step(*batch, sl)
        return self.graphs.step(self._step, batch, sl)

    def _step(self, xy, mask, scene_mask, goals, slot_mask, start_length):
        loss, grads = self.loss_and_grads(xy, mask, scene_mask, goals, slot_mask, start_length)
        optimizer_step(self.optimizer, self.leaves, grads, self.clip_grad, split=self.split,
                       mesh=self.mesh)
        return loss

    # ----------------------------------------------------------------- loops
    def save_checkpoint(self, epoch: int, filename: str):
        """The predictor pickle and its ``.state`` sidecar, full leaves and
        moments (gathered on a mesh), written by rank 0."""
        params = self._full(self.params, autograd=False)
        state = {
            "epoch": epoch,
            "params": params_to_numpy(params),
            "opt_state_hyper": {"learning_rate": float(self.lr_schedule(max(epoch - 1, 0)))},
            "opt_state": self._full_adam_state(self.optimizer, self.paths),
        }
        if self.writes:
            ckpt.save_predictor(self.predictor_class(f32_model(self.model), params), filename,
                                state)

    def get_lr(self, epoch: int) -> float:
        return float(self.lr_schedule(epoch))

    def train(self, scenes: SceneDataset, epoch: int):
        start_time = time.time()
        print("epoch", epoch)
        lr = self.get_lr(epoch)
        set_lr(self.optimizer, lr)

        data_time = 0.0  # host time of the resident path's epoch plan
        if self.obs_dropout:
            losses = self._train_obs_dropout(scenes, epoch)
        else:
            resident = self._get_resident(scenes)
            t0 = time.time()
            plan = resident.epoch_plan(self.batch_size, self.rng, shuffle=True)
            data_time = time.time() - t0
            losses = [self.train_step(*batch) for batch in
                      self._batches(resident, plan, self.augment, self.augment_noise)]
        losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)  # sync point
        self.epoch_losses = losses
        self.log_train(scenes, epoch, losses, start_time, lr,
                       data_time=round(data_time / max(len(losses), 1), 6))

    def _train_obs_dropout(self, scenes: SceneDataset, epoch: int):
        """``--obs_dropout``'s epoch: every batch packed on the host, one
        ``start_length`` in [0, obs_length - 2] drawn after each, then the
        batches trained grouped by (scenes, agents, start_length), as the
        JAX trainer visits them.  Returns the losses, on the device."""
        items = []
        for packed in scenes.epoch_batches(self.batch_size, self.rng, self.augment,
                                           self.augment_noise):
            items.append((packed, int(self.rng.integers(0, self.obs_length - 1))))
        groups = group_batches(items, lambda it: (*it[0].xy.shape[1:3], it[1]))
        visited = [item for group in groups.values() for item in group]
        self.log.info({"type": "obs-dropout", "epoch": epoch,
                       "start_lengths": [sl for _, sl in visited]})
        return [self.train_step(*packed_batch(packed, self.device), start_length=sl)
                for packed, sl in visited]

    def val(self, scenes: SceneDataset, epoch: int):
        eval_start = time.time()
        resident = self._get_resident(scenes)
        plan = resident.epoch_plan(self.batch_size, self.rng, shuffle=False)
        sl = 0 if self.obs_dropout else self.start_length
        val_losses, test_losses = [], []
        with torch.no_grad():
            for xy, mask, scene, goals, slot in self._batches(resident, plan):
                outputs = self._forward_train(self.params, xy, mask, sl, goals, slot)
                val_losses.append(self._loss_from_outputs(*outputs, xy, mask, scene))
                outputs = self._forward(self.params, xy, mask, sl, n_predict=self.pred_length,
                                        goals=goals, slot_mask=slot)
                test_losses.append(self._loss_from_outputs(*outputs, xy, mask, scene))
        val_loss = float(torch.stack(val_losses).sum()) if val_losses else 0.0
        test_loss = float(torch.stack(test_losses).sum()) if test_losses else 0.0
        self.log.info({
            "type": "val-epoch",
            "epoch": epoch + 1,
            "loss": round(val_loss / max(len(scenes), 1), 3),
            "test_loss": round(test_loss / max(len(scenes), 1), 3),
            "time": round(time.time() - eval_start, 1),
        })


def add_arguments(parser, default_epochs=25):
    parser.add_argument("--epochs", default=default_epochs, type=int)
    parser.add_argument("--save_every", default=5, type=int)
    parser.add_argument("--obs_length", default=9, type=int)
    parser.add_argument("--pred_length", default=12, type=int)
    parser.add_argument("--start_length", default=0, type=int)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--clip_grad", default=None, type=float,
                        help="optional global-norm gradient clip")
    parser.add_argument("--step_size", default=10, type=int)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--path", default="trajdata", help="dataset name inside data_root")
    parser.add_argument("--data_root", default="DATA_BLOCK", help="root holding <path>/train etc.")
    parser.add_argument("--goals", action="store_true")
    parser.add_argument("--loss", default="pred", choices=("L2", "pred"))
    parser.add_argument("--type", default="vanilla", choices=POOL_TYPES)
    parser.add_argument("--sample", default=1.0, type=float)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--normalize_scene", action="store_true")
    parser.add_argument("--augment_noise", action="store_true")
    parser.add_argument("--obs_dropout", action="store_true")
    parser.add_argument("--orbax", action="store_true", help="not ported: refused")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed precision: bf16 forward and backward, f32 master params, "
                             "optimizer state and losses")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each recurrence step: its activations are recomputed "
                             "in the backward instead of kept")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda, cuda:N or cpu)")

    parallel = parser.add_argument_group("parallelism")
    parallel.add_argument("--dp", type=int, default=1,
                          help="data-parallel ranks (scenes of a batch split over them)")
    parallel.add_argument("--tp", type=int, default=1,
                          help="tensor-parallel ranks (wide weights split in column blocks)")

    pretrain = parser.add_argument_group("pretraining")
    pretrain.add_argument("--load-state", default=None)
    pretrain.add_argument("--load-full-state", default=None)
    pretrain.add_argument("--nonstrict-load-state", default=None)

    hyper = parser.add_argument_group("hyperparameters")
    hyper.add_argument("--hidden-dim", dest="hidden_dim", type=int, default=128)
    hyper.add_argument("--coordinate-embedding-dim", dest="coordinate_embedding_dim",
                       type=int, default=64)
    hyper.add_argument("--pool_dim", type=int, default=256)
    hyper.add_argument("--goal_dim", type=int, default=64)
    hyper.add_argument("--cell_side", type=float, default=0.6)
    hyper.add_argument("--n", type=int, default=12)
    hyper.add_argument("--layer_dims", type=int, nargs="*", default=[512])
    hyper.add_argument("--embedding_arch", default="one_layer")
    hyper.add_argument("--pool_constant", default=0, type=int)
    hyper.add_argument("--norm_pool", action="store_true")
    hyper.add_argument("--front", action="store_true")
    hyper.add_argument("--latent_dim", type=int, default=16)
    hyper.add_argument("--norm", default=0, type=int)
    hyper.add_argument("--no_vel", action="store_true")
    hyper.add_argument("--spatial_dim", type=int, default=32)
    hyper.add_argument("--vel_dim", type=int, default=32)
    hyper.add_argument("--attn_logit_cap", type=float, default=None)
    hyper.add_argument("--neigh", default=4, type=int)
    hyper.add_argument("--mp_iters", default=5, type=int)
    hyper.add_argument("--col_wt", default=0.0, type=float)
    hyper.add_argument("--col_distance", default=0.2, type=float)
    return parser


def refuse_unported(args) -> None:
    """Raise on a flag whose path the port does not have, before anything runs."""
    if args.orbax:
        raise NotImplementedError("--orbax is not ported: the port writes pickle sidecars only "
                                  "(ROADMAP, 'Do not port')")


def check_device(args) -> torch.device:
    """Refuse what the port does not have (``refuse_unported``) and a CUDA
    device where none is present, before anything runs."""
    refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asked for, but CUDA is not available")
    return device


def join_ranks(args, device, module: str = "trajnetplusplusbaselines_torch.trainers.lstm"
               ) -> torch.device:
    """This rank's device: joins the process group ``torch.distributed.run``
    started (``init_from_env``).  ``--dp * --tp`` must be the number of
    processes; else it raises, naming the launch, before anything is
    written."""
    device = init_from_env(device)
    world = process_info()[1]
    if args.dp * args.tp != world:
        n = args.dp * args.tp
        raise RuntimeError(
            f"--dp {args.dp} --tp {args.tp} takes {n} processes, and this run has {world}: "
            f"launch it as python -m torch.distributed.run --standalone --nproc_per_node {n} "
            f"-m {module} --dp {args.dp} --tp {args.tp} ...")
    return device


def run_mesh(args, device):
    """The (dp, tp) mesh of the ranks ``join_ranks`` joined; None for one
    process."""
    world = process_info()[1]
    return make_mesh(world, args.dp, args.tp, device) if world > 1 else None


def open_run(args, prefix: str) -> None:
    """Seed the host's generators, name the output
    (``OUTPUT_BLOCK/<path>/<prefix>_<type>_<o>.pkl``, in ``args.output``),
    start the JSON log beside it and settle which state to load."""
    random.seed(args.seed)
    np.random.seed(args.seed)

    os.makedirs(f"OUTPUT_BLOCK/{args.path}", exist_ok=True)
    args.output = f"OUTPUT_BLOCK/{args.path}/{prefix}_{args.type}_{args.output}.pkl"

    setup_logging(args.output, append=bool(args.load_full_state), rank=process_info()[0])
    log_process_record(args, VERSION)

    args.load_state_strict = True
    if args.nonstrict_load_state:
        args.load_state = args.nonstrict_load_state
        args.load_state_strict = False
    if args.load_full_state:
        args.load_state = args.load_full_state


def read_splits(args):
    """(train scenes, val scenes or None, val_flag) of ``--path``'s train and
    val splits, with goals under ``--goals``."""
    data_path = os.path.join(args.data_root, args.path)
    train_scenes, train_goals, _ = prepare_data(data_path, subset="/train/",
                                                sample=args.sample, goals=args.goals)
    val_scenes, val_goals, val_flag = prepare_data(data_path, subset="/val/",
                                                   sample=args.sample, goals=args.goals)
    train_ds = SceneDataset(train_scenes, args.obs_length, args.normalize_scene, train_goals)
    val_ds = (SceneDataset(val_scenes, args.obs_length, args.normalize_scene, val_goals)
              if val_scenes is not None else None)
    return train_ds, val_ds, val_flag


def load_params(args, params, device):
    """``params``, or the weights of ``--load-state`` (strict) or
    ``--nonstrict-load-state`` (the leaves whose path and shape match)."""
    if not args.load_state:
        return params, None
    print("Loading Model Dict")
    state = ckpt.load_state(args.load_state)
    if args.load_state_strict:
        return params_from_jax(state["params"], device=device), state
    params, skipped = ckpt.merge_params_nonstrict(params, state["params"])
    if skipped:
        print("nonstrict load skipped:", skipped)
    return params, state


def restore_optimizer(optimizer, paths, opt_state, block=None) -> None:
    """``--load-full-state``: Adam's moments from a port sidecar, or from a
    JAX sidecar's optax state (``ckpt.adam_state_from_optax``); with
    ``block(path, array)`` (a tensor-parallel rank's ``EpochLoop._block``),
    this rank's block of each moment."""
    print("Loading Optimizer Dict")
    if not ckpt.is_port_opt_state(opt_state):
        opt_state = ckpt.adam_state_from_optax(opt_state)
    if block is not None:
        opt_state = {path: {k: v if k == "step" else block(path, v) for k, v in s.items()}
                     for path, s in opt_state.items()}
    adam_state_from_numpy(optimizer, paths, opt_state)


def configure(model, args):
    """``--remat`` and ``--bf16`` on ``model`` (an SGAN: both players)."""
    for part in (getattr(model, "generator", model), getattr(model, "discriminator", model)):
        part.remat = args.remat
    if args.bf16:
        model.with_dtype(torch.bfloat16)
    return model


def main(epochs=25, argv=None):
    """Train from the command line; returns the ``Trainer``."""
    parser = argparse.ArgumentParser()
    add_arguments(parser, epochs)
    args = parser.parse_args(argv)
    device = join_ranks(args, check_device(args))
    mesh = run_mesh(args, device)
    pool = make_pool(args.type, args)
    open_run(args, "lstm_goals" if args.goals else "lstm")
    train_ds, val_ds, val_flag = read_splits(args)

    model = configure(LSTM(pool=pool, embedding_dim=args.coordinate_embedding_dim,
                           hidden_dim=args.hidden_dim, goal_flag=args.goals,
                           goal_dim=args.goal_dim), args)
    params = model.init_params(torch.Generator().manual_seed(args.seed), device=device)
    params, state = load_params(args, params, device)

    trainer = Trainer(
        model, params, step_lr(args.lr, args.step_size), criterion=args.loss,
        batch_size=args.batch_size, obs_length=args.obs_length,
        pred_length=args.pred_length, augment=args.augment, save_every=args.save_every,
        start_length=args.start_length, augment_noise=args.augment_noise,
        val_flag=val_flag, col_wt=args.col_wt, col_distance=args.col_distance,
        seed=args.seed, clip_grad=args.clip_grad, obs_dropout=args.obs_dropout, mesh=mesh,
    )
    start_epoch = 0
    if args.load_full_state:
        restore_optimizer(trainer.optimizer, trainer.paths, state["opt_state"], trainer._block())
        start_epoch = state["epoch"]
    trainer.loop(train_ds, val_ds, args.output, epochs=args.epochs, start_epoch=start_epoch)
    return trainer


if __name__ == "__main__":
    main()
