"""Seed-ensemble LSTM trainer: the published protocol's seeds in one process.

Port of ``trajnetplusplusbaselines_tpu/trainers/ensemble.py``
(``EnsembleTrainer`` and ``main``): the LSTM trainer's flags
(``trainers/lstm.add_arguments``) plus ``--seeds`` (default 42 10 20 30 40),
``--suffix`` and ``--no_autosplit``; per-member outputs
``OUTPUT_BLOCK/<path>/lstm_<type>_seed<k><suffix>.pkl`` (``lstm_goals_``
with goals), their ``.epoch<k>`` checkpoints and ``.state`` sidecars in the
sequential trainer's format, so ``trainers.lstm --load-full-state`` resumes
any member; the JSON log beside the first member's output
(``..._ensemble.pkl.log``), its records holding one loss per member.

The members are folded into one step:

- params are stacked ``[E, ...]``, each member initialised as the
  sequential trainer initialises its seed, and one ``torch.optim.Adam``
  runs over the stacked leaves: Adam and its coupled weight decay are
  elementwise, so that is each member's own Adam; the optional global-norm
  clip is per member (``common.clip_by_global_norm(members=True)``);
- each member keeps the sequential trainer's draws for its seed: its epoch
  plan from ``np.random.default_rng(seed)``, its augmentation from a
  ``torch.Generator`` seeded ``seed + 1``, so member k is the sequential run
  of seed k; every member's batch at step i comes from the same agent
  bucket, so the batches stack ``[T, E, S, A, 2]``;
- one train step is ``LSTM.step`` under ``torch.func.vmap`` over the
  members' params, carry and inputs, with the encoder and decoder loops
  outside the vmap (``LSTM.encode`` / ``decode`` take the step to call);
  under ``--remat`` the vmapped step is wrapped in ``torch.utils.checkpoint``
  (a checkpoint inside a vmap does not compose with autograd).  The loss is
  the sum of the members' teacher-forced losses (each vmapped over the
  member axis), and the backward is ordinary autograd;
- a directional grid's grid stage (``ops/cuda/fused_step.directional_grid``)
  folds the members into its scene axis (its vmap rule): 19 launches per
  ensemble step, not 19 per member.  Training and validation both take the
  ``"grid"`` route (the fused step's weights are one member's, and it has
  no vmap rule); each written pickle serves on the fused route as before.

Validation is each member's teacher-forced loss, as the JAX ensemble
validates.  As in the JAX module the ensemble does not read ``--col_wt``,
``--start_length`` or ``--obs_dropout``.  ``--dp`` shards the scene axis of
the stacked ``[T, E, S, A, 2]`` batch as the LSTM trainer shards a batch
(each member's draws made whole on every rank; each rank's vmapped step
still folds the members into one grid-stage launch); ``--tp`` above 1
raises, as in JAX (the rule does not shard the stacked ``[E, ...]``
leaves).  ``--orbax`` is refused as the LSTM trainer refuses it.

A ``torch.cuda.OutOfMemoryError`` (matched by type) splits the members into
chunks of ceil(E / 2) and the rest, each retrained in a subprocess of this
module (``--no_autosplit`` raises instead; so does a multi-process run).

Usage:
    python -m trajnetplusplusbaselines_torch.trainers.ensemble --path trajdata \
        --type directional --augment --seeds 42 10 20 30 40 --device cuda
"""

import argparse
import gc
import logging
import os
import random
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from .. import __version__ as VERSION
from ..losses import l2_loss, prediction_loss
from ..models.lstm import LSTM, Inputs, LSTMPredictor, StepCarry
from ..ops.pooling import make_pool
from ..parallel.multihost import process_info
from ..utils import checkpoint as ckpt
from ..utils.convert import params_to_numpy
from .common import (
    Batch,
    EpochLoop,
    bucket_batches,
    cast_compute,
    f32_model,
    log_process_record,
    make_optimizer,
    optimizer_step,
    outputs_f32,
    param_items,
    place_plan_on_mesh,
    set_lr,
    setup_logging,
    step_lr,
)
from .lstm import add_arguments, check_device, configure, join_ranks, read_splits, run_mesh


def stack_params(members: List[Dict]) -> Dict:
    """One params tree whose leaves stack the members' ``[E, ...]``."""
    return tree_map(lambda *leaves: torch.stack(leaves), *members)


def member_params(stacked: Dict, i: int) -> Dict:
    """Member ``i``'s params, detached views of the stacked leaves."""
    return tree_map(lambda x: x[i].detach(), stacked)


def _dims(tree):
    """vmap's in/out dims of ``tree``: 0 for a tensor, None for a None."""
    return tree_map(lambda x: None if x is None else 0, tree)


class EnsembleTrainer(EpochLoop):
    """Trains the members of an ensemble of one ``LSTM`` configuration, their
    params stacked ``[E, ...]`` on one device; the stacked leaves are
    trained in place."""

    def __init__(self, model: LSTM, stacked_params: Dict, lr_schedule, seeds,
                 criterion="pred", batch_size=8, obs_length=9, pred_length=12, augment=True,
                 augment_noise=False, save_every=1, val_flag=True, clip_grad=None, mesh=None):
        if mesh is not None and mesh.shape["model"] != 1:
            raise ValueError("ensemble trainer supports --dp only")
        self.model = model
        self.params = self.attach_mesh(mesh, stacked_params, batch_size)
        self.paths, self.leaves = zip(*param_items(self.params))
        for leaf in self.leaves:
            leaf.requires_grad_()
        self.device = self.leaves[0].device
        self.optimizer = make_optimizer(self.leaves)
        self.clip_grad = clip_grad
        self.lr_schedule = lr_schedule
        self.seeds = list(seeds)
        if self.leaves[0].shape[0] != len(self.seeds):
            raise ValueError(f"{len(self.seeds)} seeds for {self.leaves[0].shape[0]} members")
        self.criterion = criterion
        self.log = logging.getLogger(self.__class__.__name__)

        self.batch_size = batch_size
        self.obs_length = obs_length
        self.pred_length = pred_length
        self.seq_length = obs_length + pred_length
        self.augment = augment
        self.augment_noise = augment_noise
        self.save_every = save_every
        self.val_flag = val_flag

        # each member the sequential trainer's draws for its seed
        self.rngs = [np.random.default_rng(s) for s in self.seeds]
        self.generators = [torch.Generator(device=self.device).manual_seed(s + 1)
                           for s in self.seeds]
        self._resident = {}

    # ------------------------------------------------------------------ step
    @property
    def route(self) -> str:
        """Every ensemble step's route: the grid stage for a directional
        grid within its range, else plain PyTorch (``LSTM.route``)."""
        return "grid" if self.model.grid_stage else "plain"

    def step_fn(self):
        """``LSTM.step`` vmapped over the members, as ``LSTM.encode`` and
        ``decode`` call a step; under ``--remat`` (where autograd records)
        the vmapped step is checkpointed."""
        model = self.model
        remat = model.remat and torch.is_grad_enabled()

        def step(params, cell_name, carry, obs1, obs2, present1, present2, weights=None, *,
                 goals=None, slot_mask=None, route=None):
            def member(params, carry, obs1, obs2, present1, present2, goals, slot_mask):
                return model.step(params, cell_name, carry, obs1, obs2, present1, present2,
                                  goals=goals, slot_mask=slot_mask, route=route)

            args = (params, carry, obs1, obs2, present1, present2, goals, slot_mask)
            fn = torch.func.vmap(member, in_dims=_dims(args), out_dims=(_dims(carry), 0, 0))
            if remat:
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        return step

    def _carry(self, e: int, s: int, a: int, like: torch.Tensor) -> StepCarry:
        carry = self.model.init_carry(e * s, a, device=like.device, dtype=like.dtype)
        return tree_map(lambda x: None if x is None else x.reshape(e, s, a, -1), carry)

    def forward(self, params: Dict, xy, mask, goals, slot_mask):
        """The members' teacher-forced rollouts: xy [T, E, S, A, 2], mask
        [T, E, S, A], goals [E, S, A, 2], slot_mask [E, S, A].  Returns
        (rel_pred [T', E, S, A, 5], pred [T', E, S, A, 2], valid [T', E, S, A])
        in f32 (or the params' dtype)."""
        dtype = self.model.compute_dtype
        params = cast_compute(params, dtype)
        ref = params["encoder"]["w_ih"]

        def place(x):
            return x.to(device=ref.device, dtype=ref.dtype).contiguous()

        x = Inputs(place(xy[:self.obs_length]), mask[:self.obs_length].contiguous(),
                   place(xy[self.obs_length:self.seq_length - 1]),
                   mask[self.obs_length:self.seq_length - 1].contiguous(), None, place(goals),
                   slot_mask.contiguous())
        step = self.step_fn()
        carry = self._carry(*x.observed.shape[1:4], ref)
        carry, enc_normals, enc_masks, enc_positions = self.model.encode(
            params, carry, x.observed, x.observed_mask, goals=x.goals, slot_mask=x.slot_mask,
            route=self.route, step=step)
        start = self.model.start_decoder(carry, x, enc_positions, enc_masks)
        _, dec_normals, dec_masks, dec_positions = self.model.decode_from(
            params, start, None, self.route, step=step)
        return outputs_f32((torch.stack(enc_normals + dec_normals),
                            torch.stack(enc_positions + dec_positions),
                            torch.stack(enc_masks + dec_masks)), dtype)

    def _member_loss(self, rel, xy, scene_mask):
        """One member's primary-only criterion x batch size: rel [T', S, A,
        5], xy [T, S, A, 2], scene_mask [S]."""
        targets = (xy[self.obs_length:self.seq_length, :, 0]
                   - xy[self.obs_length - 1:self.seq_length - 1, :, 0])
        loss = l2_loss if self.criterion == "L2" else prediction_loss
        return loss(rel[-self.pred_length:, :, 0], targets, scene_mask) * self.batch_size

    def member_losses(self, xy, mask, scene_mask, goals, slot_mask) -> torch.Tensor:
        """Each member's teacher-forced loss of its batch, ``[E]``; on a
        mesh the rank rolls out its scenes and every rank's are gathered."""
        rel, _, _ = self.forward(self.params, self._rows(xy, 2), self._rows(mask, 2),
                                 self._rows(goals, 1), self._rows(slot_mask, 1))
        return torch.func.vmap(self._member_loss, in_dims=(1, 1, 0))(self._gather(rel, 2), xy,
                                                                      scene_mask)

    def loss_and_grads(self, xy, mask, scene_mask, goals, slot_mask):
        """(the members' losses [E], the gradient of their sum for every
        stacked leaf: each member's own gradient in its rows)."""
        losses = self.member_losses(xy, mask, scene_mask, goals, slot_mask)
        grads = torch.autograd.grad(losses.sum(), self.leaves, materialize_grads=True)
        return losses.detach(), self._summed(grads)

    def train_step(self, xy, mask, scene_mask, goals, slot_mask):
        """One optimizer step of every member on its batch (a stacked
        ``Batch``); returns the members' losses [E], on the device."""
        losses, grads = self.loss_and_grads(xy, mask, scene_mask, goals, slot_mask)
        optimizer_step(self.optimizer, self.leaves, grads, self.clip_grad, members=True)
        return losses

    # ----------------------------------------------------------------- epochs
    def _member_batches(self, scenes, shuffle: bool, augment=False, augment_noise=False):
        """The stacked ``Batch`` of each step: member k's batch is the one
        the sequential trainer of seed k draws (its plan, its augmentation),
        stacked on axis 1 of the time-major fields and axis 0 of the
        others."""
        resident = self._get_resident(scenes)
        plans = [resident.epoch_plan(self.batch_size, rng, shuffle=shuffle) for rng in self.rngs]
        for key in plans[0]:
            for plan in plans:
                place_plan_on_mesh(self.mesh, *plan[key])
            streams = [bucket_batches(resident.buckets[key], *plan[key], augment=augment,
                                      augment_noise=augment_noise, obs_length=self.obs_length,
                                      generator=gen)
                       for plan, gen in zip(plans, self.generators)]
            for members in zip(*streams):
                yield Batch(*(torch.stack(field, dim=1 if i < 2 else 0)
                              for i, field in enumerate(zip(*members))))

    def train(self, scenes, epoch: int):
        start = time.time()
        print("epoch", epoch)
        lr = float(self.lr_schedule(epoch))
        set_lr(self.optimizer, lr)
        losses = [self.train_step(*batch) for batch in self._member_batches(
            scenes, True, self.augment, self.augment_noise)]
        losses = (torch.stack(losses, dim=1).cpu().numpy() if losses  # [E, nb]; sync point
                  else np.zeros((len(self.seeds), 0)))
        self.epoch_losses = losses
        self.log.info({
            "type": "train-epoch",
            "epoch": epoch + 1,
            "loss": [round(float(x), 5) for x in losses.sum(axis=1) / max(len(scenes), 1)],
            "seeds": self.seeds,
            "lr": lr,
            "time": round(time.time() - start, 1),
        })

    def val(self, scenes, epoch: int):
        start = time.time()
        with torch.no_grad():
            losses = [self.member_losses(*batch)
                      for batch in self._member_batches(scenes, shuffle=False)]
        total = (torch.stack(losses).sum(dim=0).cpu().numpy() if losses
                 else np.zeros(len(self.seeds)))
        self.log.info({
            "type": "val-epoch",
            "epoch": epoch + 1,
            "loss": [round(float(x), 3) for x in total / max(len(scenes), 1)],
            "seeds": self.seeds,
            "time": round(time.time() - start, 1),
        })

    def loop(self, train_scenes, val_scenes, outputs: List[str], epochs=25):
        for epoch in range(epochs):
            if epoch % self.save_every == 0:
                self.save_checkpoints(epoch, [o + f".epoch{epoch}" for o in outputs])
            self.train(train_scenes, epoch)
            if self.val_flag and val_scenes is not None:
                self.val(val_scenes, epoch)
        self.save_checkpoints(epochs, [o + f".epoch{epochs}" for o in outputs])
        self.save_checkpoints(epochs, outputs)

    def save_checkpoints(self, epoch: int, filenames: List[str]):
        """Each member's predictor pickle and sidecar, in the sequential
        trainer's format (its params, its rows of the Adam state), so that
        ``trainers.lstm --load-full-state`` resumes it; rank 0 writes."""
        if not self.writes:
            return
        lr = float(self.lr_schedule(max(epoch - 1, 0)))
        opt_state = self._full_adam_state(self.optimizer, self.paths)
        model = f32_model(self.model)
        for i, filename in enumerate(filenames):
            params = member_params(self.params, i)
            state = {
                "epoch": epoch,
                "params": params_to_numpy(params),
                "opt_state_hyper": {"learning_rate": lr},
                "opt_state": {path: {"step": s["step"], "exp_avg": s["exp_avg"][i],
                                     "exp_avg_sq": s["exp_avg_sq"][i]}
                              for path, s in opt_state.items()},
            }
            ckpt.save_predictor(LSTMPredictor(model, params), filename, state)


# ---------------------------------------------------------------- auto-split
def is_resource_failure(exc: BaseException) -> bool:
    """True for the card running out of memory, matched by type."""
    return isinstance(exc, torch.cuda.OutOfMemoryError)


def split_members(seeds):
    """Ceil-half member split preserving order: [a,b,c,d,e] -> [a,b,c],[d,e]."""
    if len(seeds) < 2:
        raise ValueError("cannot split a single member")
    half = (len(seeds) + 1) // 2
    return [list(seeds[:half]), list(seeds[half:])]


def argv_with_seeds(argv, seeds):
    """Copy of a CLI argv with any --seeds group replaced by ``seeds``."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] == "--seeds":
            i += 1
            while i < len(argv) and not argv[i].startswith("--"):
                i += 1
            continue
        out.append(argv[i])
        i += 1
    return out + ["--seeds"] + [str(s) for s in seeds]


def run_chunks(argv, chunks, log):
    """Retrain each chunk of members in a subprocess of this module."""
    for chunk in chunks:
        log.warning({"type": "ensemble-split-chunk", "seeds": chunk})
        rc = subprocess.call([sys.executable, "-m", __spec__.name,
                              *argv_with_seeds(argv, chunk)])
        if rc != 0:
            raise SystemExit(f"ensemble auto-split chunk {chunk} failed with rc={rc}")


def train_members(args, device, outputs):
    """Build the ensemble of ``args.seeds`` on ``device`` and train it (on
    ``--dp`` ranks, this rank's part); returns the trainer."""
    pool = make_pool(args.type, args)
    model = configure(LSTM(pool=pool, embedding_dim=args.coordinate_embedding_dim,
                           hidden_dim=args.hidden_dim, goal_flag=args.goals,
                           goal_dim=args.goal_dim), args)
    stacked = stack_params([model.init_params(torch.Generator().manual_seed(s), device=device)
                            for s in args.seeds])
    train_ds, val_ds, val_flag = read_splits(args)
    trainer = EnsembleTrainer(
        model, stacked, step_lr(args.lr, args.step_size), args.seeds, criterion=args.loss,
        batch_size=args.batch_size, obs_length=args.obs_length, pred_length=args.pred_length,
        augment=args.augment, augment_noise=args.augment_noise, save_every=args.save_every,
        val_flag=val_flag, clip_grad=args.clip_grad, mesh=run_mesh(args, device))
    trainer.loop(train_ds, val_ds, outputs, epochs=args.epochs)
    return trainer


def main(epochs=25, argv=None):
    """Train from the command line; returns the ``EnsembleTrainer``, or None
    where the members were retrained in chunks."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    parser = argparse.ArgumentParser()
    add_arguments(parser, epochs)
    parser.add_argument("--seeds", type=int, nargs="+", default=[42, 10, 20, 30, 40])
    parser.add_argument("--suffix", default="",
                        help="appended to each member's seed<k> output name")
    parser.add_argument("--no_autosplit", action="store_true",
                        help="fail outright on running out of memory instead of retraining "
                             "member chunks in subprocesses")
    args = parser.parse_args(argv)
    device = check_device(args)
    if args.tp > 1:
        raise ValueError("ensemble trainer supports --dp only (members are vmapped over the "
                         "stacked [E, ...] param layout, which the TP rule does not shard)")
    device = join_ranks(args, device, "trajnetplusplusbaselines_torch.trainers.ensemble")

    random.seed(args.seeds[0])
    np.random.seed(args.seeds[0])
    prefix = "lstm_goals" if args.goals else "lstm"
    os.makedirs(f"OUTPUT_BLOCK/{args.path}", exist_ok=True)
    outputs = [f"OUTPUT_BLOCK/{args.path}/{prefix}_{args.type}_seed{s}{args.suffix}.pkl"
               for s in args.seeds]
    setup_logging(outputs[0].replace(".pkl", "_ensemble.pkl"), rank=process_info()[0])
    log_process_record(args, VERSION)

    log = logging.getLogger("EnsembleTrainer")
    try:
        return train_members(args, device, outputs)
    except Exception as exc:  # pylint: disable=broad-except
        if (args.no_autosplit or len(args.seeds) < 2 or not is_resource_failure(exc)
                or process_info()[1] > 1):
            raise
        chunks = split_members(args.seeds)
        log.warning({"type": "ensemble-autosplit", "reason": repr(exc)[:500],
                     "seeds": args.seeds, "chunks": chunks})
        # drop the failed attempt's frames, which pin its tensors on the card
        exc = None  # noqa: F841
        gc.collect()
        torch.cuda.empty_cache()
        run_chunks(argv, chunks, log)
        return None


if __name__ == "__main__":
    main()
