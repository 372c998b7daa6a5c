"""Command-line SGAN trainer.

Port of ``trajnetplusplusbaselines_tpu/trainers/sgan.py``: the LSTM
trainer's flags (``trainers/lstm.add_arguments``) and the GAN's (``--k``,
``--noise_dim``, ``--no_noise``, ``--noise_type``, ``--g_steps``,
``--d_steps``, ``--g_step_size``, ``--d_step_size``), ``--device`` (default
``cuda``, raising where no card is present), output naming
(``OUTPUT_BLOCK/<path>/sgan_<type>_<o>.pkl``, ``sgan_goals_...`` with
goals), JSON logs and the pickle with its ``.state`` sidecar.

Batches alternate, in the epoch's order, ``g_steps`` generator steps and
``d_steps`` discriminator steps.  A generator step is the variety loss (each
scene's criterion, x1, at the best of k teacher-forced rollouts, summed
over scenes) plus, with a discriminator, the adversarial loss of the last
mode's scores; a discriminator step scores the truth and one rollout made
without autograd.  Each player has its own Adam (weight decay 1e-4, the
optional global-norm clip) and StepLR schedule; the discriminator has its
own pool.  Validation is the variety loss of k free rollouts.  The noise and
the label smoothing come from the trainer's ``torch.Generator``.

On the card a directional grid's generator rollout launches the grid stage
19 times whatever k (the modes decode as one batch); a discriminator step's
rollout records no autograd, so a flagship generator takes the fused step,
and the discriminator's two scorings launch the grid stage 20 times each.
In a generator step the discriminator scores positions that carry the
generator's gradient, which the grid stage cannot pass on: that scoring
takes the plain grid (``models/lstm.LSTM.route``).

``--bf16`` and ``--remat`` act on both players as in the LSTM trainer;
``--obs_dropout`` trains the JAX trainer's host path: batches packed on the
host (augmentation from the numpy generator) in their shuffled order, the
generator and discriminator steps in turn, at the trainer's
``start_length`` (the JAX SGAN trainer draws none).  ``--load-full-state``
takes a JAX sidecar's two optax states.  ``--dp`` / ``--tp`` as in the LSTM
trainer, for both players: each rank rolls out and scores its scenes, the
rollouts and scores of every rank are gathered, and the variety and
adversarial losses are those of the whole batch (the noise and the label
are drawn alike on every rank); the per-batch generator / discriminator
flags are held the same on every rank (``replicate_on_mesh``);
``--obs_dropout`` with a mesh raises in ``Trainer.__init__``.  ``--orbax``
is refused as the LSTM trainer refuses it.

Usage:
    python -m trajnetplusplusbaselines_torch.trainers.sgan --path trajdata \
        --type directional --k 3 --device cuda
"""

import argparse
import logging
import time

import numpy as np
import torch

from ..losses import gan_d_loss, gan_g_loss, l2_loss, prediction_loss
from ..models.sgan import SGAN, LSTMDiscriminator, LSTMGenerator, SGANPredictor
from ..ops.pooling import make_pool
from ..utils import checkpoint as ckpt
from ..utils.convert import params_to_numpy
from .common import (
    EpochLoop,
    SceneDataset,
    cast_compute,
    f32_model,
    make_optimizer,
    optimizer_step,
    outputs_f32,
    packed_batch,
    param_items,
    replicate_on_mesh,
    set_lr,
    step_lr,
)
from .lstm import (add_arguments, check_device, configure, join_ranks, load_params, open_run,
                   read_splits, restore_optimizer, run_mesh)


class Trainer(EpochLoop):
    """Trains an ``SGAN`` whose params ``{"generator": ..., "discriminator":
    ...}`` live on one device; the leaves are trained in place."""

    def __init__(self, model: SGAN, params, g_schedule, d_schedule, criterion="L2",
                 batch_size=8, obs_length=9, pred_length=12, augment=True, save_every=1,
                 start_length=0, augment_noise=False, val_flag=True, seed=42, clip_grad=None,
                 obs_dropout=False, mesh=None):
        if model.g_steps + model.d_steps < 1:
            raise ValueError("an SGAN trains with g_steps + d_steps >= 1")
        if mesh is not None and obs_dropout:
            raise ValueError("obs_dropout uses the chunked host path, which is "
                             "single-device; it cannot be combined with a mesh")
        self.model = model
        self.params = self.attach_mesh(mesh, params, batch_size)
        self.g_paths, self.g_leaves = zip(*param_items(self.params["generator"]))
        self.d_paths, self.d_leaves = zip(*param_items(self.params["discriminator"]))
        self.g_split = self._split(self.g_paths, "generator/")
        self.d_split = self._split(self.d_paths, "discriminator/")
        for leaf in self.g_leaves + self.d_leaves:
            leaf.requires_grad_()
        self.device = self.g_leaves[0].device
        self.g_optimizer = make_optimizer(self.g_leaves)
        self.d_optimizer = make_optimizer(self.d_leaves)
        self.g_schedule = g_schedule
        self.d_schedule = d_schedule
        self.clip_grad = clip_grad
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

        self.rng = np.random.default_rng(seed)
        # augmentation, the generator's noise and the label smoothing
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._resident = {}
        self.epoch_losses = np.zeros(0)  # the last epoch's per-batch losses

    # ------------------------------------------------------------------ step
    def _params(self):
        """Both players' full params in the compute dtype (``--bf16``)."""
        return cast_compute(self._full(self.params), self.model.compute_dtype)

    def _f32(self, outputs):
        return outputs_f32(outputs, self.model.compute_dtype)

    def variety_loss(self, rel, xy, scene_mask):
        """The criterion of each scene's primary, at its best mode, summed
        over scenes.  rel [k, T', S, A, 5]."""
        targets = (xy[self.obs_length:self.seq_length, :, 0]
                   - xy[self.obs_length - 1:self.seq_length - 1, :, 0])
        loss = l2_loss if self.criterion == "L2" else prediction_loss
        per_mode = torch.stack([loss(r[-self.pred_length:, :, 0], targets, scene_mask,
                                     keep_batch_dim=True) for r in rel])  # [k, S]
        return torch.sum(torch.min(per_mode, dim=0).values)

    def _observed(self, xy, mask):
        """This rank's observed frames and their mask."""
        return (self._rows(xy[self.start_length:self.obs_length], 1),
                self._rows(mask[self.start_length:self.obs_length], 1))

    def _kw(self, goals, slot_mask):
        """This rank's goals and slot mask, as ``generate``'s keywords."""
        return dict(goals=self._rows(goals, 0), slot_mask=self._rows(slot_mask, 0))

    def _generate(self, params, observed, observed_mask, xy=None, mask=None, **kw):
        """``SGAN.generate`` of this rank's scenes, teacher-forced on
        ``xy[obs_length:]`` where given, in f32."""
        truth = {} if xy is None else dict(
            prediction_truth=self._rows(xy[self.obs_length:], 1),
            prediction_truth_mask=self._rows(mask[self.obs_length:], 1))
        return self._f32(self.model.generate(params, observed, observed_mask, rng=self.generator,
                                             **truth, **kw))

    def _fake_scores(self, params, observed, observed_mask, pred, valid, **kw):
        """The discriminator's scores of the last mode's predicted frames,
        every rank's gathered."""
        return self._gather(self._f32(self.model.discriminator.score(
            params["discriminator"], observed, observed_mask, pred[-1][-self.pred_length:],
            valid[-1][-self.pred_length:], **kw)), 0)

    def g_loss_and_grads(self, xy, mask, scene_mask, goals=None, slot_mask=None, *,
                         noise=None, label=None):
        """A generator step's loss and its gradient for every generator leaf.
        noise [k, noise_dim] and the smoothed real label, else drawn."""
        observed, observed_mask = self._observed(xy, mask)
        kw = self._kw(goals, slot_mask)
        params = self._params()
        rel, pred, valid = self._generate(params, observed, observed_mask, xy, mask, noise=noise,
                                          **kw)
        loss = self.variety_loss(self._gather(rel, 2), xy, scene_mask)
        if self.model.d_steps:
            scores_fake = self._fake_scores(params, observed, observed_mask, pred, valid, **kw)
            loss = loss + gan_g_loss(scores_fake, label, generator=self.generator)
        grads = torch.autograd.grad(loss, self.g_leaves, materialize_grads=True)
        return loss.detach(), self._summed(grads)

    def d_loss_and_grads(self, xy, mask, scene_mask, goals=None, slot_mask=None, *,
                         noise=None, label=None):
        """A discriminator step's loss and its gradient for every
        discriminator leaf: the truth and one rollout (made without
        autograd; noise [1, noise_dim], else drawn) scored."""
        observed, observed_mask = self._observed(xy, mask)
        kw = self._kw(goals, slot_mask)
        params = self._params()
        with torch.no_grad():
            _, pred, valid = self._generate(params, observed, observed_mask, xy, mask, modes=1,
                                            noise=noise, **kw)
        scores_real = self._gather(self._f32(self.model.discriminator.score(
            params["discriminator"], observed, observed_mask,
            self._rows(xy[self.obs_length:], 1), self._rows(mask[self.obs_length:], 1), **kw)), 0)
        scores_fake = self._fake_scores(params, observed, observed_mask, pred, valid, **kw)
        loss = gan_d_loss(scores_real, scores_fake, label, generator=self.generator)
        grads = torch.autograd.grad(loss, self.d_leaves, materialize_grads=True)
        return loss.detach(), self._summed(grads)

    def train_step(self, xy, mask, scene_mask, goals=None, slot_mask=None, step_type="g"):
        """One optimizer step of the generator (``"g"``) or the discriminator
        (``"d"``) on one batch; returns the loss, on the device."""
        if step_type == "g":
            loss, grads = self.g_loss_and_grads(xy, mask, scene_mask, goals, slot_mask)
            leaves, optimizer, split = self.g_leaves, self.g_optimizer, self.g_split
        else:
            loss, grads = self.d_loss_and_grads(xy, mask, scene_mask, goals, slot_mask)
            leaves, optimizer, split = self.d_leaves, self.d_optimizer, self.d_split
        optimizer_step(optimizer, leaves, grads, self.clip_grad, split=split, mesh=self.mesh)
        return loss

    def step_types(self, n_batches: int):
        """Per batch "g" or "d": g_steps generator steps then d_steps
        discriminator steps, repeating over the epoch; the same on every
        rank of a mesh (``replicate_on_mesh``)."""
        pattern = ["g"] * self.model.g_steps + ["d"] * self.model.d_steps
        generator_steps = replicate_on_mesh(self.mesh, [
            pattern[i % len(pattern)] == "g" for i in range(n_batches)])
        return ["g" if g else "d" for g in generator_steps]

    # ----------------------------------------------------------------- loops
    def save_checkpoint(self, epoch: int, filename: str):
        """The predictor pickle and its sidecar, full leaves and moments
        (gathered on a mesh), written by rank 0."""
        last = max(epoch - 1, 0)
        params = self._full(self.params, autograd=False)
        state = {
            "epoch": epoch,
            "params": params_to_numpy(params),
            "opt_state_hyper": {"g_learning_rate": float(self.g_schedule(last)),
                                "d_learning_rate": float(self.d_schedule(last))},
            "g_opt_state": self._full_adam_state(self.g_optimizer, self.g_paths, "generator/"),
            "d_opt_state": self._full_adam_state(self.d_optimizer, self.d_paths,
                                                 "discriminator/"),
        }
        if self.writes:
            ckpt.save_predictor(SGANPredictor(f32_model(self.model), params), filename, state)

    def train(self, scenes: SceneDataset, epoch: int):
        start_time = time.time()
        print("epoch", epoch)
        lr = float(self.g_schedule(epoch))
        set_lr(self.g_optimizer, lr)
        set_lr(self.d_optimizer, float(self.d_schedule(epoch)))

        if self.obs_dropout:
            # the JAX trainer's host path, in the shuffled order
            batches = [packed_batch(packed, self.device) for packed in scenes.epoch_batches(
                self.batch_size, self.rng, self.augment, self.augment_noise)]
        else:
            resident = self._get_resident(scenes)
            plan = resident.epoch_plan(self.batch_size, self.rng, shuffle=True)
            batches = self._batches(resident, plan, self.augment, self.augment_noise)
        losses = [self.train_step(*batch, step_type=kind) for kind, batch in
                  zip(self.step_types(len(scenes)), batches)]  # at most a batch a scene
        losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)  # sync point
        self.epoch_losses = losses
        self.log_train(scenes, epoch, losses, start_time, lr)

    def val(self, scenes: SceneDataset, epoch: int):
        eval_start = time.time()
        resident = self._get_resident(scenes)
        plan = resident.epoch_plan(self.batch_size, self.rng, shuffle=False)
        test_losses = []
        with torch.no_grad():
            for xy, mask, scene, goals, slot in self._batches(resident, plan):
                observed, observed_mask = self._observed(xy, mask)
                rel, _, _ = self._generate(self._params(), observed, observed_mask,
                                           n_predict=self.pred_length, **self._kw(goals, slot))
                test_losses.append(self.variety_loss(self._gather(rel, 2), xy, scene))
        test_loss = float(torch.stack(test_losses).sum()) if test_losses else 0.0
        self.log.info({
            "type": "val-epoch",
            "epoch": epoch + 1,
            "loss": 0.0,
            "test_loss": round(test_loss / max(len(scenes), 1), 3),
            "time": round(time.time() - eval_start, 1),
        })


def main(epochs=25, argv=None):
    """Train from the command line; returns the ``Trainer``."""
    parser = argparse.ArgumentParser()
    add_arguments(parser, epochs)
    gan = parser.add_argument_group("gan")
    gan.add_argument("--k", default=1, type=int, help="variety-loss samples")
    gan.add_argument("--noise_dim", default=16, type=int)
    gan.add_argument("--no_noise", action="store_true")
    gan.add_argument("--noise_type", default="gaussian", choices=("gaussian", "uniform"))
    gan.add_argument("--g_steps", default=1, type=int)
    gan.add_argument("--d_steps", default=1, type=int)
    gan.add_argument("--g_step_size", default=10, type=int)
    gan.add_argument("--d_step_size", default=10, type=int)
    args = parser.parse_args(argv)
    device = join_ranks(args, check_device(args), "trajnetplusplusbaselines_torch.trainers.sgan")
    mesh = run_mesh(args, device)
    pool, d_pool = make_pool(args.type, args), make_pool(args.type, args)
    open_run(args, "sgan_goals" if args.goals else "sgan")
    train_ds, val_ds, val_flag = read_splits(args)

    lstm_args = dict(embedding_dim=args.coordinate_embedding_dim, hidden_dim=args.hidden_dim,
                     goal_flag=args.goals, goal_dim=args.goal_dim)
    generator = LSTMGenerator(pool=pool, noise_dim=args.noise_dim, no_noise=args.no_noise,
                              noise_type=args.noise_type, **lstm_args)
    # the discriminator has its own, identically configured pool
    discriminator = LSTMDiscriminator(pool=d_pool, **lstm_args)
    model = configure(SGAN(generator, discriminator, k=args.k, d_steps=args.d_steps,
                           g_steps=args.g_steps), args)
    params = model.init_params(torch.Generator().manual_seed(args.seed), device=device)
    params, state = load_params(args, params, device)

    trainer = Trainer(
        model, params, step_lr(args.lr, args.g_step_size), step_lr(args.lr, args.d_step_size),
        criterion=args.loss, batch_size=args.batch_size, obs_length=args.obs_length,
        pred_length=args.pred_length, augment=args.augment, save_every=args.save_every,
        start_length=args.start_length, augment_noise=args.augment_noise, val_flag=val_flag,
        seed=args.seed, clip_grad=args.clip_grad, obs_dropout=args.obs_dropout, mesh=mesh,
    )
    start_epoch = 0
    if args.load_full_state:
        restore_optimizer(trainer.g_optimizer, trainer.g_paths, state["g_opt_state"],
                          trainer._block("generator/"))
        restore_optimizer(trainer.d_optimizer, trainer.d_paths, state["d_opt_state"],
                          trainer._block("discriminator/"))
        start_epoch = state["epoch"]
    trainer.loop(train_ds, val_ds, args.output, epochs=args.epochs, start_epoch=start_epoch)
    return trainer


if __name__ == "__main__":
    main()
