"""Command-line VAE trainer.

Port of ``trajnetplusplusbaselines_tpu/trainers/vae.py``: the LSTM trainer's
flags (``trainers/lstm.add_arguments``) and the VAE's (``--alpha_kld``,
``--k``, ``--vae_latent_dim``), ``--device`` (default ``cuda``, raising where
no card is present), output naming (``OUTPUT_BLOCK/<path>/vae_<type>_<o>.pkl``,
``vae_goals_...`` with goals), JSON logs and the pickle with its ``.state``
sidecar.

A train step is the reconstruction loss (each mode's primary-only
criterion x batch size, averaged over the k teacher-forced modes) plus
``alpha_kld`` times the KL divergence of the primaries' posterior (x batch
size) against the standard normal, with one Adam (weight decay 1e-4, the
optional clip) and a StepLR schedule; the logged train loss is the
reconstruction, as in the JAX package.  Validation computes the same loss
in training mode (prediction encoder and posterior) without autograd.  The
latent normals come from the trainer's ``torch.Generator``.

On the card a directional grid's train step launches the grid stage 30
times (8 encoder, 11 prediction-encoder and 11 decoder steps; the k modes
decode as one batch); validation records no autograd, so a flagship VAE
takes the fused step there, 30 launches per batch.

``--bf16`` and ``--remat`` as in the LSTM trainer; ``--obs_dropout``
trains the JAX trainer's host path: batches packed on the host
(augmentation from the numpy generator) in their shuffled order, one
``start_length`` drawn after each, validation from frame 0;
``--load-full-state`` takes a JAX sidecar's optax state; ``--dp`` / ``--tp``
as in the LSTM trainer: the latent normals of the whole batch are drawn on
every rank (the one-process draw) and each rank takes its scenes' rows.
``--orbax`` is refused as the LSTM trainer refuses it.

Usage:
    python -m trajnetplusplusbaselines_torch.trainers.vae --path trajdata \
        --type directional --k 3 --device cuda
"""

import argparse
import time

import torch

from ..losses import kld_loss, l2_loss, prediction_loss
from ..models.vae import VAE, VAEPredictor
from ..ops.pooling import make_pool
from .common import optimizer_step, packed_batch, step_lr
from . import lstm as lstm_trainer


class Trainer(lstm_trainer.Trainer):
    """Trains a ``VAE``; the LSTM trainer's loop, batches and checkpoints."""

    predictor_class = VAEPredictor
    capturable_adam = False  # its own ``train_step`` is eager: ``make_optimizer``'s Adam
    # rel_pred, pred, valid [k, T', S, A, ...], z_distr_xy and z_distr_x [S, A, 2 latent]
    output_scene_dims = (2, 2, 2, 0, 0)

    def __init__(self, model: VAE, params, lr_schedule, alpha_kld: float = 1.0, **kwargs):
        super().__init__(model, params, lr_schedule, **kwargs)
        self.alpha_kld = alpha_kld

    def losses(self, xy, mask, scene_mask, goals=None, slot_mask=None, *, eps=None,
               start_length=None):
        """(reconstruction, KL divergence) of one batch in training mode.
        eps [k, S, A, latent], else drawn; ``start_length``, the trainer's by
        default."""
        sl = self.start_length if start_length is None else start_length
        if eps is None:  # the whole batch's draw, of which a rank runs its rows
            eps = self.model.draw_eps(self.model.num_modes, *xy.shape[1:3], self.generator,
                                      self.compute_dtype or self.leaves[0].dtype)
        rel, _, _, z_xy, z_x = self._forward(
            self.params, xy, mask, sl,
            prediction_truth=xy[self.obs_length:self.seq_length - 1],
            prediction_truth_mask=mask[self.obs_length:self.seq_length - 1],
            training=True, eps=eps, rng=self.generator, goals=goals, slot_mask=slot_mask)
        targets = (xy[self.obs_length:self.seq_length, :, 0]
                   - xy[self.obs_length - 1:self.seq_length - 1, :, 0])
        loss = l2_loss if self.criterion == "L2" else prediction_loss
        reconstr = sum(loss(r[-self.pred_length:, :, 0], targets, scene_mask) * self.batch_size
                       for r in rel) / self.model.num_modes
        kld = kld_loss(z_xy[:, 0], z_x[:, 0] if z_x is not None else None) * self.batch_size
        return reconstr, kld

    def loss_and_grads(self, xy, mask, scene_mask, goals=None, slot_mask=None, *, eps=None,
                       start_length=None):
        """(reconstruction + alpha_kld KLD, reconstruction, the gradient of
        the first for every leaf)."""
        reconstr, kld = self.losses(xy, mask, scene_mask, goals, slot_mask, eps=eps,
                                    start_length=start_length)
        loss = reconstr + self.alpha_kld * kld
        grads = torch.autograd.grad(loss, self.leaves, materialize_grads=True)
        return loss.detach(), reconstr.detach(), self._summed(grads)

    def train_step(self, xy, mask, scene_mask, goals=None, slot_mask=None, start_length=None):
        """One optimizer step on one batch; returns the reconstruction loss,
        on the device."""
        _, reconstr, grads = self.loss_and_grads(xy, mask, scene_mask, goals, slot_mask,
                                                 start_length=start_length)
        optimizer_step(self.optimizer, self.leaves, grads, self.clip_grad, split=self.split,
                       mesh=self.mesh)
        return reconstr

    def _train_obs_dropout(self, scenes, epoch: int):
        """``--obs_dropout``'s epoch as the JAX VAE trainer runs it: the
        host-packed batches in their shuffled order, one ``start_length``
        drawn after each.  Returns the losses, on the device."""
        losses, start_lengths = [], []
        for packed in scenes.epoch_batches(self.batch_size, self.rng, self.augment,
                                           self.augment_noise):
            start_lengths.append(int(self.rng.integers(0, self.obs_length - 1)))
            losses.append(self.train_step(*packed_batch(packed, self.device),
                                          start_length=start_lengths[-1]))
        self.log.info({"type": "obs-dropout", "epoch": epoch, "start_lengths": start_lengths})
        return losses

    def val(self, scenes, epoch: int):
        eval_start = time.time()
        resident = self._get_resident(scenes)
        plan = resident.epoch_plan(self.batch_size, self.rng, shuffle=False)
        sl = 0 if self.obs_dropout else self.start_length
        val_losses = []
        with torch.no_grad():
            for batch in self._batches(resident, plan):
                reconstr, kld = self.losses(*batch, start_length=sl)
                val_losses.append(reconstr + self.alpha_kld * kld)
        val_loss = float(torch.stack(val_losses).sum()) if val_losses else 0.0
        self.log.info({
            "type": "val-epoch",
            "epoch": epoch + 1,
            "loss": round(val_loss / max(len(scenes), 1), 3),
            "time": round(time.time() - eval_start, 1),
        })


def main(epochs=25, argv=None):
    """Train from the command line; returns the ``Trainer``."""
    parser = argparse.ArgumentParser()
    lstm_trainer.add_arguments(parser, epochs)
    vae = parser.add_argument_group("vae")
    vae.add_argument("--alpha_kld", type=float, default=1.0)
    vae.add_argument("--k", type=int, default=1, help="number of decoded modes")
    vae.add_argument("--vae_latent_dim", type=int, default=128,
                     help="latent dimension of the VAE bottleneck")
    args = parser.parse_args(argv)
    device = lstm_trainer.join_ranks(args, lstm_trainer.check_device(args),
                                     "trajnetplusplusbaselines_torch.trainers.vae")
    mesh = lstm_trainer.run_mesh(args, device)
    pool = make_pool(args.type, args)
    lstm_trainer.open_run(args, "vae_goals" if args.goals else "vae")
    train_ds, val_ds, val_flag = lstm_trainer.read_splits(args)

    model = lstm_trainer.configure(
        VAE(embedding_dim=args.coordinate_embedding_dim, hidden_dim=args.hidden_dim, pool=pool,
            goal_flag=args.goals, goal_dim=args.goal_dim, num_modes=args.k,
            latent_dim=args.vae_latent_dim), args)
    params = model.init_params(torch.Generator().manual_seed(args.seed), device=device)
    params, state = lstm_trainer.load_params(args, params, device)

    trainer = Trainer(
        model, params, step_lr(args.lr, args.step_size), alpha_kld=args.alpha_kld,
        criterion=args.loss, batch_size=args.batch_size, obs_length=args.obs_length,
        pred_length=args.pred_length, augment=args.augment, save_every=args.save_every,
        start_length=args.start_length, augment_noise=args.augment_noise, val_flag=val_flag,
        seed=args.seed, clip_grad=args.clip_grad, obs_dropout=args.obs_dropout, mesh=mesh,
    )
    start_epoch = 0
    if args.load_full_state:
        lstm_trainer.restore_optimizer(trainer.optimizer, trainer.paths, state["opt_state"],
                                       trainer._block())
        start_epoch = state["epoch"]
    trainer.loop(train_ds, val_ds, args.output, epochs=args.epochs, start_epoch=start_epoch)
    return trainer


if __name__ == "__main__":
    main()
