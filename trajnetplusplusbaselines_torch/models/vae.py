"""VAE trajectory forecaster (a DESIRE-style conditional VAE).

Port of ``trajnetplusplusbaselines_tpu/models/vae.py`` (``VAE``,
``VAEPredictor``):

- the observation encoder and, in training, a prediction encoder over the
  teacher-forcing chain share the masked step; the VAE encoder maps [h_obs
  ++ h_pred] to (z_mu, log variance) with the reference's ReLU floors,
  ``0.01 + relu`` on the log variance;
- a latent sample gates the decoder's hidden state: h <- h * relu(W z);
- with ``desire`` (the reference's default) the test-time sample has mu = 0
  and LOG-variance 1, i.e. variance e, an upstream quirk kept for parity;
- k modes decode from k latent samples; the encoder's normals are shared.

The k modes fold into one decoder batch of k * S scenes, as in
``models/sgan.py``: the encoders run once, and on the card a flagship
rollout is 19 launches of the fused step at any k (30 with the prediction
encoder, in training or validation).

Randomness is explicit: ``eps`` [k, S, A, latent], the standard-normal draw
of each mode, passed in wins; otherwise it is drawn from the
``torch.Generator`` ``rng``.
"""

from typing import Dict, Optional

import torch

from ..ops.core import init_lstm_cell, init_linear, linear
from .lstm import LSTM, compute_params, join_modes, mode_outputs, scene_batch, to_numpy


class VAE(LSTM):
    def __init__(self, embedding_dim=64, hidden_dim=128, pool=None, pool_to_input=True,
                 goal_dim=None, goal_flag=False, num_modes=1, latent_dim=128, desire=True):
        super().__init__(embedding_dim, hidden_dim, pool, pool_to_input, goal_dim, goal_flag)
        self.num_modes = num_modes
        self.latent_dim = latent_dim
        self.desire = desire

    def init_params(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        params = super().init_params(generator, **kw)
        params["pred_encoder"] = init_lstm_cell(generator, self.input_dim, self.hidden_dim, **kw)
        h, latent = self.hidden_dim, self.latent_dim
        params["vae_encoder_xy"] = {"fc_mu": init_linear(generator, 2 * h, latent, **kw),
                                    "fc_var": init_linear(generator, 2 * h, latent, **kw)}
        params["vae_encoder_x"] = {"fc_mu": init_linear(generator, h, latent, **kw),
                                   "fc_var": init_linear(generator, h, latent, **kw)}
        params["vae_decoder"] = init_linear(generator, latent, h, **kw)
        return params

    @staticmethod
    def vae_encode(enc_params: Dict, inputs: torch.Tensor):
        """(z_mu, z_log_var) with the reference's ReLU floors."""
        z_mu = torch.relu(linear(enc_params["fc_mu"], inputs))
        z_log_var = 0.01 + torch.relu(linear(enc_params["fc_var"], inputs))
        return z_mu, z_log_var

    @staticmethod
    def sample_latent(z_mu, z_log_var, eps, training: bool) -> torch.Tensor:
        """z from the standard-normal draw ``eps``: reparametrised in training;
        at test time ``eps * exp(log_var / 2)``, mu unused, as the reference
        samples it."""
        if training:
            return z_mu + torch.exp(0.5 * z_log_var) * eps
        return eps * torch.exp(0.5 * z_log_var)

    def draw_eps(self, modes: int, num_scenes: int, num_agents: int,
                 rng: Optional[torch.Generator] = None, dtype=torch.float32) -> torch.Tensor:
        """Each mode's standard-normal draw, ``[modes, S, A, latent]``, on
        ``rng``'s device."""
        device = rng.device if rng is not None else None
        return torch.randn((modes, num_scenes, num_agents, self.latent_dim), generator=rng,
                           device=device, dtype=dtype)

    def forward(self, params: Dict, observed, observed_mask, prediction_truth=None,
                prediction_truth_mask=None, n_predict: Optional[int] = None, *,
                training: Optional[bool] = None, modes: Optional[int] = None,
                eps: Optional[torch.Tensor] = None, rng: Optional[torch.Generator] = None,
                goals=None, slot_mask=None):
        """``modes`` (default ``num_modes``) decoded modes, folded into one
        decoder batch; arguments as ``LSTM.forward``'s.  ``training``
        (default: truth given) runs the prediction encoder over the
        teacher-forcing chain and samples the posterior; else the prior.
        ``eps`` [modes, S, A, latent] wins; else it is drawn from ``rng``.

        Returns (rel_pred [modes, T', S, A, 5], pred [modes, T', S, A, 2],
        valid [modes, T', S, A], z_distr_xy [S, A, 2 latent] (training) or
        None, z_distr_x [S, A, 2 latent] (without ``desire``) or None)."""
        x = self.inputs(params, observed, observed_mask, prediction_truth, prediction_truth_mask,
                        n_predict, goals=goals, slot_mask=slot_mask)
        training = x.truth is not None if training is None else training
        modes = modes or self.num_modes
        s, a = x.observed.shape[1:3]
        cells = ("encoder", "decoder") + (("pred_encoder",) if training else ())
        route, weights = self.plan(params, cells)
        kw = dict(goals=x.goals, slot_mask=x.slot_mask, route=route)
        carry_0 = dict(device=x.observed.device, dtype=x.observed.dtype)
        carry, enc_normals, enc_masks, enc_positions = self.encode(
            params, self.init_carry(s, a, **carry_0), x.observed, x.observed_mask,
            weights["encoder"], **kw)
        start = self.start_decoder(carry, x, enc_positions, enc_masks)

        z_distr_xy = z_distr_x = None
        if training:
            # the prediction encoder: the encoder's step with its own cell
            pred_carry, _, _, _ = self.encode(params, self.init_carry(s, a, **carry_0),
                                              start.truth, start.truth_mask,
                                              weights["pred_encoder"], **kw)
            z_mu, z_log_var = self.vae_encode(params["vae_encoder_xy"],
                                              torch.cat([carry.h, pred_carry.h], dim=-1))
            z_distr_xy = torch.cat([z_mu, z_log_var], dim=-1)
        if not self.desire:
            z_mu_obs, z_log_var_obs = self.vae_encode(params["vae_encoder_x"], carry.h)
            z_distr_x = torch.cat([z_mu_obs, z_log_var_obs], dim=-1)
        elif not training:
            z_mu_obs = torch.zeros((s, a, self.latent_dim), **carry_0)
            z_log_var_obs = torch.ones((s, a, self.latent_dim), **carry_0)

        if eps is None:
            eps = self.draw_eps(modes, s, a, rng, x.observed.dtype)
        if tuple(eps.shape) != (modes, s, a, self.latent_dim):
            raise ValueError(f"eps must be [{modes}, {s}, {a}, {self.latent_dim}], "
                             f"got {tuple(eps.shape)}")
        eps = eps.to(carry.h)
        z = (self.sample_latent(z_mu, z_log_var, eps, True) if training
             else self.sample_latent(z_mu_obs, z_log_var_obs, eps, False))
        gate = torch.relu(linear(params["vae_decoder"], z))  # [modes, S, A, H]
        start = start.repeat(modes)
        start = start.with_hidden(start.carry.h * gate.reshape(modes * s, a, self.hidden_dim))

        _, dec_normals, dec_masks, dec_positions = self.decode_from(params, start,
                                                                    weights["decoder"], route)
        return (join_modes(enc_normals, dec_normals, modes),
                join_modes(enc_positions, dec_positions, modes),
                join_modes(enc_masks, dec_masks, modes), z_distr_xy, z_distr_x)


class VAEPredictor:
    """Path-level prediction API: paths in, ``{mode: [primary [n, 2],
    neighbours [n, Nn, 2] for mode 0, [] after]}`` out, one prior sample
    each, drawn from ``torch.Generator().manual_seed(seed)`` unless ``eps``
    [modes, 1, A, latent] is given."""

    def __init__(self, model: VAE, params: Dict):
        self.model = model
        self.params = params

    def __call__(self, paths, scene_goal, n_predict=12, modes=1, predict_all=True,
                 obs_length=9, start_length=0, args=None, seed=0, eps=None):
        (xy, mask, goals, slot_mask), finish = scene_batch(
            paths, scene_goal, obs_length, start_length, args, self.model.goal_flag)
        with torch.no_grad():
            _, pred, valid, _, _ = self.model.forward(
                compute_params(self.model, self.params), torch.from_numpy(xy),
                torch.from_numpy(mask), n_predict=n_predict,
                training=False, modes=modes, eps=eps, rng=torch.Generator().manual_seed(seed),
                goals=torch.from_numpy(goals), slot_mask=torch.from_numpy(slot_mask))
        return mode_outputs(finish(to_numpy(pred), valid.cpu().numpy()), n_predict)
