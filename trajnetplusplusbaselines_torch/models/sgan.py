"""Social GAN: a k-mode LSTM generator and an LSTM discriminator.

Port of ``trajnetplusplusbaselines_tpu/models/sgan.py`` (``get_noise``,
``LSTMGenerator``, ``LSTMDiscriminator``, ``SGAN``, ``SGANPredictor``):

- ``LSTMGenerator`` is the LSTM forecaster with a noise bottleneck between
  encoder and decoder: h -> [mlp(h) ++ z], with one noise vector z per
  rollout shared by every track of every scene of the batch;
  ``no_noise`` leaves h as it is;
- ``LSTMDiscriminator`` encodes observed ++ predicted positions with the
  same masked step and scores each scene's primary hidden state through an
  MLP that ends in a ReLU;
- ``SGAN.forward`` makes k generator rollouts (one in a discriminator step)
  and, given the truth, scores the real and the last mode's fake sequence.

The k rollouts fold into one batch: the encoder runs once over the S
scenes, its carry (a stateful pool's state with it) is repeated k times
along the scene axis (``DecoderStart.repeat``), and the decoder runs the k
modes as k * S scenes, mode m reading z[m].  The JAX package re-runs the
encoder for every mode; the encoder is deterministic, so the rollouts are
the same.  On the card a flagship rollout is then 19 launches of the fused
step at any k, not 19 k.

Randomness is explicit: ``noise`` [k, noise_dim] passed in wins; otherwise
it is drawn from the ``torch.Generator`` ``rng`` (torch's default one when
None).  The port cannot reproduce ``jax.random``, so the two packages agree
where the draws are pinned to the same values.
"""

from typing import Dict, Optional

import torch

from ..ops.core import init_lstm_cell, init_mlp, mlp
from ..ops.embeddings import init_hidden2normal, init_input_embedding
from .lstm import LSTM, compute_params, join_modes, mode_outputs, scene_batch, to_numpy


def get_noise(shape, noise_type: str, rng: Optional[torch.Generator] = None,
              dtype=torch.float32) -> torch.Tensor:
    """Gaussian or uniform on [-1, 1) noise of ``shape``, drawn on ``rng``'s
    device."""
    device = rng.device if rng is not None else None
    if noise_type == "gaussian":
        return torch.randn(shape, generator=rng, device=device, dtype=dtype)
    if noise_type == "uniform":
        return torch.rand(shape, generator=rng, device=device, dtype=dtype) * 2.0 - 1.0
    raise ValueError(f'Unrecognized noise type "{noise_type}"')


class LSTMGenerator(LSTM):
    def __init__(self, embedding_dim=64, hidden_dim=128, pool=None, pool_to_input=True,
                 goal_dim=None, goal_flag=False, noise_dim=8, no_noise=False,
                 noise_type="gaussian"):
        super().__init__(embedding_dim, hidden_dim, pool, pool_to_input, goal_dim, goal_flag)
        self.noise_dim = noise_dim
        self.no_noise = no_noise
        self.noise_type = noise_type

    def init_params(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> Dict:
        params = super().init_params(generator, device=device, dtype=dtype)
        params["mlp_decoder_context"] = init_mlp(
            generator, [self.hidden_dim, self.hidden_dim - self.noise_dim],
            device=device, dtype=dtype)
        return params

    def draw_noise(self, modes: int, rng: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
        """One noise vector per mode, ``[modes, noise_dim]``."""
        return get_noise((modes, self.noise_dim), self.noise_type, rng, dtype)

    def adding_noise(self, params: Dict, h: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """h ``[modes * S, A, H]`` -> ``[mlp(h) ++ noise[m]]`` in mode m's rows;
        h as it is under ``no_noise``."""
        if self.no_noise:
            return h
        modes = noise.shape[0]
        new_h = mlp(params["mlp_decoder_context"], h)  # [modes * S, A, H - noise_dim]
        z = noise.to(h)[:, None, None, :].expand(modes, h.shape[0] // modes, h.shape[1],
                                                 self.noise_dim)
        return torch.cat([new_h, z.reshape(h.shape[0], h.shape[1], self.noise_dim)], dim=-1)

    def forward(self, params: Dict, observed, observed_mask, prediction_truth=None,
                prediction_truth_mask=None, n_predict: Optional[int] = None, *,
                modes: int = 1, noise: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None, goals=None, slot_mask=None):
        """``modes`` rollouts, folded into one decoder batch, each
        teacher-forced on ``prediction_truth`` (+mask) or free for
        ``n_predict``; arguments as ``LSTM.forward``'s.  ``noise`` [modes,
        noise_dim] wins; else it is drawn from ``rng``.

        Returns (rel_pred [modes, T', S, A, 5], pred [modes, T', S, A, 2],
        valid [modes, T', S, A])."""
        x = self.inputs(params, observed, observed_mask, prediction_truth, prediction_truth_mask,
                        n_predict, goals=goals, slot_mask=slot_mask)
        route, weights = self.plan(params, ("encoder", "decoder"))
        carry, enc_normals, enc_masks, enc_positions = self.encode(
            params, self.init_carry(*x.observed.shape[1:3], device=x.observed.device,
                                    dtype=x.observed.dtype),
            x.observed, x.observed_mask, weights["encoder"], goals=x.goals,
            slot_mask=x.slot_mask, route=route,
        )
        start = self.start_decoder(carry, x, enc_positions, enc_masks).repeat(modes)
        if not self.no_noise:
            if noise is None:
                noise = self.draw_noise(modes, rng, x.observed.dtype)
            if tuple(noise.shape) != (modes, self.noise_dim):
                raise ValueError(f"noise must be [{modes}, {self.noise_dim}], "
                                 f"got {tuple(noise.shape)}")
            start = start.with_hidden(self.adding_noise(params, start.carry.h, noise))
        _, dec_normals, dec_masks, dec_positions = self.decode_from(params, start,
                                                                    weights["decoder"], route)
        return (join_modes(enc_normals, dec_normals, modes),
                join_modes(enc_positions, dec_positions, modes),
                join_modes(enc_masks, dec_masks, modes))


class LSTMDiscriminator(LSTM):
    """Encoder-only LSTM scoring the primary tracks of observed ++ predicted
    positions.  Its params have no ``decoder``."""

    def init_params(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        params = {
            "input_embedding": init_input_embedding(generator, 2, self.embedding_dim, **kw),
            "goal_embedding": init_input_embedding(generator, 2, self.goal_dim, **kw),
            "encoder": init_lstm_cell(generator, self.input_dim, self.hidden_dim, **kw),
            # unused by scoring, but the step reads the same weight set
            "hidden2normal": init_hidden2normal(generator, self.hidden_dim, **kw),
            "real_classifier": init_mlp(
                generator, [self.hidden_dim, self.hidden_dim // 2, self.hidden_dim // 4, 1], **kw),
        }
        if self.pool is not None:
            params["pool"] = self.pool.init_params(generator, **kw)
        return params

    def score(self, params: Dict, observed, observed_mask, prediction, prediction_mask, *,
              goals=None, slot_mask=None) -> torch.Tensor:
        """``[S]`` scores of each scene's primary track.  Positions that carry
        a gradient (a generator's rollout in a generator step) take the plain
        grid, which passes it on (``LSTM.route``)."""
        ref = params["encoder"]["w_ih"]
        xy = torch.cat([torch.as_tensor(p).to(ref) for p in (observed, prediction)])
        mask = torch.cat([torch.as_tensor(m).to(ref.device) for m in (observed_mask,
                                                                       prediction_mask)])
        x = self.place_inputs(params, xy, mask, goals=goals, slot_mask=slot_mask)
        route, weights = self.plan(params, ("encoder",), x.observed)
        carry, _, _, _ = self.encode(
            params, self.init_carry(*x.observed.shape[1:3], device=x.observed.device,
                                    dtype=x.observed.dtype),
            x.observed, x.observed_mask, weights["encoder"], goals=x.goals,
            slot_mask=x.slot_mask, route=route,
        )
        # the reference's make_mlp appends a ReLU after every layer, the last too
        return mlp(params["real_classifier"], carry.h[:, 0])[:, 0]


class SGAN:
    """A k-mode generator and a discriminator."""

    def __init__(self, generator: Optional[LSTMGenerator] = None,
                 discriminator: Optional[LSTMDiscriminator] = None,
                 k: int = 1, d_steps: int = 1, g_steps: int = 1):
        self.generator = generator if generator is not None else LSTMGenerator()
        self.discriminator = discriminator if discriminator is not None else LSTMDiscriminator()
        self.k = k
        self.d_steps = d_steps
        self.g_steps = g_steps

    @property
    def goal_flag(self) -> bool:
        return self.generator.goal_flag

    @property
    def compute_dtype(self):
        """The generator's compute dtype, which ``with_dtype`` gives both."""
        return self.generator.compute_dtype

    def with_dtype(self, dtype) -> "SGAN":
        self.generator.with_dtype(dtype)
        self.discriminator.with_dtype(dtype)
        return self

    def init_params(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> Dict:
        return {"generator": self.generator.init_params(generator, device, dtype),
                "discriminator": self.discriminator.init_params(generator, device, dtype)}

    def generate(self, params: Dict, observed, observed_mask, prediction_truth=None,
                 prediction_truth_mask=None, n_predict: Optional[int] = None, *,
                 modes: Optional[int] = None, noise: Optional[torch.Tensor] = None,
                 rng: Optional[torch.Generator] = None, goals=None, slot_mask=None):
        """``modes`` (default k) generator rollouts (``LSTMGenerator.forward``).
        ``prediction_truth`` (+mask) is the whole [pred_length, S, A, ...]
        future, of which the generator's chain drops the last frame, as the
        reference trims it: the decoder runs pred_length - 1 steps and the
        encoder gives the first predicted frame."""
        if prediction_truth is not None:
            prediction_truth = prediction_truth[:-1]
            prediction_truth_mask = prediction_truth_mask[:-1]
        return self.generator.forward(
            params["generator"], observed, observed_mask, prediction_truth,
            prediction_truth_mask, n_predict, modes=modes or self.k, noise=noise, rng=rng,
            goals=goals, slot_mask=slot_mask)

    def forward(self, params: Dict, observed, observed_mask, prediction_truth=None,
                prediction_truth_mask=None, n_predict: Optional[int] = None, *,
                step_type: str = "g", pred_length: int = 12, k: Optional[int] = None,
                noise: Optional[torch.Tensor] = None, rng: Optional[torch.Generator] = None,
                goals=None, slot_mask=None):
        """k rollouts (one for ``step_type="d"``, ``generate``) and, with the
        truth and a discriminator in play (``d_steps``), the discriminator's
        scores of the real future and of the last mode's rollout.

        Returns (rel_pred [k, T', S, A, 5], pred [k, T', S, A, 2], valid [k,
        T', S, A], scores_real [S] or None, scores_fake [S] or None)."""
        modes = 1 if step_type == "d" else (k or self.k)
        kw = dict(goals=goals, slot_mask=slot_mask)
        rel, pred, valid = self.generate(params, observed, observed_mask, prediction_truth,
                                         prediction_truth_mask, n_predict, modes=modes,
                                         noise=noise, rng=rng, **kw)
        scores_real = scores_fake = None
        if self.d_steps and prediction_truth is not None:
            scores_real = self.discriminator.score(params["discriminator"], observed,
                                                   observed_mask, prediction_truth,
                                                   prediction_truth_mask, **kw)
            scores_fake = self.discriminator.score(params["discriminator"], observed,
                                                   observed_mask, pred[-1][-pred_length:],
                                                   valid[-1][-pred_length:], **kw)
        return rel, pred, valid, scores_real, scores_fake


class SGANPredictor:
    """Path-level prediction API: paths in, ``{mode: [primary [n, 2],
    neighbours [n, Nn, 2] for mode 0, [] after]}`` out, one generator mode
    each, drawn from ``torch.Generator().manual_seed(seed)`` unless
    ``noise`` [modes, noise_dim] is given."""

    def __init__(self, model: SGAN, params: Dict):
        self.model = model
        self.params = params

    def __call__(self, paths, scene_goal, n_predict=12, modes=1, predict_all=True,
                 obs_length=9, start_length=0, args=None, seed=0, noise=None):
        (xy, mask, goals, slot_mask), finish = scene_batch(
            paths, scene_goal, obs_length, start_length, args, self.model.goal_flag)
        with torch.no_grad():
            _, pred, valid = self.model.generate(
                compute_params(self.model, self.params), torch.from_numpy(xy),
                torch.from_numpy(mask), n_predict=n_predict,
                modes=modes, noise=noise, rng=torch.Generator().manual_seed(seed),
                goals=torch.from_numpy(goals), slot_mask=torch.from_numpy(slot_mask))
        return mode_outputs(finish(to_numpy(pred), valid.cpu().numpy()), n_predict)
