"""The SGAN and the VAE of the port against the JAX package's.

At tiny widths (grid n 4, embedding 8, hidden 16, pool 16, noise 4,
latent 8) in float64, with the JAX package's params carried over by
``params_from_jax`` and inputs made by numpy from a seed: the generator's
rollouts (train and test), the discriminator's scores, ``SGAN.forward`` for
a generator and a discriminator step, ``VAE.forward`` in and out of
training with and without ``desire``, the batched predictor over scenes of
mixed agent buckets (the JAX package vmaps the SGAN's modes and loops over
the VAE's; the port folds them into one batch), and the path-level
predictors, all at 1e-8.

The port cannot reproduce ``jax.random``: both sides take the same numpy
draws, the port as tensors, the JAX package through ``KeyedDraws``, which
pins each draw by the key it is made with (so it holds under ``jit`` and
``vmap``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.data.rows import TrackRow
from trajnetplusplusbaselines_tpu.evaluator import learned as jlearned
from trajnetplusplusbaselines_tpu.models.sgan import SGANPredictor as JSGANPredictor
from trajnetplusplusbaselines_tpu.models.vae import VAEPredictor as JVAEPredictor
from trajnetplusplusbaselines_torch.data import Reader, batching
from trajnetplusplusbaselines_torch.evaluator.learned import BatchedPredictor, bucket_plan
from trajnetplusplusbaselines_torch.models.sgan import SGANPredictor
from trajnetplusplusbaselines_torch.models.vae import VAEPredictor

from .torch_parity import (
    TINY_LATENT,
    TINY_NOISE_DIM,
    KeyedDraws,
    jax_generative,
    key_chain,
    pool_batch,
    port_model,
)

TOL = 1e-8
K = 3


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got[np.isfinite(want)]).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _batch(seed=2):
    """``pool_batch``'s scenes for the JAX package and for the port."""
    arrays = pool_batch(seed=seed)
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


def _noise(seed=5, n=K):
    return np.random.default_rng(seed).normal(size=(n, TINY_NOISE_DIM))


@pytest.mark.parametrize("pool_type", ["directional", "nn_lstm"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_generator_matches_jax(mode, pool_type, monkeypatch):
    """K folded generator rollouts against K JAX rollouts, one per pinned
    noise vector."""
    jmodel, jparams, params = jax_generative("sgan", pool_type, seed=1)
    (xy, mask, goals, slot), (x, m, g, sl) = _batch()
    zs = _noise()
    keys = [jax.random.PRNGKey(10 + i) for i in range(K)]
    KeyedDraws(keys, list(zs)).pin_noise(monkeypatch)
    truth = dict(prediction_truth=xy[9:20], prediction_truth_mask=mask[9:20])
    kw = truth if mode == "train" else dict(n_predict=12)
    want = [jmodel.generator.forward(jparams["generator"], xy[:9], mask[:9], goals, slot,
                                     key=key, **kw) for key in keys]

    kw = dict(prediction_truth=x[9:20], prediction_truth_mask=m[9:20]) if mode == "train" \
        else dict(n_predict=12)
    with torch.set_grad_enabled(mode == "train"):
        got = port_model(jmodel).generator.forward(
            params["generator"], x[:9], m[:9], modes=K, noise=torch.from_numpy(zs), goals=g,
            slot_mask=sl, **kw)
    for i in range(K):
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[i][2]))
        _close(got[0][i], want[i][0])
        _close(got[1][i], want[i][1])
    assert float((got[1][0] - got[1][1]).abs().max()) > 1e-3  # the modes differ


@pytest.mark.parametrize("pool_type", ["directional", "nn_lstm"])
def test_discriminator_score_matches_jax(pool_type):
    jmodel, jparams, params = jax_generative("sgan", pool_type, seed=3)
    (xy, mask, goals, slot), (x, m, g, sl) = _batch(seed=4)
    want = jmodel.discriminator.score(jparams["discriminator"], xy[:9], mask[:9], xy[9:],
                                      mask[9:], goals, slot)
    got = port_model(jmodel).discriminator.score(params["discriminator"], x[:9], m[:9], x[9:],
                                                 m[9:], goals=g, slot_mask=sl)
    assert got.shape == (xy.shape[1],)
    _close(got, want)
    assert "decoder" not in params["discriminator"]


@pytest.mark.parametrize("step_type", ["g", "d"])
def test_sgan_forward_matches_jax(step_type, monkeypatch):
    """Rollouts (K, or one in a discriminator step) and both scores; the
    generator's chain drops the last truth frame."""
    jmodel, jparams, params = jax_generative("sgan", seed=5)
    (xy, mask, goals, slot), (x, m, g, sl) = _batch(seed=6)
    n = K if step_type == "g" else 1
    zs = _noise(seed=7, n=n)
    key = jax.random.PRNGKey(11)
    KeyedDraws(key_chain(key, n), list(zs)).pin_noise(monkeypatch)
    want = jmodel.forward(jparams, xy[:9], mask[:9], goals, slot, prediction_truth=xy[9:],
                          prediction_truth_mask=mask[9:], step_type=step_type, key=key)
    got = port_model(jmodel).forward(params, x[:9], m[:9], x[9:], m[9:], step_type=step_type,
                                     noise=torch.from_numpy(zs), goals=g, slot_mask=sl)
    assert len(got[0]) == len(want[0]) == n
    for i in range(n):
        assert got[0][i].shape[0] == 8 + 11
        _close(got[0][i], want[0][i])
        _close(got[1][i], want[1][i])
    _close(got[3], want[3])
    _close(got[4], want[4])


@pytest.mark.parametrize("desire", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_vae_forward_matches_jax(training, desire, monkeypatch):
    jmodel, jparams, params = jax_generative("vae", seed=7, desire=desire)
    (xy, mask, goals, slot), (x, m, g, sl) = _batch(seed=8)
    eps = np.random.default_rng(9).normal(size=(K, *xy.shape[1:3], TINY_LATENT))
    key = jax.random.PRNGKey(12)
    KeyedDraws(key_chain(key, K), list(eps)).pin_latent(monkeypatch, jmodel)
    if training:
        want = jmodel.forward(jparams, xy[:9], mask[:9], goals, slot, prediction_truth=xy[9:20],
                              prediction_truth_mask=mask[9:20], key=key, training=True)
        got = port_model(jmodel).forward(params, x[:9], m[:9], x[9:20], m[9:20], training=True,
                                         eps=torch.from_numpy(eps), goals=g, slot_mask=sl)
    else:
        want = jmodel.forward(jparams, xy[:9], mask[:9], goals, slot, n_predict=12, key=key,
                              training=False)
        with torch.no_grad():
            got = port_model(jmodel).forward(params, x[:9], m[:9], n_predict=12, training=False,
                                             eps=torch.from_numpy(eps), goals=g, slot_mask=sl)
    for i in range(K):
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2][i]))
        _close(got[0][i], want[0][i])
        _close(got[1][i], want[1][i])
    for j in (3, 4):  # the latent distributions, where they are made
        assert (got[j] is None) == (want[j] is None)
        if want[j] is not None:
            _close(got[j], want[j])
    assert (got[3] is None) != training and (got[4] is None) == desire


@pytest.mark.parametrize("kind", ["sgan", "vae"])
def test_folded_modes_are_the_separate_rollouts(kind):
    """Mode m of a folded rollout is the rollout of mode m's draw alone."""
    jmodel, _, params = jax_generative(kind, "nn_lstm", seed=13)
    model = port_model(jmodel)
    _, (x, m, g, sl) = _batch(seed=14)
    kw = dict(n_predict=12, goals=g, slot_mask=sl)
    if kind == "sgan":
        draws = torch.from_numpy(_noise(seed=15))
        run = lambda d, modes: model.generate(params, x[:9], m[:9], modes=modes, noise=d, **kw)
    else:
        draws = torch.randn(K, *x.shape[1:3], TINY_LATENT, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(15))
        run = lambda d, modes: model.forward(params, x[:9], m[:9], training=False, modes=modes,
                                             eps=d, **kw)[:3]
    with torch.no_grad():
        folded = run(draws, K)
        for i in range(K):
            alone = run(draws[i:i + 1], 1)
            for f, a in zip(folded, alone):
                torch.testing.assert_close(f[i], a[0], atol=1e-12, rtol=0)


def _scene_paths(rng, n_agents, t=9):
    xy = rng.normal(size=(t, n_agents, 2)).cumsum(axis=0) * 0.3
    paths = []
    for p in range(n_agents):
        first = int(rng.integers(0, 4)) if p else 0
        paths.append([TrackRow(10 * f, p + 1, float(xy[f, p, 0]), float(xy[f, p, 1]))
                      for f in range(first, t)])
    return paths


def _pinned_chunks(kind, jmodel, n_chunks, monkeypatch, seed=0):
    """Each chunk's draws of a batched predictor that starts at ``seed``,
    pinned for the JAX package (chunk c draws with the key of seed c); the
    port's per seed."""
    rng = np.random.default_rng(21)
    keys, values, port = [], [], {}
    for c in range(seed + 1, seed + n_chunks + 1):
        if kind == "sgan":  # vmapped over split(key, K)
            zs = rng.normal(size=(K, TINY_NOISE_DIM))
            keys += list(np.asarray(jax.random.split(jax.random.PRNGKey(c), K)))
            values += list(zs)
            port[c] = torch.from_numpy(zs)
        else:  # looped over the key chain, up to 4 scenes of 8 agents
            eps = rng.normal(size=(K, 4, 8, TINY_LATENT))
            keys += key_chain(jax.random.PRNGKey(c), K)
            values += list(eps)
            port[c] = torch.from_numpy(eps)
    draws = KeyedDraws(keys, values)
    if kind == "sgan":
        draws.pin_noise(monkeypatch)
    else:
        draws.pin_latent(monkeypatch, jmodel)
    return port


@pytest.mark.parametrize("pool_type", ["directional", "nn_lstm"])
@pytest.mark.parametrize("kind", ["sgan", "vae"])
def test_batched_predictor_matches_jax(kind, pool_type, monkeypatch):
    """Buckets 4 and 8 in three chunks, the last one padded: K folded modes
    against the JAX package's vmapped (SGAN) or looped (VAE) modes."""
    monkeypatch.setattr(jlearned, "_SHARED_PROGRAMS", {})
    jmodel, jparams, params = jax_generative(kind, pool_type, seed=17)
    rng = np.random.default_rng(18)
    scenes = [_scene_paths(rng, n) for n in (2, 3, 5, 7, 3)]
    goals = [np.zeros((len(s), 2)) for s in scenes]
    args = types.SimpleNamespace(pred_length=12, obs_length=9)
    plan = bucket_plan([len(s) for s in scenes], 2)
    assert len(plan) == 3
    draws = _pinned_chunks(kind, jmodel, len(plan), monkeypatch)

    jpredictor = (JSGANPredictor if kind == "sgan" else JVAEPredictor)(jmodel, jparams)
    want = jlearned.BatchedPredictor(jpredictor, modes=K, batch_scenes=2).predict_dataset(
        scenes, goals, args)
    predictor = (SGANPredictor if kind == "sgan" else VAEPredictor)(port_model(jmodel), params)
    batched = BatchedPredictor(predictor, modes=K, batch_scenes=2, device="cpu")
    batched.draws = lambda s, a: draws[batched.seed] if kind == "sgan" \
        else draws[batched.seed][:, :s, :a]
    got = batched.predict_dataset(scenes, goals, args)

    assert batched.seed == len(plan)
    for g, w, paths in zip(got, want, scenes):
        assert sorted(g) == sorted(w) == list(range(K))
        _close(g[0][1], w[0][1])
        for mode in range(K):
            assert g[mode][0].shape == (12, 2)
            _close(g[mode][0], w[mode][0])
            assert mode == 0 or len(g[mode][1]) == len(w[mode][1]) == 0
    assert np.abs(got[0][0][0] - got[0][1][0]).max() > 1e-3


@pytest.mark.parametrize("kind", ["sgan", "vae"])
def test_predictors_match_jax(kind, monkeypatch):
    """The path-level predictors on one scene, under ``normalize_scene``."""
    jmodel, jparams, params = jax_generative(kind, seed=19)
    paths = _scene_paths(np.random.default_rng(20), 5)
    args = types.SimpleNamespace(normalize_scene=True)
    key_of_seed = jax.random.PRNGKey(4)
    if kind == "sgan":
        zs = _noise(seed=22)
        KeyedDraws(key_chain(key_of_seed, K), list(zs)).pin_noise(monkeypatch)
        want = JSGANPredictor(jmodel, jparams)(paths, np.zeros((5, 2)), modes=K, args=args,
                                               seed=4)
        got = SGANPredictor(port_model(jmodel), params)(paths, np.zeros((5, 2)), modes=K,
                                                        args=args, noise=torch.from_numpy(zs))
    else:
        a = batching.pack_scenes([Reader.paths_to_xy(paths)]).max_agents
        eps = np.random.default_rng(22).normal(size=(K, 1, a, TINY_LATENT))
        KeyedDraws(key_chain(key_of_seed, K), list(eps)).pin_latent(monkeypatch, jmodel)
        want = JVAEPredictor(jmodel, jparams)(paths, np.zeros((5, 2)), modes=K, args=args,
                                              seed=4)
        got = VAEPredictor(port_model(jmodel), params)(paths, np.zeros((5, 2)), modes=K,
                                                       args=args, eps=torch.from_numpy(eps))
    assert sorted(got) == sorted(want) == list(range(K))
    _close(got[0][1], want[0][1])
    for mode in range(K):
        _close(got[mode][0], want[mode][0])
        assert mode == 0 or len(got[mode][1]) == 0
