"""The port's Kalman-filter predictor against the JAX package, in f64 on the
CPU: the filter, the smoother and an EM step batched over tracks of mixed
valid lengths against JAX's under ``vmap``; the 10-step fit; ``predict``
given JAX's own normals and sampler factors; the folded
``predict_dataset`` against the per-scene ``predict``; the sampler's mean
against the deterministic propagation; and a scene above 128 agents."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.data.batching import agent_bucket
from trajnetplusplusbaselines_tpu.models.classical import kalman as jkf
from trajnetplusplusbaselines_torch.data.rows import TrackRow
from trajnetplusplusbaselines_torch.models.classical import kalman

from .torch_parity import classical_scene, observed


def tracks(seed, n=12, t=9):
    """Random-walk tracks [n, t, 2] with valid prefixes of 2..t steps, the
    masked tail zeros, as ``kalman.scene_tracks`` makes them."""
    rng = np.random.default_rng(seed)
    ys = rng.uniform(-5, 5, size=(n, 1, 2)) + rng.normal(scale=0.3, size=(n, t, 2)).cumsum(axis=1)
    lengths = np.concatenate([[t, 2], rng.integers(2, t + 1, size=n - 2)])
    mask = np.arange(t)[None, :] < lengths[:, None]
    return np.where(mask[..., None], ys, 0.0), mask


def generic_params(seed, n):
    """Per-track (Q, R, mu0, Sigma0), symmetric positive definite and generic."""
    rng = np.random.default_rng(seed)

    def spd(d, scale):
        m = rng.normal(size=(n, d, d))
        return scale * (m @ np.swapaxes(m, -1, -2) + d * np.eye(d))

    return spd(4, 1e-3), spd(2, 1e-2), rng.normal(size=(n, 4)), spd(4, 0.5)


def port_params(q, r, mu0, sigma0):
    return kalman.KFParams(*(torch.from_numpy(x) for x in (q, r, mu0, sigma0)))


@functools.lru_cache(maxsize=None)
def _jax_fit():
    """JAX's fit of one track, as ``kf_fit_and_predict`` makes it (the
    initial params, the ``fori_loop`` of EM steps, the smoothed last state),
    with the sampler's factors, vmapped over tracks and jitted."""

    def fit(ys, mask):
        first = ys[0]
        mu0 = jnp.array([first[0], 0.0, first[1], 0.0])
        params = jkf.KFParams(1e-5 * jnp.eye(4), 0.05 ** 2 * jnp.eye(2), mu0, jnp.eye(4))
        params = jax.lax.fori_loop(0, 10, lambda _, p: jkf.kf_em_step(p, ys, mask), params)
        xs, _, _ = jkf.kf_smooth(params, *jkf.kf_filter(params, ys, mask))
        x_last = xs[jnp.maximum(jnp.sum(mask.astype(jnp.int32)) - 1, 0)]

        def psd_factor(m):
            w, v = jnp.linalg.eigh(m)
            return v * jnp.sqrt(jnp.clip(w, 0.0, None))[None, :]

        return params, x_last, psd_factor(params.q), psd_factor(params.r)

    return jax.jit(jax.vmap(fit))


def jax_normals(seed, n_pad, n, n_predict=12, n_samples=5):
    """The normals JAX's ``predict`` draws for the first ``n`` of ``n_pad``
    tracks (``kalman.py:164-178``): the track's key from ``split(PRNGKey(seed),
    n_pad)``, a key per sample, a key per step, split into the state's 4 and
    the observation's 2 normals.  [n, n_samples, n_predict, 6]."""

    def per_step(k):
        k1, k2 = jax.random.split(k)
        return jnp.concatenate([jax.random.normal(k1, (4,)), jax.random.normal(k2, (2,))])

    def per_track(key):
        samples = jax.random.split(key, n_samples)
        return jax.vmap(lambda k: jax.vmap(per_step)(jax.random.split(k, n_predict)))(samples)

    keys = jax.random.split(jax.random.PRNGKey(seed), n_pad)[:n]
    return np.array(jax.vmap(per_track)(keys))


def test_filter_smoother_and_em_step_match_jax_under_vmap():
    ys, mask = tracks(0)
    params = generic_params(1, len(ys))
    jparams = jkf.KFParams(*(jnp.asarray(x) for x in params))
    jys, jmask = jnp.asarray(ys), jnp.asarray(mask)
    pparams, pys, pmask = port_params(*params), torch.from_numpy(ys), torch.from_numpy(mask)

    want = jax.jit(jax.vmap(jkf.kf_filter))(jparams, jys, jmask)
    got = kalman.kf_filter(pparams, pys, pmask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)

    want_s = jax.jit(jax.vmap(jkf.kf_smooth))(jparams, *want)
    got_s = kalman.kf_smooth(pparams, *got)
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)

    want_em = jax.jit(jax.vmap(jkf.kf_em_step))(jparams, jys, jmask)
    got_em = kalman.kf_em_step(pparams, pys, pmask)
    for g, w in zip(got_em, want_em):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_fit_matches_jax_fori_loop():
    """The 10-step EM fit and the smoothed last state at 1e-8 relative: ten
    iterations of inversions compound the last-bit differences of two LU
    implementations (each step is held at 1e-10 above)."""
    ys, mask = tracks(2, n=16)
    jparams, jx_last, _, _ = _jax_fit()(jnp.asarray(ys), jnp.asarray(mask))
    params, x_last = kalman.kf_fit(torch.from_numpy(ys), torch.from_numpy(mask))
    for g, w in zip((*params, x_last), (*jparams, jx_last)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-8 * np.abs(w).max())


def test_predict_with_jax_normals_and_factors_matches_jax():
    """The port's ``predict`` given the normals JAX draws and the factors JAX
    computes (its own key-split scheme and eigh) gives JAX's ``predict``
    within 1e-8 m, non-qualifying agents skipped alike."""
    rng = np.random.default_rng(3)
    paths = observed(classical_scene(rng, 6))
    # one agent first seen at the last observed frame, one gone before it
    paths += [[TrackRow(80, 98, 1.0, 2.0)], [TrackRow(f, 99, 0.1 * f, 3.0) for f in (0, 10, 20)]]
    ys, mask = kalman.scene_tracks(paths)
    assert 2 < len(ys) <= len(paths) - 2
    _, _, q_factor, r_factor = _jax_fit()(jnp.asarray(ys), jnp.asarray(mask))
    normals = jax_normals(5, agent_bucket(len(ys)), len(ys))

    want = jkf.predict(paths, seed=5)
    got = kalman.predict(paths, normals=normals, factors=(np.array(q_factor), np.array(r_factor)),
                         device="cpu")
    np.testing.assert_allclose(got[0][0], np.asarray(want[0][0]), rtol=0, atol=1e-8)
    assert got[0][1].shape == (12, len(ys) - 1, 2)
    np.testing.assert_allclose(got[0][1], np.asarray(want[0][1]), rtol=0, atol=1e-8)
    assert kalman.predict(paths, predict_all=False, device="cpu")[0][1] == []


def test_predict_dataset_is_the_per_scene_predict():
    """The folded fit over all tracks of all scenes gives each scene what its
    own ``predict`` gives it, on the same normals (1e-12)."""
    rng = np.random.default_rng(4)
    scenes = [observed(classical_scene(rng, n, scene_id=i)) for i, n in enumerate((1, 3, 6, 2, 9))]
    counts = [len(kalman.scene_tracks(paths)[0]) for paths in scenes]
    normals = rng.normal(size=(sum(counts), 5, 12, 6))
    got = kalman.predict_dataset(scenes, normals=normals, device="cpu")
    start = 0
    for paths, n, out in zip(scenes, counts, got):
        want = kalman.predict(paths, normals=normals[start:start + n], device="cpu")
        start += n
        np.testing.assert_allclose(out[0][0], want[0][0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(out[0][1], want[0][1], rtol=0, atol=1e-12)
        assert np.asarray(out[0][1]).shape == np.asarray(want[0][1]).shape

    # drawn from one generator per fit: seeded, so repeatable
    first = kalman.predict_dataset(scenes, seed=7, device="cpu")
    again = kalman.predict_dataset(scenes, seed=7, device="cpu")
    for a, b in zip(first, again):
        assert np.array_equal(a[0][0], b[0][0]) and np.isfinite(a[0][0]).all()


def test_fold_is_chunked_to_the_memory_budget(monkeypatch):
    """Above ``TRACKS_PER_FIT`` tracks the fold runs in several fits, each
    track's result unchanged (same normals)."""
    rng = np.random.default_rng(6)
    scenes = [observed(classical_scene(rng, 4, scene_id=i)) for i in range(3)]
    n = sum(len(kalman.scene_tracks(paths)[0]) for paths in scenes)
    normals = rng.normal(size=(n, 5, 12, 6))
    whole = kalman.predict_dataset(scenes, normals=normals, device="cpu")
    monkeypatch.setattr(kalman, "TRACKS_PER_FIT", 5)
    chunked = kalman.predict_dataset(scenes, normals=normals, device="cpu")
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a[0][0], b[0][0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(a[0][1], b[0][1], rtol=0, atol=1e-12)


def test_sampler_mean_is_the_deterministic_propagation():
    """Over M = 4,000 samples, the mean of each predicted step k lies within
    5 standard errors of C A^k x_last, the standard error sqrt(diag(C P_k
    C^T + R) / M) with P_k = sum_{j<k} A^j Q A^jT (Q = F F^T, R = G G^T of
    the factors); and F F^T = Q, G G^T = R."""
    ys, mask = tracks(7, n=3)
    ys_t, mask_t = torch.from_numpy(ys), torch.from_numpy(mask)
    params, x_last = kalman.kf_fit(ys_t, mask_t)
    q_factor, r_factor = kalman.psd_factor(params.q), kalman.psd_factor(params.r)
    torch.testing.assert_close(q_factor @ q_factor.mT, params.q, rtol=0, atol=1e-12)
    torch.testing.assert_close(r_factor @ r_factor.mT, params.r, rtol=0, atol=1e-12)
    m = 4000
    normals = torch.randn(len(ys), m, 12, 6, generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64)
    mean = kalman.kf_sample(x_last, q_factor, r_factor, normals).numpy()

    a, c, _ = (x.numpy() for x in kalman._models(ys_t))
    q, r = (q_factor @ q_factor.mT).numpy(), (r_factor @ r_factor.mT).numpy()
    x, cov = x_last.numpy(), np.zeros_like(q)
    for k in range(12):
        x = x @ a.T
        cov = a @ cov @ a.T + q
        var = np.diagonal(c @ cov @ c.T + r, axis1=-2, axis2=-1)
        err = np.abs(mean[:, k] - x @ c.T)
        assert (err < 5 * np.sqrt(var / m)).all(), (k, err, np.sqrt(var / m))


def test_scene_above_128_agents():
    """The port predicts a 140-agent scene (JAX's ``predict`` pads the agent
    axis to at most 128 and raises on it)."""
    rng = np.random.default_rng(8)
    xy = rng.uniform(-8, 8, size=(1, 140, 2)) + rng.normal(scale=0.3, size=(9, 140, 2)).cumsum(0)
    paths = [[TrackRow(10 * f, p + 1, *map(float, xy[f, p])) for f in range(p % 4, 9)]
             for p in range(140)]
    assert len(kalman.scene_tracks(paths)[0]) == 140
    out = kalman.predict(paths, device="cpu")
    assert out[0][0].shape == (12, 2) and out[0][1].shape == (12, 139, 2)
    assert np.isfinite(out[0][0]).all() and np.isfinite(out[0][1]).all()


def test_primary_without_past_raises():
    paths = observed(classical_scene(np.random.default_rng(9), 3))
    with pytest.raises(ValueError, match="primary"):
        kalman.predict(paths, obs_length=1, device="cpu")


def test_fit_in_f64_keeps_the_floors():
    """Why the port computes in f64 where the JAX CLI computes in f32: on a
    straight track EM drives Q to its 1e-6 I floor, next to x x^T ~ 1e2 m^2
    in the sufficient statistics; in f32 the fitted Q is off by orders of
    the floor, in f64 it holds JAX's f64 fit."""
    t = np.arange(9, dtype=np.float64)
    ys = np.stack([8.0 + 0.4 * t, -6.0 + 0.3 * t], axis=-1)[None]
    mask = np.ones((1, 9), bool)
    jparams, _, _, _ = _jax_fit()(jnp.asarray(ys), jnp.asarray(mask))
    q64 = kalman.kf_fit(torch.from_numpy(ys), torch.from_numpy(mask))[0].q
    q32 = kalman.kf_fit(torch.from_numpy(ys).float(), torch.from_numpy(mask))[0].q
    want = np.asarray(jparams.q)
    assert q64.dtype == torch.float64
    np.testing.assert_allclose(q64.numpy(), want, rtol=0, atol=1e-8 * np.abs(want).max())
    assert np.abs(q32.double().numpy() - want).max() > 1e-6
