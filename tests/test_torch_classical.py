"""The port's constant-velocity, social-force and ORCA predictors and its
copies of ``data/interactions`` and ``metrics/batch``, against the JAX
package in f64 on the CPU: CV bit-exact, interactions equal, social force
within 1e-10 m (per scene and folded over mixed agent buckets), ORCA equal
(the same C++ source built with the same flags)."""

import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.data import interactions as jinteractions
from trajnetplusplusbaselines_tpu.metrics import batch as jbatch
from trajnetplusplusbaselines_tpu.models.classical import constant_velocity as jcv
from trajnetplusplusbaselines_tpu.models.classical import orca as jorca
from trajnetplusplusbaselines_tpu.models.classical import socialforce as jsf
from trajnetplusplusbaselines_torch.data import interactions
from trajnetplusplusbaselines_torch.data.reader import Reader
from trajnetplusplusbaselines_torch.data.rows import TrackRow
from trajnetplusplusbaselines_torch.metrics import batch
from trajnetplusplusbaselines_torch.models.classical import constant_velocity, orca, socialforce

from .torch_parity import classical_scene, observed

SF_OPT = (0.5, 5.0, 0.3)


def scenes(seed, sizes, full=False):
    rng = np.random.default_rng(seed)
    made = [classical_scene(rng, n, scene_id=i) for i, n in enumerate(sizes)]
    return made if full else [observed(paths) for paths in made]


def goals_of(paths_list):
    """Every pedestrian's last position, as ``get_dest`` writes them."""
    return {p[-1].pedestrian: [p[-1].x, p[-1].y] for paths in paths_list for p in paths}


def same(got, want, atol=0.0):
    """One predictor output against another: {0: (primary, neighbours)}."""
    assert sorted(got) == sorted(want) == [0]
    for g, w in zip(got[0], want[0]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if atol:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        else:
            assert np.array_equal(g, w, equal_nan=True)


# ---------------------------------------------------------------- CV
def test_cv_bit_exact_against_jax():
    made = scenes(0, (1, 2, 5, 9, 3))
    xy = np.stack([Reader.paths_to_xy(made[2])] * 3)  # [3, T, A, 2], NaN where absent
    assert np.array_equal(constant_velocity.predict_xy(torch.from_numpy(xy), 12).numpy(),
                          jcv.predict_xy(xy, 12), equal_nan=True)
    folded = constant_velocity.predict_dataset(made, device="cpu")
    for paths, out in zip(made, folded):
        want = jcv.predict(paths, n_predict=12, obs_length=9)
        same(constant_velocity.predict(paths, device="cpu"), want)
        same(out, want)
    assert constant_velocity.predict_dataset(made, predict_all=False, device="cpu")[3][0][1] == []


def test_cv_headon_collides():
    """The segment-interpolated collision metric (the port's copy of
    ``metrics/batch``) catches CV's mid-frame crossing."""
    p1 = [TrackRow(i, 1, 0.1, 6.2 - 0.4 * i) for i in range(9)]
    p2 = [TrackRow(i, 2, 0.0, -6.2 + 0.4 * i) for i in range(9)]
    prim, neigh = constant_velocity.predict([p1, p2], device="cpu")[0]
    pred = np.stack([prim, neigh[:, 0]])
    assert batch.pred_col(pred) == 1.0


# ---------------------------------------------------------------- host copies
def interaction_scenes():
    """[T, A, 2] scenes: head-on, following, side by side, far away, a
    neighbour absent for part of the window (NaN), and random walks."""
    t = np.arange(21, dtype=float)
    primary = np.stack([np.zeros(21), t * 0.4], axis=-1)
    made = [np.stack([primary,
                      np.stack([np.zeros(21) + 0.1, 16.0 - t * 0.4], axis=-1),
                      np.stack([np.zeros(21), t * 0.4 + 2.0], axis=-1),
                      np.stack([np.zeros(21) + 0.5, t * 0.4], axis=-1),
                      np.full((21, 2), 50.0)], axis=1)]
    gappy = made[0].copy()
    gappy[12:16, 1] = np.nan
    gappy[:, 4] = np.nan
    made.append(gappy)
    rng = np.random.default_rng(1)
    for _ in range(4):
        xy = rng.normal(scale=0.3, size=(21, 6, 2)).cumsum(axis=0) + rng.uniform(-2, 2, (1, 6, 2))
        xy[rng.random((21, 6)) < 0.15] = np.nan
        xy[:, 0] = np.nan_to_num(xy[:, 0])
        made.append(xy)
    return made


def test_interactions_equal_jax():
    hits = 0
    for xy in interaction_scenes():
        for got, want in zip(interactions.interaction_features(xy),
                             jinteractions.interaction_features(xy)):
            assert np.array_equal(got, want, equal_nan=True)
        for name in ("check_interaction", "leader_follower", "collision_avoidance", "group",
                     "others"):
            got, want = getattr(interactions, name)(xy), getattr(jinteractions, name)(xy)
            assert got.dtype == want.dtype == bool and np.array_equal(got, want), name
            hits += int(got.sum())
        assert interactions.interaction_type(xy) == jinteractions.interaction_type(xy)
    assert hits > 5
    assert interactions.interaction_type(interaction_scenes()[0]) == [1, 2, 3]


def test_batch_metrics_equal_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(scale=0.5, size=(3, 5, 12, 2)).cumsum(axis=2)
    gt = pred + rng.normal(scale=0.1, size=pred.shape)
    pred[1, 2, 4:] = np.nan
    for p, g in zip(pred, gt):
        assert batch.trajnet_sample_eval(p, g) == jbatch.trajnet_sample_eval(p, g)
        assert batch.collision_free(p[0], p[1]) == jbatch.collision_free(p[0], p[1])
    sse = [(0, 2), (2, 5)]
    assert batch.trajnet_batch_eval(pred[0], gt[0], sse) == jbatch.trajnet_batch_eval(
        pred[0], gt[0], sse)
    assert batch.trajnet_batch_multi_eval(pred, gt[0], sse) == jbatch.trajnet_batch_multi_eval(
        pred, gt[0], sse)


# ---------------------------------------------------------------- social force
def test_simulate_matches_jax():
    rng = np.random.default_rng(3)
    state = np.concatenate([rng.uniform(-2, 2, (6, 2)), rng.normal(scale=0.8, size=(6, 2)),
                            rng.uniform(-6, 6, (6, 2)), np.full((6, 1), 0.5)], axis=-1)
    for v0, sigma in ((2.1, 0.3), (5.0, 0.3)):
        want = np.asarray(jsf._simulate_jit(state, 96, 1.0 / 20, v0, sigma))
        got = socialforce.simulate(torch.from_numpy(state)[None], 96, 1.0 / 20, v0, sigma)
        assert got.shape == (96, 1, 6, 7) and got.dtype == torch.float64
        np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("dest_type", ["interp", "true", "vel", "pred_end"])
def test_predict_matches_jax(dest_type):
    full = scenes(4, (7,), full=True)[0]
    paths = full if dest_type == "pred_end" else observed(full)
    dest = goals_of([full]) if dest_type == "true" else None
    for params in ((0.5, 2.1, 0.3), SF_OPT):
        want = jsf.predict(paths, dest, dest_type, params, n_predict=12, obs_length=9)
        same(socialforce.predict(paths, dest, dest_type, params, device="cpu"), want, 1e-10)


def test_predict_dataset_over_mixed_buckets_matches_jax_per_scene():
    """Scenes of 2..40 agents folded into buckets 4, 8 and 64 (a scene of
    40 alone in its bucket), each equal to JAX's ``predict`` of it."""
    made = scenes(5, (2, 3, 6, 4, 8, 5, 40, 2))
    got = socialforce.predict_dataset(made, sf_params=SF_OPT, device="cpu")
    for paths, out in zip(made, got):
        same(out, jsf.predict(paths, sf_params=SF_OPT, n_predict=12, obs_length=9), 1e-10)
    assert socialforce.predict_dataset(made[:2], predict_all=False, device="cpu")[1][0][1] == []


def test_pad_agents_exert_no_force(monkeypatch):
    """A pad parked at 1e6 m exerts exactly zero force on a real agent in
    f64, so a scene padded to its bucket is the scene alone (1e-12: sums
    over more zero terms may group the real ones otherwise), and the
    memory cap's chunks change nothing."""
    made = scenes(6, (3, 3, 7))
    s = torch.from_numpy(socialforce.pack_bucket([socialforce.initial_state(made[0])], 8, 0.5))
    e = socialforce.desired_directions(s)
    speeds = torch.linalg.vector_norm(s[..., 2:4], dim=-1)
    r_ab = s[..., :, None, 0:2] - s[..., None, :, 0:2]
    f_ab = socialforce.pedped_grad(r_ab, speeds, e, 1.0 / 20, 2.1, 0.3)
    assert torch.all(f_ab[0, :3, 3:] == 0)
    padded = socialforce.simulate(s, 96, 1.0 / 20, 2.1, 0.3)[:, 0, :3]
    alone = socialforce.simulate(s[:, :3], 96, 1.0 / 20, 2.1, 0.3)[:, 0]
    torch.testing.assert_close(padded, alone, rtol=0, atol=1e-12)

    whole = socialforce.predict_dataset(made, device="cpu")
    monkeypatch.setattr(socialforce, "PAIRS_PER_CALL", 16)
    for a, b in zip(whole, socialforce.predict_dataset(made, device="cpu")):
        same(a, b, 1e-12)


# ---------------------------------------------------------------- ORCA
@pytest.mark.parametrize("dest_type", ["interp", "true", "pred_end"])
def test_orca_equals_jax(dest_type):
    full = scenes(7, (6,), full=True)[0]
    paths = full if dest_type == "pred_end" else observed(full)
    dest = goals_of([full]) if dest_type == "true" else None
    for params in ((1.5, 1.5, 0.4), (0.4, 1.0, 0.3)):
        want = jorca.predict(paths, dest, dest_type, params, n_predict=12, obs_length=9)
        same(orca.predict(paths, dest, dest_type, params), want)
    folded = orca.predict_dataset([paths, paths[:2]], dest, dest_type)
    same(folded[1], jorca.predict(paths[:2], dest, dest_type, n_predict=12, obs_length=9))


def test_orca_refuses_vel_destinations():
    with pytest.raises(NotImplementedError):
        orca.predict(scenes(8, (2,))[0], dest_type="vel")
