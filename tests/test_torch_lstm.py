"""The port's LSTM rollout and path predictor against the JAX package.

The 19-step ``forward(n_predict=12)`` in float64 at 1e-8 (the tolerance of
``tests/test_parity_lstm.py``), with late-appearing, absent and padded
agents; masks and NaN placement exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.data.rows import TrackRow
from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.models.lstm import LSTMPredictor as JPredictor
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_torch.models.lstm import LSTM, LSTMPredictor
from trajnetplusplusbaselines_torch.ops.cuda import fused_step
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .torch_parity import CELL_SIDE, N, example_batch, port_model, with_traced_cell_side


def _jax_model(pool_type):
    pool = None
    if pool_type is not None:
        pool = JGrid(type_=pool_type, hidden_dim=128, cell_side=CELL_SIDE, n=N, out_dim=256)
    model = JLSTM(pool=pool, embedding_dim=64, hidden_dim=128)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                          model.init_params(jax.random.PRNGKey(5)))
    return model, params


def _jax_forward(model, params, xy, mask, n_predict):
    s, a = xy.shape[1:3]

    def fwd(model, params, xy, mask):
        return model.forward(params, xy, mask, jnp.zeros((s, a, 2)), jnp.ones((s, a), bool),
                             n_predict=n_predict)

    if model.pool is None:
        return jax.jit(lambda p, x, m: fwd(model, p, x, m))(params, xy, mask)
    return with_traced_cell_side(fwd, model)(params, jnp.asarray(xy), jnp.asarray(mask))


@pytest.mark.parametrize("pool_type", ["directional", "occupancy", None])
def test_forward_matches_jax(pool_type):
    jmodel, jparams = _jax_model(pool_type)
    xy, mask = example_batch(s=3, a=6)
    want = _jax_forward(jmodel, jparams, xy[:9], mask[:9], 12)

    model = port_model(jmodel)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    launches = fused_step.fused_dlstm_step.launches
    got = model.forward(params, torch.from_numpy(xy[:9]), torch.from_numpy(mask[:9]),
                        n_predict=12)
    assert fused_step.fused_dlstm_step.launches == launches  # CPU: no kernel
    rel, pred, valid = (x.numpy() for x in got)
    assert rel.shape == (19, 3, 6, 5) and pred.shape == (19, 3, 6, 2)
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    np.testing.assert_allclose(rel, np.asarray(want[0]), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pred, np.asarray(want[1]), atol=1e-8, rtol=0)
    assert not valid[:6, :, -1].any() and valid[:, :, 0].all()  # late agent, primary


def test_forward_two_frame_observation():
    jmodel, jparams = _jax_model("directional")
    xy, mask = example_batch(s=2, a=4, seed=3)
    xy, mask = xy[7:9], np.ones_like(mask[7:9])
    want = _jax_forward(jmodel, jparams, xy, mask, 5)
    got = port_model(jmodel).forward(params_from_jax(jax.tree.map(np.asarray, jparams)),
                                     torch.from_numpy(xy), torch.from_numpy(mask), n_predict=5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-8, rtol=0)


def test_init_params_layout_matches_jax():
    jmodel, jparams = _jax_model("directional")
    params = port_model(jmodel).init_params(torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert shapes == jshapes


def test_not_ported_paths_raise():
    jmodel, jparams = _jax_model("directional")
    model = port_model(jmodel)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    xy, mask = example_batch(s=1, a=4)
    obs, m = torch.from_numpy(xy[:9]), torch.from_numpy(mask[:9])
    truth, truth_mask = torch.from_numpy(xy[9:20]), torch.from_numpy(mask[9:20])
    with pytest.raises(ValueError):  # teacher forcing and n_predict together
        model.forward(params, obs, m, truth, truth_mask, n_predict=12)
    with pytest.raises(ValueError):  # truth without its mask
        model.forward(params, obs, m, truth)
    with pytest.raises(ValueError):
        model.forward(params, obs, m)
    # goal models are ported: one needs its goals
    goal_model = LSTM(embedding_dim=8, hidden_dim=16, goal_flag=True)
    goal_params = goal_model.init_params(torch.Generator().manual_seed(0), dtype=torch.float64)
    with pytest.raises(ValueError, match="needs goals"):
        goal_model.forward(goal_params, obs, m, n_predict=12)
    rel, _, _ = goal_model.forward(goal_params, obs, m, n_predict=12,
                                   goals=torch.zeros(1, 4, 2, dtype=torch.float64))
    assert bool(torch.isfinite(rel).all())


def _paths(seed, n_agents=4, t=9):
    rng = np.random.default_rng(seed)
    xy = rng.normal(size=(t, n_agents, 2)).cumsum(axis=0) * 0.2
    paths = []
    for p in range(n_agents):
        first = 3 if p == n_agents - 1 else 0  # a late-appearing neighbour
        paths.append([TrackRow(10 * f, p + 1, float(xy[f, p, 0]), float(xy[f, p, 1]))
                      for f in range(first, t)])
    return paths


@pytest.mark.parametrize("normalize", [False, True])
def test_predictor_call_matches_jax(normalize):
    import types

    jmodel, jparams = _jax_model("directional")
    args = types.SimpleNamespace(normalize_scene=normalize)
    paths = _paths(1)
    goals = np.zeros((len(paths), 2))
    want = JPredictor(jmodel, jparams)(paths, goals, n_predict=12, modes=2, args=args)
    got = LSTMPredictor(port_model(jmodel), params_from_jax(jax.tree.map(np.asarray, jparams)))(
        paths, goals, n_predict=12, modes=2, args=args)
    assert sorted(got) == sorted(want) == [0, 1]
    for mode in (0, 1):
        for g, w in zip(got[mode], want[mode]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-8, rtol=0)
    assert got[0][1].shape == (12, 3, 2)
