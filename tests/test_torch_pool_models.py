"""Whole LSTM models of every interaction pool: the port against the JAX package.

For each of the eleven ``--type`` values, the goal model, ``pool_to_input=
False``, the two-layer directional model and the stateful ``lstm_layer``
one, at tiny widths (embedding 8, hidden 16, pool 16, grid n 4) in float64
with params carried over by ``params_from_jax``:

- the autoregressive rollout (``n_predict=12``) and the teacher-forced one
  against JAX's ``LSTM.forward`` at 1e-8, with goals and the slot mask, on
  scenes with a single track, a padded slot, a late-appearing agent and a
  goal at zero distance;
- one train step's loss and gradients against ``jax.value_and_grad`` at 1e-8
  for the pools that read the hidden state;
- the routing predicate ``LSTM.route``, configuration by configuration, and
  on the CPU the grid route's 19 calls of the grid stage's wrapper (which
  run its plain version here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.trainers import common as jcommon
from trajnetplusplusbaselines_tpu.trainers.lstm import Trainer as JTrainer
from trajnetplusplusbaselines_torch.models import lstm as lstm_module
from trajnetplusplusbaselines_torch.models.lstm import LSTM
from trajnetplusplusbaselines_torch.ops.cuda import fused_step
from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling, make_pool
from trajnetplusplusbaselines_torch.trainers import common
from trajnetplusplusbaselines_torch.trainers.lstm import Trainer

from .torch_parity import POOL_MODELS, jax_pool_model, jax_runner, pool_batch, port_model

TOL = 1e-8
# the pools whose output reads the LSTM's hidden state
READS_HIDDEN = ["social", "dir_social", "hiddenstatemlp", "attentionmlp", "nmmp", "nn_lstm",
                "traj_pool", "lstm_layer"]


def _close(got, want, tol=TOL):
    got = got.detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("name", list(POOL_MODELS))
def test_rollouts_match_jax(name):
    jmodel, jparams, params = jax_pool_model(name, seed=1)
    xy, mask, goals, slot = pool_batch(seed=2)

    def fwd(model, params, xy, mask, goals, slot):
        free = model.forward(params, xy[:9], mask[:9], goals, slot, n_predict=12)
        teacher = model.forward(params, xy[:9], mask[:9], goals, slot,
                                prediction_truth=xy[9:20], prediction_truth_mask=mask[9:20])
        return free, teacher

    want = jax_runner(fwd, jmodel)(jparams, *map(jnp.asarray, (xy, mask, goals, slot)))
    model = port_model(jmodel)
    x, m, g, sl = map(torch.from_numpy, (xy, mask, goals, slot))
    with torch.no_grad():
        free = model.forward(params, x[:9], m[:9], n_predict=12, goals=g, slot_mask=sl)
    teacher = model.forward(params, x[:9], m[:9], x[9:20], m[9:20], goals=g, slot_mask=sl)
    for got, exp in ((free, want[0]), (teacher, want[1])):
        rel, pred, valid = got
        assert rel.shape == (19, 4, 5, 5)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(exp[2]))
        _close(rel, exp[0])
        _close(pred, exp[1])
    assert not free[2][:, 1, 1:].any() and not free[2][:, 2, -1].any()  # no track, no output


@pytest.mark.parametrize("name", READS_HIDDEN)
def test_train_step_matches_jax(name):
    jmodel, jparams, params = jax_pool_model(name, seed=3)
    xy, mask, goals, slot = pool_batch(seed=4)
    scene = np.ones(xy.shape[1], bool)
    jtr = JTrainer(jmodel, jparams, jcommon.make_optimizer(1e-4), jcommon.step_lr(1e-3, 10),
                   batch_size=4, augment=False)

    def value_and_grad(model, params, xy, mask, goals, slot, scene):
        jtr.model = model

        def loss(p):
            outputs = jtr._forward_train(p, xy, mask, goals, slot, 0)
            return jtr._loss_from_outputs(*outputs, xy, mask, scene)

        return jax.value_and_grad(loss)(params)

    want_loss, want_grads = jax_runner(value_and_grad, jmodel)(
        jparams, *map(jnp.asarray, (xy, mask, goals, slot, scene)))
    tr = Trainer(port_model(jmodel), params, common.step_lr(1e-3, 10), batch_size=4,
                 augment=False)
    loss, grads = tr.loss_and_grads(*map(torch.from_numpy, (xy, mask, scene, goals, slot)))
    _close(loss, want_loss)
    by_path = dict(zip(tr.paths, grads))
    flat, _ = jax.tree_util.tree_flatten_with_path(want_grads)
    assert len(flat) == len(by_path)
    for path, want in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        _close(by_path[key], want)
    pool_grads = [g for p, g in by_path.items() if p.startswith("pool/")]
    assert any(bool(g.abs().sum() > 0) for g in pool_grads)  # the pool is trained


def _model(pool=None, **kw):
    return LSTM(pool=pool, **kw)


def _grid(**kw):
    return GridBasedPooling(**{"type_": "directional", "hidden_dim": 128, "cell_side": 0.6,
                               "n": 12, "out_dim": 256, **kw})


@pytest.mark.parametrize("make,routes", [
    (lambda: _model(_grid()), ("fused", "grid")),  # the flagship D-LSTM
    (lambda: _model(_grid(), goal_flag=True), ("grid", "grid")),
    (lambda: _model(_grid(n=8)), ("grid", "grid")),
    (lambda: _model(_grid(out_dim=64, hidden_dim=64), hidden_dim=64), ("grid", "grid")),
    (lambda: _model(_grid(embedding_arch="two_layer")), ("grid", "grid")),
    (lambda: _model(_grid(embedding_arch="lstm_layer")), ("grid", "grid")),
    (lambda: _model(_grid(embedding_arch="None")), ("grid", "grid")),
    (lambda: _model(_grid(front=True)), ("grid", "grid")),
    (lambda: _model(_grid(blur_size=3)), ("grid", "grid")),
    (lambda: _model(_grid(pool_size=2)), ("grid", "grid")),
    (lambda: _model(_grid(pool_size=3)), ("plain", "plain")),  # a side of 36 > GRID_MAX_N
    (lambda: _model(_grid(n=33)), ("plain", "plain")),
    (lambda: _model(_grid(out_dim=128), pool_to_input=False), ("grid", "grid")),
    (lambda: _model(_grid(type_="occupancy")), ("plain", "plain")),
    (lambda: _model(_grid(type_="social")), ("plain", "plain")),
    (lambda: _model(make_pool("attentionmlp")), ("plain", "plain")),
    (lambda: _model(make_pool("nn")), ("plain", "plain")),
    (lambda: _model(), ("plain", "plain")),
])
def test_routing_predicate(make, routes):
    model = make()
    assert (model.route(records=False), model.route(records=True)) == routes
    assert model.fused == (routes[0] == "fused")


@pytest.mark.parametrize("name,want_grid_calls", [
    ("goals", 19), ("two_layer", 19), ("lstm_layer", 19), ("pool_to_input_false", 19),
    ("social", 0), ("nmmp", 0)])
def test_routes_on_the_cpu(name, want_grid_calls, monkeypatch):
    """The grid route calls the grid stage's wrapper once per step; on the
    CPU it runs the plain grid, so no launch is counted anywhere."""
    calls = []

    def counted(*args, **kw):
        calls.append(kw)
        return fused_step.directional_grid(*args, **kw)

    monkeypatch.setattr(lstm_module, "directional_grid", counted)
    jmodel, _, params = jax_pool_model(name)
    xy, mask, goals, slot = map(torch.from_numpy, pool_batch(seed=5))
    launches = fused_step.fused_dlstm_step.launches, fused_step.directional_grid.launches
    port_model(jmodel).forward(params, xy[:9], mask[:9], n_predict=12, goals=goals,
                               slot_mask=slot)
    assert len(calls) == want_grid_calls
    assert all(kw["n"] == 4 and kw["front"] is False for kw in calls)
    assert (fused_step.fused_dlstm_step.launches,
            fused_step.directional_grid.launches) == launches


def test_goal_direction_has_no_nan_gradient():
    """At zero distance to its goal the direction is 0 with a finite
    gradient, as JAX's double ``where`` gives it."""
    _, _, params = jax_pool_model("goals")
    model = port_model(jax_pool_model("goals")[0])
    obs = torch.zeros(1, 2, 2, dtype=torch.float64, requires_grad=True)
    goals = torch.zeros(1, 2, 2, dtype=torch.float64)
    mask = torch.ones(1, 2, dtype=torch.bool)
    emb = model._goal_input(params, obs, goals, mask)
    emb.sum().backward()
    assert bool(torch.isfinite(obs.grad).all())


def test_forward_needs_what_the_model_reads():
    xy, mask, goals, slot = map(torch.from_numpy, pool_batch(seed=6))
    for name, needs in (("goals", "goals"), ("hiddenstatemlp", "slot mask"),
                        ("lstm_layer", "slot mask")):
        jmodel, _, params = jax_pool_model(name)
        with pytest.raises(ValueError, match=needs):
            port_model(jmodel).forward(params, xy[:9], mask[:9], n_predict=12)
    # a pool that reads neither runs without them
    jmodel, _, params = jax_pool_model("nn")
    port_model(jmodel).forward(params, xy[:9], mask[:9], n_predict=12)
