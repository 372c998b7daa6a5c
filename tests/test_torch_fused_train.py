"""The fused train route (``ops/cuda/fused_train.py``), on the CPU.

``FusedTrainRollout`` is the flagship's teacher-forced rollout under
autograd with a hand-written backward; on the CPU its four kernels' wrappers
run their plain versions, so these tests exercise the Function whole:

- its outputs and its backward against autograd through the grid route
  (the route it replaces) in float64, within 1e-12 of each output's and
  each leaf's largest magnitude, with absent agents, padded slots, a
  late-entering neighbour, ``start_length`` 0 and 3, and upstream gradients
  on both ``rel_pred`` and ``pred``; the same against the JAX package's
  ``jax.vjp`` of its teacher-forced forward at 1e-10;
- the routing predicate (``LSTM.takes_fused_train``): which configurations
  take the route and which keep theirs, and that the trainer's parity
  configuration of ``tests/test_torch_train.py`` runs through it;
- ``fused_train_in``'s plain version (the input rows with the grid
  embedding as a dense product) against the JAX package's input embedding
  and ``GridBasedPooling.apply``'s grid embedding on JAX's own grids, f64,
  at 1e-12: on the encoder's stack of 8 steps and on one decoder step;
- the wrappers' launch path with the kernel stood in by its plain version:
  the arguments each passes (ints where the C entry takes ints), the
  launches a rollout counts (19 of each per-step kernel but
  ``fused_train_in``, 12 of it: one for the encoder's steps and one a
  decoder step; one ``fused_train_in_backward``) and the same outputs as
  the plain path; the matrix products a flagship train step dispatches
  there, the kernels' own left out: only the 7 once-a-rollout ones (the
  cell kernels form the gate and ``dh`` products themselves);
- the backward's carried ``dh`` through step g + 1's cell (the decoder's at
  the last encoder step) against autograd with unlike cells; ``cell_pack``'s
  layout; the hidden width and row limits of the cell kernels, in the
  wrappers and in the route predicate;
- the loss's plain version at the loss kernel's edges (every scene masked,
  one scene, P = 1) against ``losses.prediction_loss`` and the JAX
  package's, f64, at 1e-12; the block the loss kernel takes
  (``loss_threads``); the loss's backward against the autograd gradient of
  the whole ``rel`` at ``LOSS_BACKWARD_CASES`` (the kernel's float4 and
  scalar paths, every scene masked too), f64, at 1e-12, and its wrapper
  refusing a ``d_rel`` past its kernel's 32-bit index (meta tensors);
- the VAE trainer's reconstruction (once a mode) and
  ``make_sharded_train_step``'s loss through ``FusedPredictionLoss``, their
  loss and gradients within 1e-12 of ``losses.prediction_loss``'s, f64;
- each wrapper raising on a wrong dtype, device or shape; the counters in
  ``trainers/graphs.COUNTERS``; ``chip_smoke.graph_kernel_nodes`` reading
  the new kernels from a graph.

The kernels themselves run on the card only: ``chip_smoke.py`` phase 6c
holds each against its plain version there.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from trajnetplusplusbaselines_tpu import losses as jlosses
from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.ops.embeddings import input_embedding as j_input_embedding
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_torch import losses
from trajnetplusplusbaselines_torch.models.lstm import LSTM
from trajnetplusplusbaselines_torch.ops.cuda import build, fused_train
from trajnetplusplusbaselines_torch.ops.pooling.grid import GridBasedPooling
from trajnetplusplusbaselines_torch.trainers import common, graphs
from trajnetplusplusbaselines_torch.trainers.lstm import Trainer
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .torch_parity import example_batch, port_model, with_traced_cell_side

OWN_TOL = 1e-12  # of each output's and leaf's largest magnitude, f64
JAX_TOL = 1e-10  # against the JAX package, f64, as tests/test_torch_train.py


def _model(**pool_kw):
    pool = GridBasedPooling(**{"type_": "directional", "hidden_dim": 16, "cell_side": 0.6,
                               "n": 4, "out_dim": 16, **pool_kw})
    return LSTM(pool=pool, embedding_dim=8, hidden_dim=16)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _params(model, dtype=torch.float64, seed=1):
    params = model.init_params(torch.Generator().manual_seed(seed), dtype=dtype)
    for leaf in _leaves(params):
        leaf.requires_grad_()
    return params


def _batch(s=4, a=5, seed=0, dtype=torch.float64):
    """``example_batch``'s scenes (a late-entering agent, one absent
    mid-way, a padded slot) with more absent agents drawn at random."""
    xy, mask = example_batch(s, a, seed=seed)
    rng = np.random.default_rng(seed + 1)
    mask &= rng.random(mask.shape) > 0.1
    mask[:, :, 0] = True
    xy = np.where(mask[..., None], xy, 0.0)
    return torch.tensor(xy, dtype=dtype), torch.from_numpy(mask)


def _forward(model, params, xy, mask, start_length=0, fused=True):
    """The teacher-forced forward; ``fused`` False keeps the grid route."""
    args = (params, xy[start_length:9], mask[start_length:9])
    kw = dict(prediction_truth=xy[9:20], prediction_truth_mask=mask[9:20])
    if fused:
        return model.forward(*args, **kw)
    with mock.patch.object(model, "takes_fused_train", lambda *a, **k: False):
        return model.forward(*args, **kw)


def _relative(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


# ------------------------------------------------- the Function against autograd
@pytest.mark.parametrize("start_length", [0, 3])
def test_function_matches_autograd_through_the_grid_route(start_length):
    """Forward outputs and every leaf's gradient, with upstream gradients on
    both ``rel_pred`` and ``pred``, equal the grid route's within 1e-12 of
    their largest magnitude in f64."""
    model = _model()
    params = _params(model)
    leaves = _leaves(params)
    xy, mask = _batch()
    results = []
    for fused in (True, False):
        with mock.patch.object(fused_train.FusedTrainRollout, "apply",
                               wraps=fused_train.FusedTrainRollout.apply) as apply:
            rel, pred, valid = _forward(model, params, xy, mask, start_length, fused)
        assert apply.call_count == int(fused)
        ct = [torch.from_numpy(np.random.default_rng(5).normal(size=x.shape)) for x in (rel, pred)]
        loss = (rel * ct[0]).sum() + (pred * ct[1]).sum()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        results.append((rel.detach(), pred.detach(), valid, grads))
    (rel, pred, valid, grads), (rel_g, pred_g, valid_g, grads_g) = results
    assert rel.shape == (19 - start_length, 4, 5, 5) and pred.shape == (19 - start_length, 4, 5, 2)
    assert torch.equal(valid, valid_g) and not valid.all() and valid.any()
    assert _relative(rel, rel_g) <= OWN_TOL and _relative(pred, pred_g) <= OWN_TOL
    reached = 0
    for g, w in zip(grads, grads_g):
        assert torch.isfinite(g).all()
        assert _relative(g, w) <= OWN_TOL
        reached += bool(w.abs().max() > 0)
    assert reached == len(leaves) - 2  # the goal embedding is unused


def test_function_without_a_position_gradient():
    """A loss on ``rel_pred`` alone (the trainer's default, no collision
    term): ``pred``'s gradient is None in the backward, and the leaves'
    gradients still equal the grid route's."""
    model = _model()
    params = _params(model)
    leaves = _leaves(params)
    xy, mask = _batch(s=3, a=4, seed=2)
    grads = []
    for fused in (True, False):
        rel = _forward(model, params, xy, mask, fused=fused)[0]
        grads.append(torch.autograd.grad((rel[-12:, :, 0] ** 2).sum(), leaves,
                                         materialize_grads=True))
    for g, w in zip(*grads):
        assert _relative(g, w) <= OWN_TOL


def test_function_matches_the_jax_vjp():
    """Outputs and the vector-Jacobian product of every leaf against the
    JAX package's teacher-forced forward under ``jax.vjp``, same params and
    cotangents, f64, at 1e-10."""
    jmodel = JLSTM(pool=JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=4,
                              out_dim=16), embedding_dim=8, hidden_dim=16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jmodel.init_params(jax.random.PRNGKey(3)))
    model = port_model(jmodel)
    xy, mask = _batch(s=3, a=6, seed=4)
    s, a = xy.shape[1:3]
    rng = np.random.default_rng(7)
    ct_rel, ct_pred = rng.normal(size=(19, s, a, 5)), rng.normal(size=(19, s, a, 2))

    def vjp(jm, params, xy, mask, ct_rel, ct_pred):
        def fwd(p):
            rel, pred, _ = jm.forward(p, xy[:9], mask[:9], jnp.zeros((s, a, 2)),
                                      jnp.ones((s, a), bool), prediction_truth=xy[9:20],
                                      prediction_truth_mask=mask[9:20])
            return rel, pred

        out, back = jax.vjp(fwd, params)
        return out, back((ct_rel, ct_pred))[0]

    (want_rel, want_pred), want_grads = with_traced_cell_side(vjp, jmodel)(
        jparams, jnp.asarray(xy.numpy()), jnp.asarray(mask.numpy()), jnp.asarray(ct_rel),
        jnp.asarray(ct_pred))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    leaves = jax.tree.leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor))  # JAX's order
    for leaf in leaves:
        leaf.requires_grad_()
    with mock.patch.object(fused_train.FusedTrainRollout, "apply",
                           wraps=fused_train.FusedTrainRollout.apply) as apply:
        rel, pred, _ = _forward(model, params, xy, mask)
    assert apply.call_count == 1
    np.testing.assert_allclose(rel.detach().numpy(), np.asarray(want_rel), atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_pred), atol=JAX_TOL,
                               rtol=0)
    grads = torch.autograd.grad((rel * torch.from_numpy(ct_rel)).sum()
                                + (pred * torch.from_numpy(ct_pred)).sum(), leaves,
                                materialize_grads=True)
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_grads))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=JAX_TOL * max(1.0, float(np.abs(w).max())),
                                   rtol=0)


@pytest.mark.parametrize("a", [8, 24])
@pytest.mark.parametrize("phase", ["encoder", "decoder"])
def test_fused_train_in_matches_the_jax_embeddings(phase, a):
    """``fused_train_in``'s plain version against the JAX package in f64,
    each output within 1e-12 of its largest magnitude: the velocity part
    against ``input_embedding`` (``models/lstm.py``'s step), the pool part
    against ``GridBasedPooling.apply``'s ``mlp`` of JAX's own
    ``make_grid``, on the encoder's 8 steps stacked into one call and on
    one decoder step, at S = 4; each grid row holds at most 2 (A - 1)
    non-zero entries, the sparsity the kernel sums over."""
    jmodel = JLSTM(pool=JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=6,
                              out_dim=16), embedding_dim=8, hidden_dim=16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jmodel.init_params(jax.random.PRNGKey(a)))
    xy, mask = _batch(s=4, a=a, seed=a)
    lo, hi = (0, 8) if phase == "encoder" else (12, 13)
    frames = (xy[lo:hi].numpy(), xy[lo + 1:hi + 1].numpy(), mask[lo:hi].numpy(),
              mask[lo + 1:hi + 1].numpy())

    def jax_step(jm, params, obs1, obs2, p1, p2):
        vel = (obs2 - obs1) * (p1 & p2)[..., None]
        grid = jm.pool.make_grid(None, obs1, obs2, p1, p2, params["pool"])
        pooled, _ = jm.pool.apply(params["pool"], None, None, obs1, obs2, p1, p2)
        return (grid.reshape(obs2.shape[0], obs2.shape[1], -1),
                j_input_embedding(params["input_embedding"], vel), pooled)

    run = with_traced_cell_side(jax_step, jmodel)
    steps = [run(jparams, *(jnp.asarray(f[t]) for f in frames)) for t in range(hi - lo)]
    grid, want_in, want_pool = (np.stack([np.asarray(step[i]) for step in steps])
                                for i in range(3))
    t, rows = hi - lo, 4 * a
    grid = torch.from_numpy(grid).reshape(t * rows, -1)
    assert int((grid != 0).sum(1).max()) <= 2 * (a - 1) and grid.any()
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    emb, layer = params["input_embedding"]["linear"], params["pool"]["embedding"][0]
    x_width = emb["w"].shape[1] + 2 + layer["w"].shape[1]
    xh = torch.full((t * rows, x_width + 17), np.nan, dtype=torch.float64)
    v4 = torch.empty((t * rows, 3), dtype=torch.float64)
    valid = torch.empty(t * rows, dtype=torch.bool)
    fused_train.fused_train_in(*(torch.from_numpy(f) for f in frames), grid, emb["w"], emb["b"],
                               layer["w"], layer["b"], xh, v4, valid)
    lin = emb["w"].shape[1]
    assert _relative(xh[:, :lin + 2], torch.from_numpy(want_in).reshape(t * rows, -1)) <= OWN_TOL
    assert _relative(xh[:, lin + 2:x_width],
                     torch.from_numpy(want_pool).reshape(t * rows, -1)) <= OWN_TOL
    assert torch.equal(xh[:, -1], torch.ones(t * rows, dtype=torch.float64))
    m = torch.from_numpy(frames[2] & frames[3]).reshape(-1)
    assert torch.equal(valid, m) and not m.all()
    vel = torch.from_numpy((frames[1] - frames[0]).reshape(-1, 2)) * m[:, None]
    assert torch.equal(v4, torch.cat([4 * vel, torch.ones(t * rows, 1, dtype=torch.float64)], 1))


# ------------------------------------------------------------------ routing
ROUTES = [
    ("flagship_f64", {}, {}, True),
    ("f32", {}, {"dtype": torch.float32}, True),
    ("front", {"front": True}, {}, True),
    ("bf16", {}, {"dtype": torch.bfloat16}, False),
    ("f32_on_the_card", {}, {"dtype": torch.float32, "device": "cuda"}, True),
    ("f64_on_the_card", {}, {"device": "cuda"}, False),
    ("f16_on_the_card", {}, {"dtype": torch.float16, "device": "cuda"}, False),
    ("free_rollout", {}, {"teacher": False}, False),
    ("no_grad", {}, {"records": False}, False),
    ("positions_carry_a_gradient", {}, {"positions_record": True}, False),
    ("two_layer", {"embedding_arch": "two_layer"}, {}, False),
    ("lstm_layer", {"embedding_arch": "lstm_layer"}, {}, False),
    ("blur", {"blur_size": 2}, {}, False),
    ("pool_size", {"pool_size": 2}, {}, False),
    ("grid_too_large", {"n": 40}, {}, False),
    ("occupancy", {"type_": "occupancy"}, {}, False),
    ("social", {"type_": "social"}, {}, False),
]


@pytest.mark.parametrize("name,pool_kw,call,want", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_predicate(name, pool_kw, call, want):
    """``LSTM.takes_fused_train`` on each configuration: the route where it
    holds, the step routes elsewhere."""
    model = _model(**pool_kw)
    kw = {"records": True, "teacher": True, "positions_record": False,
          "dtype": torch.float64, **call}
    assert model.takes_fused_train(**kw) is want


@pytest.mark.parametrize("change", ["goals", "pool_to_input_false", "remat", "no_pool"])
def test_route_predicate_model_options(change):
    """Goals, ``pool_to_input=False``, ``remat`` and a pool-less LSTM keep
    their step routes."""
    model = _model()
    if change == "goals":
        model = LSTM(pool=model.pool, embedding_dim=8, hidden_dim=16, goal_flag=True)
    elif change == "pool_to_input_false":
        model = LSTM(pool=model.pool, embedding_dim=8, hidden_dim=16, pool_to_input=False)
    elif change == "no_pool":
        model = LSTM(pool=None, embedding_dim=8, hidden_dim=16)
    else:
        setattr(model, change, True)
    assert not model.takes_fused_train(True, True)
    assert not model.fused_train


@pytest.mark.parametrize("remat", [False, True])
def test_forward_takes_the_route_the_predicate_names(remat):
    """``forward`` calls the Function exactly where the predicate holds:
    under autograd with teacher forcing, not under ``remat``, not under
    ``torch.no_grad()``, not in a free rollout."""
    model = _model()
    model.remat = remat
    params = _params(model)
    xy, mask = _batch(s=2, a=3)
    with mock.patch.object(fused_train.FusedTrainRollout, "apply",
                           wraps=fused_train.FusedTrainRollout.apply) as apply:
        _forward(model, params, xy, mask)
        assert apply.call_count == int(not remat)
        with torch.no_grad():
            _forward(model, params, xy, mask)
        model.forward(params, xy[:9], mask[:9], n_predict=12)
        assert apply.call_count == int(not remat)


def test_trainer_parity_configuration_takes_the_route():
    """The trainer of ``tests/test_torch_train.py`` (directional, n=4,
    embedding 8, hidden 16, pool 16, f64) computes its loss through the
    Function, so its JAX parity tests hold the route."""
    jmodel = JLSTM(pool=JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=4,
                              out_dim=16), embedding_dim=8, hidden_dim=16)
    model = port_model(jmodel)
    params = params_from_jax(jax.tree.map(
        lambda x: np.asarray(x, np.float64), jmodel.init_params(jax.random.PRNGKey(0))))
    trainer = Trainer(model, params, common.step_lr(1e-3, 10), batch_size=2, augment=False)
    xy, mask = _batch(s=2, a=3)
    with mock.patch.object(fused_train.FusedTrainRollout, "apply",
                           wraps=fused_train.FusedTrainRollout.apply) as apply:
        loss, grads = trainer.loss_and_grads(xy, mask, torch.ones(2, dtype=torch.bool))
    assert apply.call_count == 1 and torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)


def _loss_model(name):
    pool = _model().pool
    if name == "goals":
        return LSTM(pool=pool, embedding_dim=8, hidden_dim=16, goal_flag=True)
    if name == "social":
        return LSTM(pool=GridBasedPooling(type_="social", hidden_dim=16, cell_side=0.6, n=4,
                                          out_dim=16), embedding_dim=8, hidden_dim=16)
    if name == "no_pool":
        return LSTM(pool=None, embedding_dim=8, hidden_dim=16)
    model = _model()
    model.remat = name == "remat"
    return model.with_dtype(torch.bfloat16 if name == "bf16" else None)


def _plain_prediction_loss(rel, targets, scene_mask):
    return losses.prediction_loss(rel[-targets.shape[0]:, :, 0], targets, scene_mask)


@pytest.mark.parametrize("name,criterion,fused_rollout", [
    ("flagship", "pred", True), ("goals", "pred", False), ("social", "pred", False),
    ("no_pool", "pred", False), ("remat", "pred", False), ("bf16", "pred", False),
    ("flagship_l2", "L2", True)])
def test_trainer_loss_follows_the_criterion_not_the_route(name, criterion, fused_rollout):
    """The trainer's ``pred`` criterion is ``FusedPredictionLoss`` whichever
    route made the rollout (its plain version on the CPU), and gives
    ``losses.prediction_loss``'s loss and gradients: within 1e-12 of each
    one's largest magnitude in f64, 1e-6 where the rollout computes in bf16
    (its outputs come back in f32).  ``L2`` keeps its own loss."""
    model = _loss_model(name.replace("_l2", ""))
    dtype = torch.float32 if name == "bf16" else torch.float64
    params = model.init_params(torch.Generator().manual_seed(1), dtype=dtype)
    trainer = Trainer(model, params, common.step_lr(1e-3, 10), criterion=criterion,
                      batch_size=4, augment=False)
    xy, mask = _batch(dtype=dtype)
    goals = torch.zeros(xy.shape[1:], dtype=dtype)
    scenes = torch.tensor([True, True, True, False])
    with mock.patch.object(fused_train.FusedTrainRollout, "apply",
                           wraps=fused_train.FusedTrainRollout.apply) as rollout, \
            mock.patch.object(fused_train.FusedPredictionLoss, "apply",
                              wraps=fused_train.FusedPredictionLoss.apply) as loss_fn:
        loss, grads = trainer.loss_and_grads(xy, mask, scenes, goals=goals)
    assert rollout.call_count == int(fused_rollout)
    assert loss_fn.call_count == int(criterion == "pred")
    with mock.patch.object(fused_train, "prediction_loss", _plain_prediction_loss):
        want, want_grads = trainer.loss_and_grads(xy, mask, scenes, goals=goals)
    tol = 1e-6 if name == "bf16" else OWN_TOL
    assert _relative(loss, want) <= tol
    for g, w in zip(grads, want_grads):
        assert _relative(g, w) <= tol


# ------------------------------------------------- the wrappers' launch path
def _unpack(w_pack, hidden):
    """``w_cell`` [ld, 4H] from ``fused_train.cell_pack``'s [S, ld, 4, U]."""
    slices, ld, _, units = w_pack.shape
    return w_pack.permute(1, 2, 0, 3).reshape(ld, 4, slices * units)[:, :, :hidden].reshape(
        ld, 4 * hidden)


@pytest.mark.parametrize("hidden", [16, 40, 128, 200])
def test_cell_pack_puts_each_slice_in_one_run(hidden):
    """``cell_pack``: slice s, row k, gate q, unit u holds ``w_cell[k, q H
    + s U + u]`` (U = 16 units a slice, 32 above 128), zero past H, and a
    slice's rows are one contiguous run."""
    ld = 7
    w_cell = torch.arange(ld * 4 * hidden, dtype=torch.float32).reshape(ld, 4 * hidden) + 1
    pack = fused_train.cell_pack(w_cell, hidden)
    units = 16 if hidden <= 128 else 32
    slices = -(-hidden // units)
    assert pack.shape == (slices, ld, 4, units) and pack.is_contiguous()
    for s, k, q, u in np.ndindex(*pack.shape):
        j = s * units + u
        assert float(pack[s, k, q, u]) == (float(w_cell[k, q * hidden + j]) if j < hidden else 0.0)
    assert torch.equal(_unpack(pack, hidden), w_cell)


def _stand_in_launch(calls):
    """``fused_train._launch`` with each C entry run by its plain version,
    recording (entry, arguments) in ``calls``."""
    plain = {
        "dlstm_train_in": lambda *a: fused_train.fused_train_in_plain(*a[:12]),
        "dlstm_train_cell": lambda *a: fused_train.fused_train_cell_plain(
            a[0], _unpack(a[1], a[2].shape[1]), *a[2:14],
            None if a[14] is None else (a[14], a[15])),
        "dlstm_train_cell_backward": lambda *a: fused_train.fused_train_cell_backward_plain(
            *a[:14]),
        "dlstm_train_in_backward": lambda *a: fused_train.fused_train_in_backward_plain(*a[:2]),
        "dlstm_train_loss": lambda *a: fused_train.fused_train_loss_plain(*a[:6]),
        "dlstm_train_loss_backward": lambda *a: fused_train.fused_train_loss_backward_plain(
            *a[:4]),
    }

    def launch(entry, *args):
        calls.append((entry, args))
        plain[entry](*args)

    return launch


def test_launch_path_counts_and_matches_the_plain_path():
    """With the kernels stood in by their plain versions, a train step's
    loss and gradients through the wrappers' launch path count 19 launches
    of each per-step kernel but ``fused_train_in`` (12: one for the
    encoder's 8 steps, one for each of the 11 decoder steps) and one of
    each other kernel, pass each C entry
    the arguments its ctypes signature declares (a pointer for a tensor or
    None, an int for an int), and give the plain path's loss and gradients,
    in f32."""
    model = _model()
    params = model.init_params(torch.Generator().manual_seed(1))
    trainer = Trainer(model, params, common.step_lr(1e-3, 10), batch_size=4, augment=False,
                      col_wt=2.0)
    xy, mask = _batch(dtype=torch.float32)
    scenes = torch.tensor([True, True, True, False])

    want = trainer.loss_and_grads(xy, mask, scenes)
    calls = []
    before = [k.launches for k in fused_train.KERNELS]
    with mock.patch.object(fused_train, "_kernel_device", lambda x: True), \
            mock.patch.object(fused_train, "_launch", _stand_in_launch(calls)):
        got = trainer.loss_and_grads(xy, mask, scenes)
    counts = [k.launches - b for k, b in zip(fused_train.KERNELS, before)]
    assert counts == [12, 19, 19, 1, 1, 1]
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    signatures = build._SIGNATURES
    assert {entry for entry, _ in calls} == {k for k in signatures if k.startswith("dlstm_train")}
    for entry, args in calls:
        kinds = [build._I if isinstance(a, int) else build._P for a in args] + [build._P]
        assert kinds == signatures[entry], entry
        assert all(a is None or isinstance(a, (int, torch.Tensor)) for a in args)


class _ProductCount(TorchDispatchMode):
    """Records the output shape of every matrix product dispatched while
    ``counting`` is True (``aten.mm`` in any overload, ``addmm``, ``bmm``)."""

    PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm)

    def __init__(self):
        super().__init__()
        self.shapes, self.counting = [], True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.counting and func.overloadpacket in self.PRODUCTS:
            self.shapes.append(tuple(out.shape))
        return out


def test_train_step_runs_only_the_once_a_rollout_products():
    """A flagship train step (the flagship's widths, S = 2, A = 3, f32)
    through the wrappers' launch path, each kernel stood in by its plain
    version and what that runs left uncounted: the step dispatches 7 matrix
    products, the once-a-rollout ones of the backward (the encoder's and
    the decoder's ``dx``, the embedding's, ``W_grid``'s, each cell's and
    Hidden2Normal's weight gradient), and none in the forward step loop or
    the backward recurrence: 37 fewer than when the 19 gate products and the
    18 ``dh`` products ran beside the kernels."""
    import chip_smoke

    model = chip_smoke.flagship_model()
    params = model.init_params(torch.Generator().manual_seed(2))
    trainer = Trainer(model, params, common.step_lr(1e-3, 10), batch_size=2, augment=False)
    xy, mask = _batch(s=2, a=3, dtype=torch.float32)
    counted = _ProductCount()
    stand_in = _stand_in_launch([])

    def launch(entry, *args):
        counted.counting = False
        try:
            stand_in(entry, *args)
        finally:
            counted.counting = True

    before = [k.launches for k in fused_train.KERNELS]
    with mock.patch.object(fused_train, "_kernel_device", lambda x: True), \
            mock.patch.object(fused_train, "_launch", launch), counted:
        loss, grads = trainer.loss_and_grads(xy, mask, torch.ones(2, dtype=torch.bool))
    assert [k.launches - b for k, b in zip(fused_train.KERNELS, before)] == [12, 19, 19, 1, 1, 1]
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    lin, (g, pool), hidden = 62, params["pool"]["embedding"][0]["w"].shape, 128
    x_width, rows = lin + 2 + pool, 6
    ld = x_width + hidden + 1
    assert sorted(counted.shapes) == sorted([
        (8 * rows, x_width), (11 * rows, x_width), (3, lin), (g, pool), (ld, 4 * hidden),
        (ld, 4 * hidden), (hidden + 1, 5)])


def test_backward_takes_the_decoder_cell_at_the_encoder_boundary():
    """The last encoder step's carried ``dh`` comes through the decoder's
    ``W_hh`` (step g + 1's cell), the other steps' through their own: with
    the decoder's ``W_hh`` far from the encoder's (-3 times it) and its
    other weights drawn anew, the route's gradients equal autograd's
    through the grid route within 1e-12 of each leaf's largest, f64, at
    ``start_length`` 0 and 5 (8 and 3 encoder steps)."""
    model = _model()
    params = _params(model)
    with torch.no_grad():
        params["decoder"]["w_hh"].copy_(-3.0 * params["encoder"]["w_hh"])
    leaves = _leaves(params)
    xy, mask = _batch(s=3, a=4, seed=6)
    for start_length in (0, 5):
        grads = []
        for fused in (True, False):
            rel, pred, _ = _forward(model, params, xy, mask, start_length, fused)
            grads.append(torch.autograd.grad((rel ** 2).sum() + pred.sum(), leaves,
                                             materialize_grads=True))
        for got, want in zip(*grads):
            assert _relative(got, want) <= OWN_TOL


@pytest.mark.parametrize("where", ["fused_train_cell", "fused_train_cell_backward", "route",
                                   "row"])
def test_a_hidden_state_above_the_kernels_limit(where):
    """``MAX_HIDDEN`` + 1 units: each cell wrapper raises, naming the limit
    (it runs at ``MAX_HIDDEN``), and such a model keeps its step routes
    (``LSTM.takes_fused_train`` false) while one at the limit takes the
    route; the same for a row of xh longer than ``MAX_ROW``."""
    limit = fused_train.MAX_HIDDEN
    if where == "row":
        row = fused_train.MAX_ROW
        fused_train.fused_train_cell(**_cell_args(rows=2, ld=row))
        with pytest.raises(ValueError, match=f"at most {row}"):
            fused_train.fused_train_cell(**_cell_args(rows=2, ld=row + 1))
        for pool_dim, want in ((row - 8 - 17, True), (row - 8 - 16, False)):
            model = LSTM(pool=_model(out_dim=pool_dim).pool, embedding_dim=8, hidden_dim=16)
            assert model.takes_fused_train(True, True, dtype=torch.float32) is want
        return
    if where == "route":
        for hidden, want in ((limit, True), (limit + 1, False)):
            model = LSTM(pool=_model().pool, embedding_dim=8, hidden_dim=hidden)
            assert model.fused_train is want
            assert model.takes_fused_train(True, True, dtype=torch.float32) is want
        return
    make = _cell_args if where == "fused_train_cell" else _backward_args
    kw = dict(hidden=limit, ld=limit + 25) if where == "fused_train_cell" else dict(hidden=limit)
    getattr(fused_train, where)(**make(rows=2, **kw))
    kw["hidden"] = limit + 1
    if "ld" in kw:
        kw["ld"] += 1
    with pytest.raises(ValueError, match=f"1 to {limit} hidden units"):
        getattr(fused_train, where)(**make(rows=2, **kw))


# --------------------------------------------------------------------- loss
@pytest.mark.parametrize("targets_dtype", [torch.float64, torch.float32])
def test_fused_loss_matches_prediction_loss(targets_dtype):
    """``fused_train.prediction_loss`` of a rollout's ``rel`` against
    ``losses.prediction_loss`` of its primaries' last 12 steps: the value
    and the gradient of the whole ``rel`` (zero off those steps, and in a
    padded scene), f64, within 1e-12; f32 targets promoted as the plain
    loss promotes them."""
    rng = np.random.default_rng(9)
    rel = rng.normal(size=(19, 6, 4, 5))
    rel[..., 2:4] = 0.01 + 0.2 / (1 + np.exp(-rel[..., 2:4]))
    rel[..., 4] = 0.7 / (1 + np.exp(-rel[..., 4]))
    rel = torch.tensor(rel, requires_grad=True)
    targets = torch.tensor(rng.normal(scale=0.2, size=(12, 6, 2)), dtype=targets_dtype)
    scenes = torch.tensor([True, True, False, True, True, False])
    up = torch.tensor(3.0, dtype=torch.float64)
    got = fused_train.prediction_loss(rel, targets, scenes)
    (d_got,) = torch.autograd.grad(got * up, rel)
    want = losses.prediction_loss(rel[-12:, :, 0], targets, scenes)
    (d_want,) = torch.autograd.grad(want * up, rel)
    assert got.dtype == torch.float64
    assert abs(float(got.detach()) - float(want.detach())) <= OWN_TOL * abs(float(want.detach()))
    assert _relative(d_got, d_want) <= OWN_TOL
    assert not d_got[:-12].any() and not d_got[:, :, 1:].any() and not d_got[:, 2].any()


def test_fused_loss_counts_no_padded_scene():
    """Every scene padded: the plain loss's clamp of the count to one, a zero
    loss and a zero gradient."""
    rel = torch.zeros(19, 2, 3, 5, dtype=torch.float64, requires_grad=True)
    targets = torch.zeros(12, 2, 2, dtype=torch.float64)
    scenes = torch.zeros(2, dtype=torch.bool)
    loss = fused_train.prediction_loss(rel, targets, scenes)
    (grad,) = torch.autograd.grad(loss, rel)
    assert float(loss) == 0.0 and not grad.any()
    assert float(losses.prediction_loss(rel[-12:, :, 0], targets, scenes)) == 0.0


@pytest.mark.parametrize("case", ["every_scene_masked", "one_scene", "one_step"])
def test_plain_loss_at_the_edges_matches_both_losses(case):
    """The loss kernel's plain version at the edges of its cases: every scene
    masked (count 0, loss 0, dvals 0), one scene, P = 1.  Its loss equals
    ``losses.prediction_loss``'s and the JAX package's ``prediction_loss``'s
    on the primaries' last P normals, and dvals / max(count, 1) their
    gradients with respect to those normals, f64, within 1e-12."""
    s, p, scenes = {"every_scene_masked": (4, 12, [False] * 4), "one_scene": (1, 12, [True]),
                    "one_step": (3, 1, [True, False, True])}[case]
    rng = np.random.default_rng(11)
    rel = rng.normal(size=(19, s, 3, 5))
    rel[..., 2:4] = 0.01 + 0.2 / (1 + np.exp(-rel[..., 2:4]))
    rel[..., 4] = 0.7 / (1 + np.exp(-rel[..., 4]))
    targets = rng.normal(scale=0.2, size=(p, s, 2))
    mask = np.array(scenes)
    loss, count, dvals = (torch.zeros(shape, dtype=torch.float64) for shape in ((), (), (p, s, 5)))
    fused_train.fused_train_loss_plain(torch.tensor(rel), torch.tensor(targets),
                                       torch.from_numpy(mask), loss, count, dvals)
    assert float(count) == p * mask.sum()
    inputs = torch.tensor(rel[-p:, :, 0], requires_grad=True)
    want = losses.prediction_loss(inputs, torch.tensor(targets), torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(want, inputs)
    j_loss, j_grad = jax.value_and_grad(jlosses.prediction_loss)(
        jnp.asarray(rel[-p:, :, 0]), jnp.asarray(targets), jnp.asarray(mask))
    per_entry = dvals / max(float(count), 1.0)
    for w_loss, w_grad in ((float(want), grad), (float(j_loss), torch.tensor(np.asarray(j_grad)))):
        assert abs(float(loss) - w_loss) <= OWN_TOL * abs(w_loss)
        assert _relative(per_entry, w_grad) <= OWN_TOL
    if case == "every_scene_masked":
        assert float(loss) == 0.0 and not dvals.any()


# the loss backward's cases, (T', P, S, A): the train step's shape (A = 8,
# the kernel's float4 path), A = 5, 1 and 3 (its scalar path), P = T' and
# P = 1
LOSS_BACKWARD_CASES = [(19, 12, 8, 8), (19, 19, 3, 5), (12, 1, 1, 1), (19, 12, 2, 3)]


@pytest.mark.parametrize("masked", ["some", "every"])
@pytest.mark.parametrize("t_all,p,s,a", LOSS_BACKWARD_CASES)
def test_loss_backward_is_the_gradient_of_the_whole_rel(t_all, p, s, a, masked):
    """``fused_train_loss_backward`` (its plain version on the CPU), from the
    loss's own ``dvals`` and count, against the autograd gradient of
    ``losses.prediction_loss(rel[-P:, :, 0], ...)`` times an upstream
    gradient with respect to the whole ``rel``, f64, within 1e-12 of its
    largest magnitude; with ``every`` scene masked (count 0) all zero.
    ``d_rel`` starts as NaN, so every float of it is written."""
    rng = np.random.default_rng(13)
    rel = rng.normal(size=(t_all, s, a, 5))
    rel[..., 2:4] = 0.01 + 0.2 / (1 + np.exp(-rel[..., 2:4]))
    rel[..., 4] = 0.7 / (1 + np.exp(-rel[..., 4]))
    rel = torch.tensor(rel)
    targets = torch.tensor(rng.normal(scale=0.2, size=(p, s, 2)))
    scenes = torch.from_numpy(np.arange(s) % 3 != 2 if masked == "some" else np.zeros(s, bool))
    loss, count, dvals = (torch.zeros(shape, dtype=torch.float64) for shape in ((), (), (p, s, 5)))
    fused_train.fused_train_loss(rel, targets, scenes, loss, count, dvals)
    up = torch.tensor(1.7, dtype=torch.float64)
    d_rel = torch.full((t_all, s, a, 5), float("nan"), dtype=torch.float64)
    fused_train.fused_train_loss_backward(up, dvals, count, d_rel)
    leaf = rel.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        losses.prediction_loss(leaf[-p:, :, 0], targets, scenes) * up, leaf)
    assert _relative(d_rel, want) <= OWN_TOL
    if masked == "every":
        assert float(count) == 0.0 and not d_rel.any()


@pytest.mark.parametrize("agents,refused", [(21, False), (22, True)])
def test_loss_backward_refuses_more_floats_than_its_32_bit_index(agents, refused):
    """``fused_train_loss_backward`` raises where ``d_rel``'s T' S A 5
    floats pass 2^31 - 1 (its kernel's index math is 32-bit), from the
    shapes alone: tensors on the meta device, nothing allocated.  19 x 2^20
    x 21 x 5 is under the limit and gets past that check, to be refused
    only for its device."""
    meta = dict(device="meta", dtype=torch.float32)
    s = 2**20
    args = dict(d_loss=torch.empty((), **meta), dvals=torch.empty(12, s, 5, **meta),
                count=torch.empty((), **meta), d_rel=torch.empty(19, s, agents, 5, **meta))
    assert (19 * s * agents * 5 > fused_train.LOSS_BACKWARD_MAX_FLOATS) == refused
    with pytest.raises(ValueError, match="32-bit" if refused else "no kernel for device meta"):
        fused_train.fused_train_loss_backward(**args)


@pytest.mark.parametrize("criterion", ["pred", "L2"])
def test_vae_loss_follows_the_criterion(criterion):
    """The VAE trainer's ``pred`` reconstruction is ``FusedPredictionLoss``
    once a mode (its plain version on the CPU) and gives
    ``losses.prediction_loss``'s loss and gradients, within 1e-12 of each
    one's largest magnitude in f64; ``L2`` keeps its own loss."""
    from trajnetplusplusbaselines_torch.models.vae import VAE
    from trajnetplusplusbaselines_torch.trainers import vae as vae_trainer

    k, latent = 3, 8
    model = VAE(pool=_model().pool, embedding_dim=8, hidden_dim=16, num_modes=k,
                latent_dim=latent)
    params = model.init_params(torch.Generator().manual_seed(1), dtype=torch.float64)
    trainer = vae_trainer.Trainer(model, params, common.step_lr(1e-3, 10), criterion=criterion,
                                  batch_size=4, augment=False)
    xy, mask = _batch()
    scenes = torch.tensor([True, True, True, False])
    eps = torch.from_numpy(np.random.default_rng(3).normal(size=(k, *xy.shape[1:3], latent)))
    with mock.patch.object(fused_train.FusedPredictionLoss, "apply",
                           wraps=fused_train.FusedPredictionLoss.apply) as loss_fn:
        loss, reconstr, grads = trainer.loss_and_grads(xy, mask, scenes, eps=eps)
    assert loss_fn.call_count == (k if criterion == "pred" else 0)
    with mock.patch.object(fused_train, "prediction_loss", _plain_prediction_loss):
        want, want_reconstr, want_grads = trainer.loss_and_grads(xy, mask, scenes, eps=eps)
    for got, w in ((loss, want), (reconstr, want_reconstr), *zip(grads, want_grads)):
        assert _relative(got, w) <= OWN_TOL


def test_sharded_step_loss_follows_the_criterion():
    """``make_sharded_train_step``'s loss is ``FusedPredictionLoss`` on the
    gathered ``rel`` (its plain version on the CPU), once a step, after a
    rollout on the fused train route, and gives
    ``losses.prediction_loss``'s loss and every leaf's gradient within 1e-12
    of each one's largest magnitude in f64 (one process; the two-rank runs
    of ``tests/test_torch_parallel.py`` hold a mesh to one process)."""
    from trajnetplusplusbaselines_torch.parallel import make_sharded_train_step

    model = _model()
    params = _params(model)
    xy, mask = _batch()
    batch = (xy, mask, torch.zeros(xy.shape[1:], dtype=xy.dtype),
             torch.ones(xy.shape[1:3], dtype=torch.bool), torch.tensor([True, True, True, False]))
    step, _, place_params = make_sharded_train_step(model, common.make_optimizer, None,
                                                    batch_size=4)
    runs = []
    for plain in (False, True):
        with contextlib.ExitStack() as stack:
            rollout, loss_fn = (stack.enter_context(mock.patch.object(
                fn, "apply", wraps=fn.apply))
                for fn in (fused_train.FusedTrainRollout, fused_train.FusedPredictionLoss))
            if plain:
                stack.enter_context(mock.patch.object(fused_train, "prediction_loss",
                                                      _plain_prediction_loss))
            placed, _, loss = step(place_params(params), None, *batch)
        assert rollout.call_count == 1 and loss_fn.call_count == int(not plain)
        runs.append((loss, [leaf.grad for leaf in _leaves(placed)]))
    (loss, grads), (want, want_grads) = runs
    assert _relative(loss, want) <= OWN_TOL
    for g, w in zip(grads, want_grads):
        assert _relative(g, w) <= OWN_TOL


@pytest.mark.parametrize("entries,want", [(1, 32), (12, 32), (32, 32), (33, 64), (35, 64),
                                          (96, 96), (1000, 1024), (1024, 1024), (12288, 1024)])
def test_loss_threads_takes_a_warp_per_32_entries_up_to_1024(entries, want):
    """``fused_train_loss``'s block: the multiple of 32 at or above its
    entries (the train batch's 96: 96 threads), at most 1,024, where the
    threads stride over the entries."""
    assert fused_train.loss_threads(entries) == want
    assert want % 32 == 0 and want <= fused_train.LOSS_MAX_THREADS


# ------------------------------------------------------------------- checks
def _in_args(t=2, s=2, a=3, dtype=torch.float32):
    rows, lin, g, pool, ld = t * s * a, 6, 32, 16, 8 + 16 + 16 + 1
    return dict(obs1=torch.zeros(t, s, a, 2, dtype=dtype),
                obs2=torch.zeros(t, s, a, 2, dtype=dtype),
                present1=torch.ones(t, s, a, dtype=torch.bool),
                present2=torch.ones(t, s, a, dtype=torch.bool),
                grid=torch.zeros(rows, g, dtype=dtype),
                w_emb=torch.zeros(2, lin, dtype=dtype), b_emb=torch.zeros(lin, dtype=dtype),
                w_grid=torch.zeros(g, pool, dtype=dtype), b_grid=torch.zeros(pool, dtype=dtype),
                xh=torch.zeros(rows, ld, dtype=dtype), v4=torch.zeros(rows, 3, dtype=dtype),
                mask=torch.zeros(rows, dtype=torch.bool))


def _cell_args(rows=6, hidden=16, ld=41, dtype=torch.float32):
    z = lambda *shape: torch.zeros(*shape, dtype=dtype)  # noqa: E731
    return dict(xh=z(rows, ld), w_cell=z(ld, 4 * hidden), c=z(rows, hidden),
                mask=torch.ones(rows, dtype=torch.bool), obs2=z(rows, 2), w_h2n=z(hidden, 5),
                b_h2n=z(5), xh_next=z(rows, ld), c_next=z(rows, hidden),
                act=z(rows, 4 * hidden), tc=z(rows, hidden), sig=z(rows, 3), rel=z(rows, 5),
                pred=z(rows, 2))


def _backward_args(rows=6, hidden=16, dtype=torch.float32):
    z = lambda *shape: torch.zeros(*shape, dtype=dtype)  # noqa: E731
    return dict(d_rel=z(rows, 5), d_pred=z(rows, 2), mask=torch.ones(rows, dtype=torch.bool),
                sig=z(rows, 3), act=z(rows, 4 * hidden), tc=z(rows, hidden), c=z(rows, hidden),
                w_h2n=z(hidden, 5), dg_next=z(rows, 4 * hidden),
                w_hh_next=z(hidden + 1, 4 * hidden)[1:], dh=z(rows, hidden),
                dc=z(rows, hidden), dg=z(rows, 4 * hidden), draw=z(rows, 5))


WRAPPERS = {
    "fused_train_in": (fused_train.fused_train_in, _in_args),
    "fused_train_cell": (fused_train.fused_train_cell, _cell_args),
    "fused_train_cell_backward": (fused_train.fused_train_cell_backward, _backward_args),
    "fused_train_in_backward": (fused_train.fused_train_in_backward,
                                lambda: dict(dx=torch.zeros(6, 24), xh=torch.zeros(6, 41))),
    "fused_train_loss": (fused_train.fused_train_loss, lambda: dict(
        rel=torch.ones(19, 2, 3, 5) * 0.5, targets=torch.zeros(12, 2, 2),
        scene_mask=torch.ones(2, dtype=torch.bool), loss=torch.zeros(()), count=torch.zeros(()),
        dvals=torch.zeros(12, 2, 5))),
    "fused_train_loss_backward": (fused_train.fused_train_loss_backward, lambda: dict(
        d_loss=torch.ones(()), dvals=torch.zeros(12, 2, 5), count=torch.ones(()),
        d_rel=torch.zeros(19, 2, 3, 5))),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("fault", ["dtype", "device", "shape", "mask_dtype"])
def test_wrappers_raise_on_what_the_kernel_does_not_take(name, fault):
    """Each wrapper runs on well-formed arguments and raises on a wrong
    dtype, a tensor on another device, a wrong shape, a mask that is not
    bool; it never computes around them."""
    fn, make = WRAPPERS[name]
    fn(**make())  # well-formed: runs the plain version on the CPU
    args = make()
    key = next(k for k in args if k not in ("mask", "present1", "present2"))
    if fault == "dtype":
        args[key] = args[key].double()
        error = (TypeError, ValueError)
    elif fault == "device":
        args[key] = args[key].to("meta")
        error = (ValueError,)
    elif fault == "shape":
        args[key] = args[key][:1] if args[key].dim() else args[key].reshape(1)
        error = (ValueError,)
    else:  # a mask that is not bool, or a bool where the kernel takes floats
        bools = [k for k, v in args.items() if v.dtype == torch.bool]
        last = list(args)[-1]
        if bools:
            args[bools[0]] = args[bools[0]].float()
        else:
            args[last] = args[last].bool()
        error = (TypeError, ValueError)
    with pytest.raises(error):
        fn(**args)


def test_wrappers_raise_on_no_rows_and_on_a_short_row():
    with pytest.raises(ValueError, match="one row or more"):
        fused_train.fused_train_cell(**_cell_args(rows=0))
    with pytest.raises(ValueError, match="wider"):
        args = _in_args()
        args["xh"] = torch.zeros(12, 24)
        fused_train.fused_train_in(**args)


@pytest.mark.parametrize("name,shape", [("grid", (12, 31)), ("grid", (6, 32)),
                                        ("w_grid", (31, 16)), ("w_grid", (32, 15))])
def test_fused_train_in_raises_on_a_grid_or_w_grid_of_the_wrong_shape(name, shape):
    """``fused_train_in`` takes ``grid`` [T S A, G] and ``w_grid`` [G, P]
    with G and P those of the other arguments (``w_grid`` names them), and
    raises on any other, naming the grid or its weights."""
    args = _in_args()
    args[name] = torch.zeros(shape)
    with pytest.raises(ValueError, match="grid"):
        fused_train.fused_train_in(**args)


def test_counters_are_in_the_graph_bookkeeping():
    """Each kernel's launch counter is one of ``graphs.COUNTERS``, so that a
    CUDA graph replay adds what its capture's wrappers counted."""
    counters = {(fn, attr) for fn, attr in graphs.COUNTERS}
    for kernel in fused_train.KERNELS:
        assert (kernel, "launches") in counters
    names = [fn.__name__ for fn, _ in graphs.COUNTERS[3:]]
    import chip_smoke

    assert tuple(names) == chip_smoke.TRAIN_KERNELS
    assert chip_smoke.COUNTER_NAMES[3:] == chip_smoke.TRAIN_KERNELS


@pytest.mark.parametrize("names,want", [
    (["fused_train_in"] + ["fused_train_cell"] * 8 + ["fused_train_in", "fused_train_cell"] * 11
     + ["fused_train_cell_backward"] * 19 + ["fused_train_in_backward", "directional_grid"],
     {"fused_train_in": 12, "fused_train_cell": 19, "fused_train_cell_backward": 19,
      "fused_train_in_backward": 1, "directional_grid": 1}),
    (["other", "fused_train_in_backward"], {"fused_train_in_backward": 1}),
])
def test_smoke_reads_the_fused_train_kernels_of_a_graph(names, want):
    """``chip_smoke.graph_kernel_nodes`` counts each fused train kernel's
    node once by its launch counter, backward and forward kernels apart."""
    import chip_smoke

    mangled = {"directional_grid": "_ZN12_GLOBAL__N_123directional_grid_kernelIfLb1EEEvPKT_",
               "other": "_ZN2at6native29vectorized_elementwise_kernelILi4E"}
    dot = 'digraph dot {\nsubgraph cluster_1 {\n'
    for i, name in enumerate(names):
        label = mangled.get(name, f"_ZN12_GLOBAL__N_1{len(name) + 7}{name}_kernelEPKfS1_")
        dot += (f'"graph_1_node_{i}" [\n\tlabel="{{KERNEL\\n| {{ID | {i}}}\n| {label}}}"];\n\n')
    dot += "}\n}\n"
    assert chip_smoke.graph_kernel_nodes(dot) == want


def test_backward_is_deterministic():
    """Two backward passes of one rollout give the same bits (no reduction
    depends on an order that changes between runs)."""
    model = _model()
    params = _params(model, dtype=torch.float32)
    leaves = _leaves(params)
    xy, mask = _batch(dtype=torch.float32)
    runs = []
    for _ in range(2):
        rel, pred, _ = _forward(model, params, xy, mask)
        runs.append(torch.autograd.grad(rel.sum() + pred.sum(), leaves, materialize_grads=True))
    for g, w in zip(*runs):
        assert torch.equal(g, w)
