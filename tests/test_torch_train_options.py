"""The training options of the port against the JAX package, on the CPU.

- ``--load-full-state`` of a JAX sidecar: the optax Adam state converted
  (``utils/checkpoint.adam_state_from_optax``) restores the moments and the
  step exactly, and the resumed epoch equals JAX's resumed epoch in f64, with
  and without ``--clip_grad``, for the LSTM and for the SGAN's two states;
- ``--obs_dropout`` (with ``--augment`` and ``--augment_noise``): one epoch
  of the host path, every draw from the numpy generator, equal to JAX's in
  f64, for the LSTM and the SGAN;
- ``--remat``: loss and gradients equal to the run without it, and to JAX's
  remat run;
- ``--bf16``: the plain bf16 grid bit-exact against eager JAX's bf16 grid
  (the jitted JAX grid's cells that differ are counted and pinned), a bf16
  train step against JAX's bf16 step and against the port's f32 step, f32
  masters, and a bf16 JAX pickle served by the port.
"""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_tpu.ops.pooling import make_pool as jmake_pool
from trajnetplusplusbaselines_tpu.tools.plot_log import read_log
from trajnetplusplusbaselines_tpu.trainers import common as jcommon
from trajnetplusplusbaselines_tpu.trainers import lstm as jlstm_cli
from trajnetplusplusbaselines_tpu.trainers import sgan as jsgan_cli
from trajnetplusplusbaselines_torch.ops.cuda import fused_step
from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling
from trajnetplusplusbaselines_torch.trainers import common
from trajnetplusplusbaselines_torch.trainers import lstm as lstm_cli
from trajnetplusplusbaselines_torch.trainers import sgan as sgan_cli
from trajnetplusplusbaselines_torch.utils import checkpoint as ckpt
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .helpers import make_synthetic_dataset
from .test_torch_train import _scenes
from .torch_parity import example_batch, jax_generative, port_model, step_inputs

EPOCH_TOL = 1e-8  # resumed and obs_dropout epochs against JAX, f64
REMAT_TOL = 1e-12  # remat against no remat, f64
JAX_REMAT_TOL = 1e-10  # the port's remat step against JAX's, f64
# a bf16 step against JAX's bf16 step: CPU addmm in bf16 (torch) and XLA's
# bf16 dot accumulate differently, and XLA may keep f32 inside a fusion
# (compared on the gradients: Adam's first update is about lr * sign(g), so
# a gradient entry near zero whose sign rounding flips moves it by 2 lr)
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_COSINE = 0.99
BF16_UPDATE_COSINE = 0.95  # tests/test_mixed_precision.py's bound
# a bf16 rollout served by the port against JAX's bf16 rollout: 12 steps of
# 3 significant digits on positions of a few metres
BF16_POSITION_ATOL = 0.05
# the cells where jitted JAX's bf16 grid differs from eager JAX's on
# step_inputs(seed, 64, 8) for seeds 0-3 (deliberate deviation: the port
# and its kernel hold to eager JAX, see ROADMAP Queue 3)
JITTED_BF16_GRID_DEVIATIONS = {"n12": 0, "n8": 0, "n12_front": 0, "n12_pool2": 0}

TINY = ["--path", "synthset", "--batch_size", "2", "--hidden-dim", "16",
        "--coordinate-embedding-dim", "8", "--pool_dim", "16", "--type", "directional",
        "--n", "4"]


@pytest.fixture
def data_tree(tmp_path, monkeypatch):
    make_synthetic_dataset(os.path.join(str(tmp_path), "DATA_BLOCK", "synthset"), n_scenes=6)
    monkeypatch.chdir(str(tmp_path))
    return str(tmp_path)


def _leaves_close(port_tree, jax_tree, tol):
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax_tree))
    got = [leaf.detach().numpy() for _, leaf in common.param_items(port_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)


def _jax_adam(sidecar, key="opt_state"):
    """(count, mu, nu) of the optax ``ScaleByAdamState`` in a JAX sidecar,
    read with optax's own classes."""
    with open(sidecar, "rb") as f:
        state = pickle.load(f)[key]
    found = [s for s in jax.tree.leaves(state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _restored_exactly(optimizer, paths, sidecar, key="opt_state"):
    """The port's Adam state after ``restore_optimizer`` is the JAX sidecar's
    moments and count, bit for bit, by parameter path."""
    adam = _jax_adam(sidecar, key)
    mu, nu = dict(common.param_items(adam.mu)), dict(common.param_items(adam.nu))
    restored = common.adam_state_to_numpy(optimizer, paths)
    assert set(restored) == set(mu) == set(paths)
    for path in paths:
        assert restored[path]["step"] == int(adam.count) > 0
        np.testing.assert_array_equal(restored[path]["exp_avg"], np.asarray(mu[path]))
        np.testing.assert_array_equal(restored[path]["exp_avg_sq"], np.asarray(nu[path]))


# ------------------------------------------------------- --load-full-state
@pytest.mark.parametrize("clip", [None, "0.05"])
def test_lstm_resumes_a_jax_sidecar(data_tree, clip):
    """JAX trains an epoch and writes its sidecar; the port restores its
    Adam state exactly and its resumed epoch equals JAX's resumed epoch."""
    flags = TINY + (["--clip_grad", clip] if clip else [])
    jlstm_cli.main(argv=[*flags, "--epochs", "1", "-o", "j"])
    sidecar = "OUTPUT_BLOCK/synthset/lstm_directional_j.pkl.state"
    state = ckpt.load_state(sidecar)
    assert state["epoch"] == 1 and not ckpt.is_port_opt_state(state["opt_state"])

    restored = lstm_cli.Trainer(port_model(JLSTM(pool=JGrid(
        type_="directional", hidden_dim=16, cell_side=0.6, n=4, out_dim=16), embedding_dim=8,
        hidden_dim=16)), params_from_jax(state["params"]), common.step_lr(1e-3, 10))
    lstm_cli.restore_optimizer(restored.optimizer, restored.paths, state["opt_state"])
    _restored_exactly(restored.optimizer, restored.paths, sidecar)

    jlstm_cli.main(argv=[*flags, "--epochs", "2", "-o", "j2", "--load-full-state", sidecar])
    trainer = lstm_cli.main(argv=[*flags, "--epochs", "2", "-o", "p2", "--device", "cpu",
                                  "--load-full-state", sidecar])
    assert [r["epoch"] for r in read_log("OUTPUT_BLOCK/synthset/lstm_directional_p2.pkl.log")
            ["train-epoch"]] == [2]
    want = ckpt.load_predictor("OUTPUT_BLOCK/synthset/lstm_directional_j2.pkl").params
    _leaves_close(trainer.params, jax.tree.map(lambda x: x.numpy(), want), EPOCH_TOL)


def test_sgan_resumes_both_jax_states(data_tree):
    """A JAX SGAN sidecar's generator and discriminator optax states restore
    exactly; a resumed epoch of generator steps (no noise, no
    discriminator: nothing drawn) equals JAX's."""
    flags = TINY + ["--noise_dim", "4", "--k", "1"]
    jsgan_cli.main(argv=[*flags, "--epochs", "1", "-o", "j"])
    sidecar = "OUTPUT_BLOCK/synthset/sgan_directional_j.pkl.state"
    resume = [*flags, "--no_noise", "--d_steps", "0", "--epochs", "2", "--load-full-state",
              sidecar]
    jsgan_cli.main(argv=[*resume, "-o", "j2"])
    trainer = sgan_cli.main(argv=[*resume, "-o", "p2", "--device", "cpu"])
    state = ckpt.load_state(sidecar)
    fresh = sgan_cli.Trainer(trainer.model, params_from_jax(state["params"]),
                             common.step_lr(1e-3, 10), common.step_lr(1e-3, 10))
    for key, optimizer, paths in (("g_opt_state", fresh.g_optimizer, fresh.g_paths),
                                  ("d_opt_state", fresh.d_optimizer, fresh.d_paths)):
        lstm_cli.restore_optimizer(optimizer, paths, state[key])
        _restored_exactly(optimizer, paths, sidecar, key)
    want = ckpt.load_predictor("OUTPUT_BLOCK/synthset/sgan_directional_j2.pkl").params
    _leaves_close(trainer.params, jax.tree.map(lambda x: x.numpy(), want), EPOCH_TOL)


def test_adam_state_from_optax_finds_adam_by_shape(tmp_path):
    """The Adam state is found in either chain (with or without the clip),
    and a state without one raises."""
    params = {"a": {"w": jnp.ones((2, 3))}, "b": [{"w": jnp.arange(2.0)}]}
    for clip in (None, 1.0):
        opt = jcommon.make_optimizer(1e-4, clip)
        state = opt.init(params)
        _, state = opt.update(params, state, params)
        path = str(tmp_path / "x.state")
        with open(path, "wb") as f:
            pickle.dump({"opt_state": jax.device_get(state)}, f)
        port = ckpt.adam_state_from_optax(ckpt.load_state(path)["opt_state"])
        assert sorted(port) == ["a/w", "b/0/w"]
        assert {s["step"] for s in port.values()} == {1.0}
        np.testing.assert_array_equal(port["b/0/w"]["exp_avg"],
                                      np.asarray(_jax_adam(path).mu["b"][0]["w"]))
    with pytest.raises(ValueError, match="no Adam state"):
        ckpt.adam_state_from_optax(ckpt.OptaxState(np.zeros(()), {}, (ckpt.OptaxState(),)))


# ------------------------------------------------------------ --obs_dropout
def _lstm_trainers(seed=5, **kwargs):
    jmodel = JLSTM(pool=JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=4,
                              out_dim=16), embedding_dim=8, hidden_dim=16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jmodel.init_params(jax.random.PRNGKey(0)))
    jtr = jlstm_cli.Trainer(jmodel, jparams, jcommon.make_optimizer(1e-4),
                            jcommon.step_lr(1e-3, 10), batch_size=3, seed=seed, **kwargs)
    tr = lstm_cli.Trainer(port_model(jmodel), params_from_jax(jax.tree.map(np.asarray, jparams)),
                          common.step_lr(1e-3, 10), batch_size=3, seed=seed, **kwargs)
    return jtr, tr


def test_lstm_obs_dropout_epoch_matches_jax(caplog):
    """One ``--obs_dropout --augment --augment_noise`` epoch: the same
    host-packed batches, rotations, noise and start lengths, trained in
    JAX's grouped order."""
    scenes = _scenes(8, [2, 3, 4, 3, 2, 4, 3, 6, 5, 7, 3, 2])
    jtr, tr = _lstm_trainers(obs_dropout=True, augment=True, augment_noise=True)
    jtr.train(jcommon.SceneDataset(scenes, None, 9, False), 0)
    with caplog.at_level("INFO"):
        tr.train(common.SceneDataset(scenes, 9, False), 0)
    _leaves_close(tr.params, jtr.params, EPOCH_TOL)
    assert tr.rng.integers(1 << 30) == jtr.rng.integers(1 << 30)  # the same draws
    logged = [r.msg for r in caplog.records if isinstance(r.msg, dict)
              and r.msg.get("type") == "obs-dropout"]
    start_lengths = logged[0]["start_lengths"]
    assert len(start_lengths) == 4 and all(0 <= sl <= 7 for sl in start_lengths)
    assert len(set(start_lengths)) > 1


def test_sgan_obs_dropout_epoch_matches_jax():
    """The SGAN's ``--obs_dropout --augment`` epoch: the host-packed batches
    in their shuffled order (no noise, generator steps only: nothing drawn
    but the numpy generator's)."""
    jmodel, jparams, params = jax_generative("sgan", seed=1, k=1, no_noise=True)
    jmodel.d_steps = 0
    opt = jcommon.make_optimizer(1e-4)
    kwargs = dict(criterion="pred", batch_size=3, augment=True, augment_noise=True,
                  obs_dropout=True, seed=4)
    jtr = jsgan_cli.Trainer(jmodel, jparams, opt, opt, jcommon.step_lr(1e-3, 10),
                            jcommon.step_lr(1e-3, 10), **kwargs)
    tr = sgan_cli.Trainer(port_model(jmodel), params, common.step_lr(1e-3, 10),
                          common.step_lr(1e-3, 10), **kwargs)
    scenes = _scenes(9, [2, 3, 4, 3, 2, 4, 3, 6, 5])
    jtr.train(jcommon.SceneDataset(scenes, None, 9, False), 0)
    tr.train(common.SceneDataset(scenes, 9, False), 0)
    _leaves_close(tr.params, jtr.params, EPOCH_TOL)


def test_epoch_batches_and_groups_match_jax():
    scenes = _scenes(10, [2, 3, 5, 4, 7, 3, 9, 2, 6])
    jds, ds = jcommon.SceneDataset(scenes, None, 9, False), common.SceneDataset(scenes, 9, False)
    jrng, rng = np.random.default_rng(3), np.random.default_rng(3)
    want = list(jds.epoch_batches(2, jrng, True, True))
    got = list(ds.epoch_batches(2, rng, True, True))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for field in ("xy", "mask", "goals", "num_agents"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    items = [(p, i % 2) for i, p in enumerate(got)]
    key = lambda it: (*it[0].xy.shape[1:3], it[1])  # noqa: E731
    assert list(common.group_batches(items, key)) == list(jcommon.group_batches(items, key))


# ------------------------------------------------------------------ --remat
def _remat_models(pool_type):
    args = types.SimpleNamespace(hidden_dim=16, pool_dim=24, spatial_dim=8, vel_dim=8,
                                 attn_logit_cap=None, cell_side=0.6, n=4, front=False,
                                 embedding_arch="one_layer", pool_constant=0, norm=0,
                                 layer_dims=[32], latent_dim=16)
    jmodel = JLSTM(pool=jmake_pool(pool_type, args), embedding_dim=8, hidden_dim=16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jmodel.init_params(jax.random.PRNGKey(0)))
    return jmodel, jparams, port_model(jmodel)


@pytest.mark.parametrize("pool_type", ["attentionmlp", "directional"])
def test_remat_is_value_and_gradient_neutral(pool_type):
    """tests/test_remat.py's check on the port: with each step checkpointed
    the loss and the gradients are those without, and JAX's remat run's."""
    jmodel, jparams, model = _remat_models(pool_type)
    rng = np.random.default_rng(0)
    xy = np.cumsum(rng.normal(scale=0.3, size=(21, 3, 4, 2)), axis=0)
    mask, goals, slot = np.ones((21, 3, 4), bool), np.zeros((3, 4, 2)), np.ones((3, 4), bool)

    def jloss(p):
        jxy, jmask = jnp.asarray(xy), jnp.asarray(mask)
        rel, _, valid = jmodel.forward(p, jxy[:9], jmask[:9], jnp.asarray(goals),
                                       jnp.asarray(slot), prediction_truth=jxy[9:20],
                                       prediction_truth_mask=jmask[9:20])
        return jnp.sum(jnp.where(valid[..., None], rel, 0.0) ** 2)

    jmodel.remat = True
    want, jgrads = jax.value_and_grad(jloss)(jparams)

    results = []
    for remat in (False, True):
        model.remat = remat
        params = params_from_jax(jax.tree.map(np.asarray, jparams))
        paths, leaves = zip(*common.param_items(params))
        for leaf in leaves:
            leaf.requires_grad_()
        x, m = torch.from_numpy(xy), torch.from_numpy(mask)
        rel, _, valid = model.forward(params, x[:9], m[:9], x[9:20], m[9:20],
                                      goals=torch.from_numpy(goals),
                                      slot_mask=torch.from_numpy(slot))
        loss = torch.sum(torch.where(valid[..., None], rel, 0.0) ** 2)
        results.append((loss, torch.autograd.grad(loss, leaves, materialize_grads=True)))
    (loss0, grads0), (loss1, grads1) = results
    np.testing.assert_allclose(loss1.item(), loss0.item(), atol=REMAT_TOL, rtol=0)
    for g0, g1 in zip(grads0, grads1):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=REMAT_TOL, rtol=0)
    np.testing.assert_allclose(loss1.item(), float(want), atol=JAX_REMAT_TOL, rtol=0)
    jflat = dict(common.param_items(jax.tree.map(np.asarray, jgrads)))
    for path, g in zip(paths, grads1):
        np.testing.assert_allclose(g.numpy(), jflat[path], atol=JAX_REMAT_TOL, rtol=0)


def test_remat_checkpoints_each_step_where_autograd_records(monkeypatch):
    from trajnetplusplusbaselines_torch.models import lstm as lstm_module

    _, jparams, model = _remat_models("directional")
    calls = []
    real = lstm_module.checkpoint
    monkeypatch.setattr(lstm_module, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model.remat = True
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    xy, mask = (torch.from_numpy(x) for x in example_batch(2, 3))
    model.forward(params, xy[:9], mask[:9], n_predict=12)
    assert not calls  # no leaf requires grad: nothing to recompute
    for leaf in common.param_items(params):
        leaf[1].requires_grad_()
    with torch.no_grad():
        model.forward(params, xy[:9], mask[:9], n_predict=12)
    assert not calls
    model.forward(params, xy[:9], mask[:9], n_predict=12)
    assert len(calls) == 19  # 8 encoder and 11 decoder steps


# ------------------------------------------------------------------- --bf16
GEOMETRIES = {"n12": dict(n=12), "n8": dict(n=8), "n12_front": dict(n=12, front=True),
              "n12_pool2": dict(n=12, pool_size=2)}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_bf16_grid_matches_eager_jax(name):
    """The port's bf16 grid (the grid stage's plain version, then the
    ``pool_size`` sum) is eager JAX's bf16 ``make_grid`` bit for bit; the
    cells where jitted JAX differs are counted and pinned."""
    geometry = GEOMETRIES[name]
    jpool = JGrid(type_="directional", cell_side=0.6, **geometry)
    pool = GridBasedPooling(type_="directional", cell_side=0.6, **geometry)
    jitted = jax.jit(lambda *a: jpool.make_grid(None, *a, {}))
    deviations = 0
    for seed in range(4):
        obs1, obs2, p1, p2 = step_inputs(seed, 64, 8, dtype=np.float32)
        jargs = (jnp.asarray(obs1, jnp.bfloat16), jnp.asarray(obs2, jnp.bfloat16),
                 jnp.asarray(p1), jnp.asarray(p2))
        with jax.disable_jit():
            want = np.asarray(jpool.make_grid(None, *jargs, {}).astype(jnp.float32))
        deviations += int((np.asarray(jitted(*jargs).astype(jnp.float32)) != want).sum())
        t1, t2 = (torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
                  for x in jargs[:2])
        m1, m2 = torch.from_numpy(p1), torch.from_numpy(p2)
        raw = fused_step.directional_grid(t1, t2, m1, m2, **pool.grid_stage_args)
        got = pool.make_grid(t1, t2, m1, m2, raw_grid=raw)
        assert raw.dtype == got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
        # the model's plain path (no grid stage) is the same grid
        assert torch.equal(pool.make_grid(t1, t2, m1, m2), got)
    assert deviations == JITTED_BF16_GRID_DEVIATIONS[name]


def _bf16_step_trainers(pool, compute_dtype):
    """A JAX and a port trainer of the same tiny f32 LSTM (``pool`` None or
    a directional grid) computing in ``compute_dtype``."""
    jpool = JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=4, out_dim=16) if pool \
        else None
    jmodel = JLSTM(pool=jpool, embedding_dim=16, hidden_dim=32)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          jmodel.init_params(jax.random.PRNGKey(0)))
    model = port_model(jmodel).with_dtype(torch.bfloat16 if compute_dtype else None)
    if compute_dtype is not None:
        jmodel.with_dtype(compute_dtype)
    jtr = jlstm_cli.Trainer(jmodel, params, jcommon.make_optimizer(), jcommon.step_lr(1e-3, 10),
                            batch_size=2, compute_dtype=compute_dtype)
    tr = lstm_cli.Trainer(model, params_from_jax(jax.tree.map(np.asarray, params)),
                          common.step_lr(1e-3, 10), batch_size=2)
    return jtr, tr


def _bf16_batch():
    rng = np.random.default_rng(0)
    xy = (rng.normal(size=(21, 2, 3, 2)).cumsum(0) * 0.3).astype(np.float32)
    return xy, np.ones((21, 2, 3), bool), np.zeros((2, 3, 2), np.float32), np.ones((2, 3), bool)


def _port_step(tr):
    """(loss, gradient, update) of one train step, flat."""
    xy, mask, goals, slot = (torch.from_numpy(x) for x in _bf16_batch())
    before = [leaf.detach().clone() for leaf in tr.leaves]
    batch = (xy, mask, torch.ones(2, dtype=torch.bool), goals, slot)
    grads = np.concatenate([g.numpy().ravel() for g in tr.loss_and_grads(*batch)[1]])
    loss = float(tr.train_step(*batch))
    assert all(leaf.dtype == torch.float32 for leaf in tr.leaves)  # f32 masters
    for state in tr.optimizer.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32
    delta = np.concatenate([(leaf.detach() - b).numpy().ravel()
                            for leaf, b in zip(tr.leaves, before)])
    return loss, grads, delta


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("pool", [False, True], ids=["vanilla", "directional"])
def test_bf16_step_matches_jax_bf16_step(pool):
    """One ``--bf16`` step of the port against one of JAX's, from the same
    f32 params and batch: losses within 1e-2 relative, gradients' cosine
    above 0.99, updates' above 0.95; masters and Adam state f32; the
    directional grid in bf16."""
    jtr, tr = _bf16_step_trainers(pool, jnp.bfloat16)
    xy, mask, goals, slot = (jnp.asarray(x) for x in _bf16_batch())
    batch = (xy, mask, goals, slot, jnp.ones(2, bool))
    base = jax.tree.map(np.asarray, jtr.params)
    jgrads = jax.grad(lambda p: jtr._loss_from_outputs(
        *jtr._forward_train(p, xy, mask, goals, slot, 0), xy, mask, batch[-1]))(jtr.params)
    (jparams, _), jloss = jtr._train_step_core()((jtr.params, jtr.opt_state), *batch, None)
    jdelta = np.concatenate([(np.asarray(a) - b).ravel() for a, b in
                             zip(jax.tree.leaves(jparams), jax.tree.leaves(base))])
    loss, grads, delta = _port_step(tr)
    assert abs(loss - float(jloss)) <= BF16_LOSS_RTOL * abs(float(jloss))
    assert _cosine(grads, np.concatenate([np.asarray(g).ravel()
                                          for g in jax.tree.leaves(jgrads)])) > BF16_GRAD_COSINE
    assert _cosine(delta, jdelta) > BF16_UPDATE_COSINE


@pytest.mark.parametrize("pool", [False, True], ids=["vanilla", "directional"])
def test_bf16_step_tracks_f32_step(pool):
    """tests/test_mixed_precision.py's criteria on the port: a bf16 step's
    loss within 5% (1 + |loss|) of the f32 step's, their updates' cosine
    above 0.95."""
    loss16, _, delta16 = _port_step(_bf16_step_trainers(pool, jnp.bfloat16)[1])
    loss32, _, delta32 = _port_step(_bf16_step_trainers(pool, None)[1])
    assert np.isfinite(loss16)
    assert abs(loss16 - loss32) < 0.05 * (1.0 + abs(loss32))
    assert _cosine(delta16, delta32) > 0.95


def test_bf16_jax_pickle_serves_in_bf16(tmp_path):
    """A JAX predictor pickle of a bf16 model loads as a bf16 model and
    serves in bf16, within bf16 resolution of JAX's bf16 rollout."""
    from trajnetplusplusbaselines_tpu.models.lstm import LSTMPredictor as JPredictor
    from trajnetplusplusbaselines_torch.models.lstm import compute_params

    jmodel = JLSTM(pool=JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=4,
                              out_dim=16), embedding_dim=8, hidden_dim=16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(2)))
    jmodel.with_dtype(jnp.bfloat16)
    path = str(tmp_path / "bf16.pkl")
    JPredictor(jmodel, jparams).save(None, path)
    predictor = ckpt.load_predictor(path)
    assert predictor.model.compute_dtype == torch.bfloat16
    assert predictor.params["encoder"]["w_ih"].dtype == torch.float32  # masters as saved

    xy, mask = example_batch(3, 4, seed=1)
    xy = xy.astype(np.float32)
    _, want, jvalid = jmodel.forward(jcommon.cast_compute(jparams, jnp.bfloat16),
                                     jnp.asarray(xy[:9]), jnp.asarray(mask[:9]),
                                     jnp.zeros((3, 4, 2)), jnp.ones((3, 4), bool), n_predict=12)
    with torch.no_grad():
        _, got, valid = predictor.model.forward(
            compute_params(predictor.model, predictor.params), torch.from_numpy(xy[:9]),
            torch.from_numpy(mask[:9]), n_predict=12)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))[valid.numpy()]
    assert err.max() <= BF16_POSITION_ATOL

    # the path-level API serves it too, its output in f32 for the writer
    from trajnetplusplusbaselines_tpu.data.rows import TrackRow

    paths = [[TrackRow(10 * f, p, float(xy[f, 0, p, 0]), float(xy[f, 0, p, 1]))
              for f in range(9)] for p in range(3)]
    out = predictor(paths, np.zeros((3, 2)))
    assert out[0][0].shape == (12, 2) and out[0][0].dtype == np.float32
    assert np.isfinite(out[0][0]).all()
