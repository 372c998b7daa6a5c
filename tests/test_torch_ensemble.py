"""The seed-ensemble trainer of the port, on the CPU.

Member k of ``trainers/ensemble.EnsembleTrainer`` is the sequential
trainer's run of seed k (its init, plan and augmentation draws; f64, with
``--augment`` and a clip that bites); the ensemble from JAX's stacked
initial params matches JAX's ``EnsembleTrainer`` after an epoch; the
per-member clip, the member sidecars, ``--remat``, the auto-split on running
out of memory and the refusals; and the grid stage's custom op under
``torch.func.vmap`` against a loop over the members.
"""

import os
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_tpu.tools.plot_log import read_log
from trajnetplusplusbaselines_tpu.trainers import common as jcommon
from trajnetplusplusbaselines_tpu.trainers.ensemble import EnsembleTrainer as JEnsembleTrainer
from trajnetplusplusbaselines_torch.models.lstm import LSTM
from trajnetplusplusbaselines_torch.ops.cuda import fused_step
from trajnetplusplusbaselines_torch.ops.pooling import make_pool
from trajnetplusplusbaselines_torch.trainers import common, ensemble
from trajnetplusplusbaselines_torch.trainers import lstm as lstm_cli
from trajnetplusplusbaselines_torch.utils import checkpoint as ckpt
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .helpers import make_synthetic_dataset
from .test_torch_train import _scenes
from .torch_parity import TINY_POOL_ARGS, port_model, step_inputs

MEMBER_TOL = 1e-9  # member k against the sequential run of seed k, f64
JAX_TOL = 1e-8  # the ensemble against JAX's, f64
REMAT_TOL = 1e-12
SEEDS = [3, 7, 11]
SCENES = [2, 3, 4, 3, 2, 4, 3, 6, 5, 7]  # buckets A=4 (7 scenes), A=8 (3)


def _model(pool_type, remat=False):
    pool = (None if pool_type == "vanilla"
            else make_pool(pool_type, types.SimpleNamespace(**TINY_POOL_ARGS)))
    model = LSTM(pool=pool, embedding_dim=8, hidden_dim=16)
    model.remat = remat
    return model


def _members(model, seeds=SEEDS):
    """Each seed's params as the sequential trainer initialises them, f64."""
    return [model.init_params(torch.Generator().manual_seed(s), dtype=torch.float64)
            for s in seeds]


def _ensemble(model, members, seeds=SEEDS, **kwargs):
    stacked = ensemble.stack_params([ensemble.tree_map(lambda x: x.clone(), m) for m in members])
    return ensemble.EnsembleTrainer(model, stacked, common.step_lr(1e-3, 10), seeds,
                                    batch_size=3, **kwargs)


@pytest.mark.parametrize("pool_type", ["vanilla", "occupancy", "directional", "social",
                                       "attentionmlp"])
def test_member_is_the_sequential_run_of_its_seed(pool_type):
    """An epoch and a validation of the ensemble, and each seed's sequential
    epoch, with ``--augment --augment_noise`` and a clip that bites: member
    k's params are the sequential run's."""
    model = _model(pool_type)
    members = _members(model)
    kwargs = dict(augment=True, augment_noise=True, clip_grad=0.5)
    ens = _ensemble(model, members, **kwargs)
    ds = common.SceneDataset(_scenes(8, SCENES), 9, False)
    ens.train(ds, 0)
    ens.val(ds, 0)
    for k, seed in enumerate(SEEDS):
        seq = lstm_cli.Trainer(model, members[k], common.step_lr(1e-3, 10), batch_size=3,
                               seed=seed, **kwargs)
        seq.train(ds, 0)
        for (path, want), (_, got) in zip(common.param_items(seq.params),
                                          common.param_items(ens.params)):
            np.testing.assert_allclose(got[k].detach().numpy(), want.detach().numpy(),
                                       atol=MEMBER_TOL, rtol=0, err_msg=path)


def test_ensemble_matches_jax_ensemble_trainer():
    """From JAX's stacked initial params, converted: one epoch of the port's
    ensemble against JAX's ``EnsembleTrainer`` (its vmapped resident epoch),
    without augmentation."""
    jmodel = JLSTM(pool=JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=4,
                              out_dim=16), embedding_dim=8, hidden_dim=16)
    stacked = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), jax.vmap(jmodel.init_params)(
        jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])))
    params = params_from_jax(jax.tree.map(np.asarray, stacked))
    jtr = JEnsembleTrainer(jmodel, stacked, jcommon.make_optimizer(1e-4),
                           jcommon.step_lr(1e-3, 10), SEEDS, batch_size=3, augment=False)
    ens = ensemble.EnsembleTrainer(port_model(jmodel), params, common.step_lr(1e-3, 10), SEEDS,
                                   batch_size=3, augment=False)
    scenes = _scenes(8, SCENES)
    jtr.train(jcommon.SceneDataset(scenes, None, 9, False), 0)
    ens.train(common.SceneDataset(scenes, 9, False), 0)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtr.params))
    got = [leaf.detach().numpy() for _, leaf in common.param_items(ens.params)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[0] == len(SEEDS)
        np.testing.assert_allclose(g, w, atol=JAX_TOL, rtol=0)


def test_member_clip_equals_clipping_each_member_alone():
    rng = np.random.default_rng(4)
    grads = [torch.from_numpy(rng.normal(size=shape)) for shape in ((3, 4, 5), (3, 6))]
    grads[0][1] *= 0.01  # member 1 is under the bound, the others over it
    grads[1][1] *= 0.01
    clipped = common.clip_by_global_norm(grads, 2.0, members=True)
    for k in range(3):
        alone = common.clip_by_global_norm([g[k] for g in grads], 2.0)
        for got, want in zip(clipped, alone):
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), atol=1e-15, rtol=1e-14)
    assert torch.equal(clipped[0][1], grads[0][1])  # untouched under the bound


@pytest.mark.parametrize("pool_type", ["directional", "attentionmlp"])
def test_ensemble_remat_is_gradient_neutral(pool_type):
    """``--remat`` checkpoints the vmapped step: losses and gradients equal."""
    ds = common.SceneDataset(_scenes(8, SCENES), 9, False)
    results = []
    for remat in (False, True):
        model = _model(pool_type, remat)
        ens = _ensemble(model, _members(model))
        batch = next(ens._member_batches(ds, shuffle=False))
        results.append(ens.loss_and_grads(*batch))
    (loss0, grads0), (loss1, grads1) = results
    np.testing.assert_allclose(loss1.numpy(), loss0.numpy(), atol=REMAT_TOL, rtol=0)
    for g0, g1 in zip(grads0, grads1):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=REMAT_TOL, rtol=0)


@pytest.fixture
def data_tree(tmp_path, monkeypatch):
    make_synthetic_dataset(os.path.join(str(tmp_path), "DATA_BLOCK", "synthset"), n_scenes=6)
    monkeypatch.chdir(str(tmp_path))
    return str(tmp_path)


TINY = ["--path", "synthset", "--batch_size", "2", "--hidden-dim", "16",
        "--coordinate-embedding-dim", "8", "--pool_dim", "16", "--type", "directional",
        "--n", "4", "--device", "cpu"]


def test_cli_writes_members_that_resume_sequentially(data_tree):
    """``main`` writes each member's pickle, checkpoints and sidecar and logs
    one loss per member; a member's sidecar resumes under the sequential
    trainer."""
    seeds = ["5", "6"]
    ens = ensemble.main(argv=[*TINY, "--epochs", "1", "--seeds", *seeds, "--save_every", "1"])
    for seed in seeds:
        out = f"OUTPUT_BLOCK/synthset/lstm_directional_seed{seed}.pkl"
        for suffix in ("", ".state", ".epoch0", ".epoch1", ".epoch1.state"):
            assert os.path.exists(out + suffix), suffix
        assert ckpt.load_predictor(out).model.fused is False  # tiny widths: the grid route
    records = read_log("OUTPUT_BLOCK/synthset/lstm_directional_seed5_ensemble.pkl.log")
    (epoch,) = records["train-epoch"]
    assert epoch["seeds"] == [5, 6] and len(epoch["loss"]) == 2
    assert np.isfinite(epoch["loss"]).all() and np.isfinite(records["val-epoch"][0]["loss"]).all()

    sidecar = "OUTPUT_BLOCK/synthset/lstm_directional_seed6.pkl.state"
    state = ckpt.load_state(sidecar)
    assert state["epoch"] == 1 and ckpt.is_port_opt_state(state["opt_state"])
    np.testing.assert_array_equal(state["params"]["decoder"]["w_hh"],
                                  ens.params["decoder"]["w_hh"][1].detach().numpy())
    seq = lstm_cli.main(argv=[*TINY, "--epochs", "2", "--seed", "6", "-o", "r",
                              "--load-full-state", sidecar])
    steps = {float(s["step"]) for s in seq.optimizer.state.values()}
    assert steps == {2.0 * 3}  # 3 batches an epoch, resumed after the first epoch
    assert [r["epoch"] for r in read_log("OUTPUT_BLOCK/synthset/lstm_directional_r.pkl.log")
            ["train-epoch"]] == [2]


def test_cli_refuses_tensor_parallelism(data_tree):
    """--tp above 1 raises, as in JAX: the rule does not shard the stacked
    [E, ...] leaves; --dp 2 in one process raises, naming the launch."""
    with pytest.raises(ValueError, match="ensemble trainer supports --dp only"):
        ensemble.main(argv=[*TINY, "--tp", "2"])
    with pytest.raises(RuntimeError, match="--nproc_per_node 2 -m "
                                           "trajnetplusplusbaselines_torch.trainers.ensemble"):
        ensemble.main(argv=[*TINY, "--dp", "2"])
    assert not os.path.exists("OUTPUT_BLOCK")  # refused before anything ran


@pytest.mark.parametrize("error,splits", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("zoom level 3 is out of range"), False),
])
def test_autosplit_on_running_out_of_memory(data_tree, monkeypatch, error, splits):
    """Running out of the card's memory, matched by type, retrains the
    members in chunks of ceil(E / 2) and the rest, each in a subprocess of
    the module; an error whose text merely contains "oom" raises."""
    calls = []

    def fail(args, device, outputs):
        raise error

    monkeypatch.setattr(ensemble, "train_members", fail)
    monkeypatch.setattr(subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    argv = [*TINY, "--epochs", "1", "--seeds", "1", "2", "3", "4", "5"]
    if not splits:
        with pytest.raises(RuntimeError, match="zoom"):
            ensemble.main(argv=argv)
        assert not calls
        return
    assert ensemble.main(argv=argv) is None
    module = "trajnetplusplusbaselines_torch.trainers.ensemble"
    assert [cmd[1:3] for cmd in calls] == [["-m", module]] * 2
    assert [cmd[cmd.index("--seeds") + 1:] for cmd in calls] == [["1", "2", "3"], ["4", "5"]]
    assert all(cmd[3:cmd.index("--seeds")] == argv[:-6] for cmd in calls)
    with pytest.raises(RuntimeError, match="out of memory"):
        ensemble.main(argv=[*argv, "--no_autosplit"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_op_under_vmap_equals_a_loop_over_members(dtype):
    """The grid stage's custom op under ``torch.func.vmap``: its vmap rule
    folds the members into the scene axis of one call; the grid equals a
    loop over the members, bit for bit (on the CPU, the plain version)."""
    members = [step_inputs(seed, 6, 5, dtype=np.float32) for seed in range(4)]
    obs1, obs2, p1, p2 = (torch.from_numpy(np.stack(x)) for x in zip(*members))
    obs1, obs2 = obs1.to(dtype), obs2.to(dtype)
    kw = dict(n=4, cell_side=0.6, constant=0.25)
    got = torch.func.vmap(lambda *a: fused_step.directional_grid(*a, **kw))(obs1, obs2, p1, p2)
    want = torch.stack([fused_step.directional_grid(obs1[e], obs2[e], p1[e], p2[e], **kw)
                        for e in range(4)])
    assert got.shape == (4, 6, 5, 32) and got.dtype == dtype
    assert torch.equal(got, want)
    # an input shared by the members (in_dim None) is expanded, not folded
    shared = torch.func.vmap(lambda a, b: fused_step.directional_grid(a, b, p1[0], p2[0], **kw))(
        obs1, obs2)
    assert torch.equal(shared[2], fused_step.directional_grid(obs1[2], obs2[2], p1[0], p2[0],
                                                              **kw))
