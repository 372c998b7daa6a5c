"""Multi-device training of the port, on the CPU under gloo.

The ranks are processes of ``tests/torch_dist_worker.py`` (two, or four for
the (2, 2) mesh), launched with a timeout; tiny widths, f64.  The data's
last batches are padded unevenly across the ranks: at batch 4 over dp 2,
the A=4 bucket's last batch holds 2 + 1 real scenes and the A=8 bucket's
1 + 0.

- the LSTM trainer at (dp, tp) = (2, 1), (1, 2) and (2, 2): two epochs
  equal the port's one-process run at 1e-9, with augmentation (the same
  draws on every rank) where the mesh has one of the two axes, and
  (2, 2), without augmentation, equals JAX's single-device ``Trainer`` at
  1e-8; under tensor parallelism each rank holds the column blocks of the
  leaves JAX's rule splits, and their Adam moments, and its teacher-forced
  rollouts take the fused train route on the gathered params;
- the SGAN at (2, 2), the VAE at (2, 1) and the ensemble at dp 2 equal their
  one-process runs at 1e-9;
- ``make_sharded_train_step``: three steps at tp 1 and 2 equal the
  one-process step at 1e-9; ``make_sharded_rollout`` over two ranks equals
  the one-process rollout;
- ``param_sharding_rule`` splits exactly the leaves JAX's rule splits;
- the trainer CLI under two ranks (``--dp 2``; ``--tp 2`` and its
  ``--load-full-state`` resume): the pickle, its sidecar and the log equal
  a one-process run's.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_tpu.parallel import mesh as jmesh
from trajnetplusplusbaselines_tpu.tools.plot_log import read_log
from trajnetplusplusbaselines_tpu.trainers import common as jcommon
from trajnetplusplusbaselines_tpu.trainers.lstm import Trainer as JTrainer
from trajnetplusplusbaselines_torch.parallel import mesh
from trajnetplusplusbaselines_torch.trainers import lstm as trainer_cli
from trajnetplusplusbaselines_torch.trainers.common import param_items
from trajnetplusplusbaselines_torch.utils import checkpoint as ckpt

from . import torch_dist_worker as worker
from .helpers import make_synthetic_dataset
from .torch_parity import jax_generative, jax_pool_model

TOL = 1e-9  # sharded against one process, f64
JAX_TOL = 1e-8  # against JAX's single-device trainer, f64
TWO_RANK_CASES = ("lstm_dp2", "lstm_tp2", "vae_dp2", "ensemble_dp2", "step_tp1", "step_tp2",
                  "rollout", "cli_dp2", "cli_tp2")
FOUR_RANK_CASES = ("lstm_dp2tp2", "sgan_dp2tp2")
CLI_SCENES = 5  # per subset: the last batch of 2 is one real scene and one padded
# the CLI trains in f32: the ranks' partial sums of a gradient round apart
# from one process's whole sum, which Adam's steps carry into the weights
CLI_TOL = 1e-6


def _inputs():
    return {"lstm": worker.initial_params("lstm"), "sgan": worker.initial_params("sgan"),
            "vae": worker.initial_params("vae"),
            "ensemble": [worker.initial_params("lstm", s) for s in (5, 6)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of both worlds, run once: (two-rank dir, four-rank dir,
    one-process CLI dir)."""
    two, four, one = (str(tmp_path_factory.mktemp(n)) for n in ("two", "four", "one"))
    for d in (two, four):
        with open(os.path.join(d, "inputs.pkl"), "wb") as f:
            pickle.dump(_inputs(), f)
    for d in (two, one):
        make_synthetic_dataset(os.path.join(d, "cli", "DATA_BLOCK", "synthset"),
                               n_scenes=CLI_SCENES)
    worker.launch(2, two, TWO_RANK_CASES)
    worker.launch(4, four, FOUR_RANK_CASES)
    return two, four, one


def _close(got, want, tol=TOL):
    got, want = param_items(got), param_items(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=path)


def _one_process(kind, **kw):
    epochs = kw.pop("epochs", 2)
    return worker.train_epochs(worker.trainer(kind, _inputs()[kind], **kw), epochs=epochs)


def _losses_close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("case,kw", [("lstm_dp2", {}), ("lstm_tp2", {"clip_grad": 0.05})])
def test_lstm_epochs_match_one_process(runs, case, kw):
    want, want_losses = _one_process("lstm", **kw)
    for rank in range(2):
        got = worker.result(runs[0], case, rank)
        _close(got[0], want)
        _losses_close(got[1], want_losses)


def test_lstm_dp2_tp2_matches_one_process_and_jax(runs):
    """(2, 2) without augmentation: the port's one-process run, and JAX's
    single-device ``Trainer`` from the same params and seed."""
    want, want_losses = _one_process("lstm", augment=False)
    for rank in range(4):
        got, losses = worker.result(runs[1], "lstm_dp2tp2", rank)
        _close(got, want)
        _losses_close(losses, want_losses)
    pool = JGrid(type_="directional", **worker.POOL)
    jtr = JTrainer(JLSTM(pool=pool, **worker.WIDTHS),
                   jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), _inputs()["lstm"]),
                   jcommon.make_optimizer(1e-4), jcommon.step_lr(1e-3, 10),
                   batch_size=worker.BATCH, augment=False, seed=7)
    from trajnetplusplusbaselines_tpu.data.rows import TrackRow

    ds = jcommon.SceneDataset(worker.scenes(row_class=TrackRow), None, 9, False)
    for epoch in range(2):
        jtr.train(ds, epoch)
    _close(got, jax.tree.map(np.asarray, jtr.params), JAX_TOL)


def test_tensor_parallel_ranks_hold_column_blocks_and_their_moments(runs):
    """At (1, 2) each rank holds its half of the columns of every leaf
    JAX's rule splits, with Adam moments of the block's shape; the gathered
    moments equal the one-process run's."""
    tr = worker.trainer("lstm", _inputs()["lstm"], clip_grad=0.05)
    worker.train_epochs(tr)
    want_state = tr._full_adam_state(tr.optimizer, tr.paths)
    jm = _jax_mesh(tp=2)
    for rank in range(2):
        _, _, shapes, state, _ = worker.result(runs[0], "lstm_tp2", rank)
        for path, leaf in zip(tr.paths, tr.leaves):
            split = _jax_splits(jm, leaf)
            block = (leaf.shape[0], leaf.shape[1] // 2) if split else tuple(leaf.shape)
            assert shapes[path] == (block, block, block), path
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(state[path][k], want_state[path][k], atol=TOL, rtol=0)
    assert sum(_jax_splits(jm, leaf) for leaf in tr.leaves) >= 5  # gates and pool embedding


def test_tensor_parallel_ranks_take_the_fused_train_route(runs):
    """At (1, 2) the trainer gathers the full params before ``forward``, so
    each rank's teacher-forced rollouts take the fused train route, one a
    train step, as one process's do; ``test_lstm_epochs_match_one_process``
    holds their result to one process's."""
    _, losses, _, _, rollouts = worker.result(runs[0], "lstm_tp2", 0)
    assert rollouts == sum(len(epoch) for epoch in losses) > 0
    assert worker.result(runs[0], "lstm_tp2", 1)[4] == rollouts


@pytest.mark.parametrize("case,kind,world", [("sgan_dp2tp2", "sgan", 4), ("vae_dp2", "vae", 2)])
def test_generative_epochs_match_one_process(runs, case, kind, world):
    want, want_losses = _one_process(kind)
    for rank in range(world):
        got, losses = worker.result(runs[0 if world == 2 else 1], case, rank)
        _close(got, want)
        _losses_close(losses, want_losses)


def test_ensemble_dp2_matches_one_process(runs):
    want, want_losses = _one_process("ensemble", epochs=1)
    for rank in range(2):
        got, losses = worker.result(runs[0], "ensemble_dp2", rank)
        _close(got, want)
        _losses_close(losses, want_losses)


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_train_step_matches_single_device(runs, tp):
    want, want_losses = worker.sharded_steps(_inputs()["lstm"], None, worker.step_batches())
    for rank in range(2):
        got, losses = worker.result(runs[0], f"step_tp{tp}", rank)
        np.testing.assert_allclose(losses, want_losses, rtol=TOL)
        _close(got, want)


def test_sharded_rollout_matches_single_device(runs):
    from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

    xy, mask, goals, slot, _ = worker.step_batches(s=6)[0]
    with torch.no_grad():
        want = worker.lstm_model().forward(
            params_from_jax(_inputs()["lstm"], dtype=torch.float64),
            torch.from_numpy(xy[:9]), torch.from_numpy(mask[:9]), goals=torch.from_numpy(goals),
            slot_mask=torch.from_numpy(slot), n_predict=12)
    for rank in range(2):
        got, placed = worker.result(runs[0], "rollout", rank)
        assert placed == (21, 3, 4, 2)  # this rank's half of the scenes
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-10, rtol=0)


def _jax_mesh(tp):
    return jmesh.make_mesh(8, tp=tp)


def _jax_splits(jm, leaf):
    spec = jmesh.param_sharding_rule(jm, (), jnp.zeros(tuple(leaf.shape))).spec
    return spec == jax.sharding.PartitionSpec(None, "model")


class _OneRank:
    """The (dp, tp) shape of a mesh, for the rule alone (no process group)."""

    def __init__(self, dp, tp):
        self.shape = {"data": dp, "model": tp}
        self.index = {"data": 0, "model": 0}


@pytest.mark.parametrize("model", ["flagship", "social", "sgan", "vae"])
@pytest.mark.parametrize("tp", [2, 4])
def test_param_sharding_rule_splits_what_jax_splits(model, tp):
    """The port's rule and JAX's, on the same params: the same leaves split."""
    if model == "flagship":
        jmodel = JLSTM(pool=JGrid(type_="directional", hidden_dim=128, cell_side=0.6, n=12,
                                  out_dim=256), embedding_dim=64, hidden_dim=128)
        params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    elif model == "social":
        params = jax.tree.map(np.asarray, jax_pool_model("social")[1])
    else:
        params = jax.tree.map(np.asarray, jax_generative(model)[1])
    jm, port = _jax_mesh(tp), _OneRank(8 // tp, tp)
    want = {p: _jax_splits(jm, leaf) for p, leaf in param_items(params)}
    got = {p: mesh.param_sharding_rule(port, p, leaf).split for p, leaf in param_items(params)}
    assert got == want and any(want.values())
    blocks = mesh.shard_params(port, params)
    for (path, leaf), (_, block) in zip(param_items(params), param_items(blocks)):
        assert block.shape == ((leaf.shape[0], leaf.shape[1] // tp) if want[path]
                               else leaf.shape), path


def _cli_one_process(one, *flags):
    cwd = os.getcwd()
    os.chdir(os.path.join(one, "cli"))
    try:
        return trainer_cli.main(argv=["--path", "synthset", *worker.CLI_TINY, *flags])
    finally:
        os.chdir(cwd)


def _same_outputs(got_root, want_root, name):
    """The pickle's params and the sidecar of ``name`` agree at ``CLI_TOL``,
    and so do the log's epoch records."""
    out = f"OUTPUT_BLOCK/synthset/{name}.pkl"
    got, want = (ckpt.load_state(os.path.join(r, "cli", out + ".state"))
                 for r in (got_root, want_root))
    assert got["epoch"] == want["epoch"]
    _close(got["params"], want["params"], CLI_TOL)
    assert set(got["opt_state"]) == set(want["opt_state"])
    for path, s in want["opt_state"].items():
        assert got["opt_state"][path]["step"] == s["step"]
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got["opt_state"][path][k], s[k], atol=CLI_TOL, rtol=0)
    served = [ckpt.load_predictor(os.path.join(r, "cli", out)) for r in (got_root, want_root)]
    _close(*(ckpt.params_to_numpy(p.params) for p in served), CLI_TOL)
    got_log, want_log = (read_log(os.path.join(r, "cli", out + ".log"))
                         for r in (got_root, want_root))
    for kind in ("train-epoch", "val-epoch"):
        assert len(got_log[kind]) == len(want_log[kind])
        for g, w in zip(got_log[kind], want_log[kind]):
            assert g["epoch"] == w["epoch"]
            np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-4)  # rounded to 5 digits


def test_cli_dp2_writes_what_one_process_writes(runs):
    two, _, one = runs
    want = _cli_one_process(one, "--epochs", "2", "--augment", "-o", "dp")
    for rank in range(2):
        np.testing.assert_allclose(worker.result(two, "cli_dp2", rank), want.epoch_losses,
                                   atol=CLI_TOL, rtol=0)
    _same_outputs(two, one, "lstm_directional_dp")
    log = read_log(os.path.join(two, "cli", "OUTPUT_BLOCK/synthset/lstm_directional_dp.pkl.log"))
    assert len(log["process"]) == 1 and log["process"][0]["args"]["dp"] == 2  # rank 0 logs


def test_cli_tp2_resume_keeps_each_rank_block(runs):
    """``--tp 2``, then ``--load-full-state`` under ``--tp 2``: the sidecar
    and pickle equal a one-process run and resume's; each rank keeps its
    column blocks and their moments after the resume."""
    two, _, one = runs
    _cli_one_process(one, "--augment", "--epochs", "1", "-o", "tp")
    _cli_one_process(one, "--augment", "--epochs", "2", "-o", "tpr", "--load-full-state",
                     "OUTPUT_BLOCK/synthset/lstm_directional_tp.pkl.state")
    _same_outputs(two, one, "lstm_directional_tp")
    _same_outputs(two, one, "lstm_directional_tpr")
    state = ckpt.load_state(os.path.join(one, "cli", "OUTPUT_BLOCK/synthset/"
                                              "lstm_directional_tpr.pkl.state"))
    jm = _jax_mesh(tp=2)
    full = dict(param_items(state["params"]))
    for rank in range(2):
        shapes = worker.result(two, "cli_tp2", rank)
        assert set(shapes) == set(full)
        for path, (leaf_shape, moment_shape) in shapes.items():
            leaf = full[path]
            want = ((leaf.shape[0], leaf.shape[1] // 2) if _jax_splits(jm, leaf)
                    else tuple(leaf.shape))
            assert leaf_shape == moment_shape == want, path


@pytest.mark.parametrize("kind", ["lstm", "sgan", "vae"])
def test_obs_dropout_with_a_mesh_raises(kind):
    """The host path of ``--obs_dropout`` is single-device: each trainer
    raises in its ``__init__``, as JAX's SGAN trainer does."""
    with pytest.raises(ValueError, match="single-device"):
        worker.trainer(kind, _inputs()[kind], mesh=_OneRank(2, 1), obs_dropout=True)


def test_batch_that_does_not_divide_over_data_raises():
    with pytest.raises(ValueError, match="must divide over data axis 2"):
        worker.trainer("lstm", _inputs()["lstm"], mesh=_OneRank(2, 1), batch_size=3)
