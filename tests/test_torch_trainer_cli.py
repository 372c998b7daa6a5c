"""The port's trainer CLI on the CPU: train, checkpoint, resume, transfer.

Mirrors ``tests/test_trainers.py``'s LSTM flow through
``trajnetplusplusbaselines_torch.trainers.lstm --device cpu``, plus the
checkpoint round trip (the port's sidecar restores the same params and Adam
moments; a JAX sidecar's weights load without optax classes) and the flags
the port refuses.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.tools.plot_log import read_log
from trajnetplusplusbaselines_torch.ops.pooling import POOL_TYPES, make_pool
from trajnetplusplusbaselines_torch.trainers import lstm as trainer_cli
from trajnetplusplusbaselines_torch.utils import checkpoint as ckpt

from .helpers import make_synthetic_dataset
from .torch_parity import write_goal_files

TINY = ["--hidden-dim", "16", "--coordinate-embedding-dim", "8", "--pool_dim", "16",
        "--device", "cpu"]


@pytest.fixture
def data_tree(tmp_path, monkeypatch):
    make_synthetic_dataset(os.path.join(str(tmp_path), "DATA_BLOCK", "synthset"))
    monkeypatch.chdir(str(tmp_path))
    return str(tmp_path)


def _train(*flags):
    return trainer_cli.main(argv=["--path", "synthset", "--batch_size", "2", *TINY, *flags])


def test_cli_trains_checkpoints_and_resumes(data_tree):
    # (no --augment: a fresh rotation each epoch of 2 batches hides the fall)
    _train("--epochs", "2", "--type", "occupancy", "--n", "4", "--save_every", "1", "-o", "t1")
    out = "OUTPUT_BLOCK/synthset/lstm_occupancy_t1.pkl"
    for suffix in ("", ".state", ".epoch0", ".epoch1", ".epoch2", ".epoch1.state"):
        assert os.path.exists(out + suffix), suffix
    records = read_log(out + ".log")
    losses = [r["loss"] for r in records["train-epoch"]]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert len(records["val-epoch"]) == 2
    assert all(np.isfinite([r["loss"], r["test_loss"]]).all() for r in records["val-epoch"])

    # the predictor pickle serves through the port
    from trajnetplusplusbaselines_tpu.data import Reader

    predictor = ckpt.load_predictor(out)
    _, paths = next(Reader("DATA_BLOCK/synthset/test/synth.ndjson", scene_type="paths").scenes())
    assert predictor(paths, np.zeros((len(paths), 2)))[0][0].shape == (12, 2)

    # --load-full-state continues from the saved epoch, appending to the log
    trainer = _train("--epochs", "3", "--type", "occupancy", "--n", "4", "--save_every", "10",
                     "-o", "t1", "--load-full-state", out + ".state")
    records = read_log(out + ".log")
    assert [r["epoch"] for r in records["train-epoch"]] == [1, 2, 3]
    assert ckpt.load_state(out + ".state")["epoch"] == 3
    steps = {float(s["step"]) for s in trainer.optimizer.state.values()}
    assert steps == {6.0}  # 2 batches per epoch, 3 epochs of Adam steps


def test_cli_nonstrict_load(data_tree):
    _train("--epochs", "1", "--type", "vanilla", "-o", "t2")
    vanilla = ckpt.load_state("OUTPUT_BLOCK/synthset/lstm_vanilla_t2.pkl.state")["params"]
    trainer = _train("--epochs", "0", "--type", "occupancy", "--n", "4", "-o", "t3",
                     "--nonstrict-load-state", "OUTPUT_BLOCK/synthset/lstm_vanilla_t2.pkl.state")
    assert os.path.exists("OUTPUT_BLOCK/synthset/lstm_occupancy_t3.pkl")
    # the LSTM weights came over; the occupancy model's wider input and its
    # pool kept their own initialisation
    np.testing.assert_array_equal(trainer.params["hidden2normal"]["linear"]["w"].detach(),
                                  vanilla["hidden2normal"]["linear"]["w"])
    assert trainer.params["encoder"]["w_ih"].shape[0] == 8 + 16


def test_cli_directional_with_every_training_option(data_tree):
    trainer = _train("--epochs", "2", "--type", "directional", "--n", "4", "-o", "t4",
                     "--augment", "--augment_noise", "--normalize_scene", "--loss", "L2",
                     "--col_wt", "1.0", "--clip_grad", "0.5", "--step_size", "1",
                     "--sample", "0.75", "--start_length", "2")
    records = read_log("OUTPUT_BLOCK/synthset/lstm_directional_t4.pkl.log")
    assert len(records["train-epoch"]) == 2
    assert all(np.isfinite(r["loss"]) for r in records["train-epoch"] + records["val-epoch"])
    assert records["process"][0]["args"]["device"] == "cpu"
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)  # StepLR, epoch 1
    assert all(leaf.device.type == "cpu" for leaf in trainer.leaves)


# the --goals, social, attentionmlp, --obs_dropout, --bf16 and --remat cases
# were refusals until their paths were ported; they keep their ids and now
# train.  The ids of the others keep the ROADMAP item numbers of the time
# they were written.  --dp 2 was refused until multi-device training was
# ported; it keeps its id, and in one process (no process group of two) it
# raises, naming the launch that gives it its ranks.
@pytest.mark.parametrize("flags,match", [
    pytest.param(["--goals"], None, id="flags0-item 2"),
    pytest.param(["--obs_dropout"], None, id="flags1-item 11"),
    pytest.param(["--bf16", "--type", "directional", "--n", "4"], None, id="flags2-item 7"),
    pytest.param(["--remat"], None, id="flags3-item 7"),
    pytest.param(["--dp", "2"], "--dp 2 --tp 1 takes 2 processes, and this run has 1: "
                 "launch it as python -m torch.distributed.run --standalone --nproc_per_node 2 "
                 "-m trajnetplusplusbaselines_torch.trainers.lstm", id="flags4-item 10"),
    (["--orbax"], "Do not port"),
    pytest.param(["--type", "social", "--n", "4"], None, id="flags6-item 2"),
    pytest.param(["--type", "attentionmlp"], None, id="flags7-item 3"),
])
def test_cli_refuses_unported_flags(data_tree, flags, match):
    if match is None:
        write_goal_files("DATA_BLOCK/synthset")
        trainer = _train("--epochs", "1", "-o", "x", *flags)
        prefix = "lstm_goals" if "--goals" in flags else "lstm"
        kind = flags[flags.index("--type") + 1] if "--type" in flags else "vanilla"
        out = f"OUTPUT_BLOCK/synthset/{prefix}_{kind}_x.pkl"
        records = read_log(out + ".log")
        assert np.isfinite(records["train-epoch"][0]["loss"])
        assert np.isfinite([records["val-epoch"][0][k] for k in ("loss", "test_loss")]).all()
        assert trainer.model.goal_flag == ("--goals" in flags)
        assert trainer.obs_dropout == ("--obs_dropout" in flags)
        assert trainer.model.remat == ("--remat" in flags)
        assert trainer.model.compute_dtype == (torch.bfloat16 if "--bf16" in flags else None)
        assert all(leaf.dtype == torch.float32 for leaf in trainer.leaves)  # f32 masters
        assert ckpt.load_predictor(out).model.compute_dtype is None  # saved for f32 serving
        return
    error = RuntimeError if "--dp" in flags else NotImplementedError
    with pytest.raises(error, match=re.escape(match)):
        _train("--epochs", "1", "-o", "x", *flags)
    assert not os.path.exists("OUTPUT_BLOCK")  # refused before anything ran


def test_port_state_round_trip(data_tree):
    trainer = _train("--epochs", "1", "--type", "directional", "--n", "4", "-o", "rt")
    out = "OUTPUT_BLOCK/synthset/lstm_directional_rt.pkl"
    state = ckpt.load_state(out + ".state")
    assert state["epoch"] == 1 and ckpt.is_port_opt_state(state["opt_state"])
    assert set(state["opt_state"]) == set(trainer.paths)

    restored = trainer_cli.Trainer(trainer.model, ckpt.params_from_jax(state["params"]),
                                   trainer.lr_schedule)
    from trajnetplusplusbaselines_torch.trainers.common import adam_state_from_numpy

    adam_state_from_numpy(restored.optimizer, restored.paths, state["opt_state"])
    for a, b in zip(trainer.leaves, restored.leaves):
        assert torch.equal(a.detach(), b.detach())
        sa, sb = trainer.optimizer.state[a], restored.optimizer.state[b]
        assert float(sa["step"]) == float(sb["step"]) == 2.0
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_jax_state_loads_without_optax(data_tree):
    from trajnetplusplusbaselines_tpu.trainers import lstm as jax_trainer

    jax_trainer.main(argv=["--epochs", "1", "--path", "synthset", "--type", "vanilla",
                           "--batch_size", "2", "-o", "j1", "--hidden-dim", "16",
                           "--coordinate-embedding-dim", "8"])
    jstate = "OUTPUT_BLOCK/synthset/lstm_vanilla_j1.pkl.state"
    state = ckpt.load_state(jstate)
    assert not ckpt.is_port_opt_state(state["opt_state"])
    assert isinstance(state["opt_state"], ckpt.OptaxState)  # no optax class was made
    jparams = ckpt.load_predictor("OUTPUT_BLOCK/synthset/lstm_vanilla_j1.pkl").params
    np.testing.assert_array_equal(state["params"]["decoder"]["w_hh"],
                                  jparams["decoder"]["w_hh"].numpy())

    trainer = _train("--epochs", "1", "--type", "vanilla", "-o", "p1", "--load-state", jstate)
    got = trainer.params["decoder"]["w_hh"]
    assert got.dtype == torch.from_numpy(state["params"]["decoder"]["w_hh"]).dtype  # as stored
    assert not torch.equal(got.detach(), torch.from_numpy(state["params"]["decoder"]["w_hh"]))
    # --load-full-state resumes the JAX run: its Adam moments and step, then
    # epoch 2 (the JAX sidecar's optax state, converted)
    resumed = _train("--epochs", "2", "--type", "vanilla", "-o", "p1", "--load-full-state",
                     jstate)
    assert [r["epoch"] for r in read_log("OUTPUT_BLOCK/synthset/lstm_vanilla_p1.pkl.log")
            ["train-epoch"]] == [1, 2]
    steps = {float(st["step"]) for st in resumed.optimizer.state.values()}
    assert steps == {2.0 * 2}  # 2 batches an epoch, 2 epochs


def test_merge_params_nonstrict_matches_jax():
    import jax

    from trajnetplusplusbaselines_tpu.utils.checkpoint import merge_params_nonstrict as jmerge
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.pooling import make_pool
    from trajnetplusplusbaselines_torch.utils.convert import params_to_numpy

    args = types.SimpleNamespace(n=4, pool_dim=16, hidden_dim=16)
    gen = torch.Generator().manual_seed(0)
    loaded = params_to_numpy(LSTM(embedding_dim=8, hidden_dim=16).init_params(gen))
    init = LSTM(embedding_dim=8, hidden_dim=16,
                pool=make_pool("directional", args)).init_params(gen, dtype=torch.float64)
    merged, skipped = ckpt.merge_params_nonstrict(init, loaded)
    _, want_skipped = jmerge(jax.tree.map(lambda x: x.numpy(), init), loaded)
    assert sorted(skipped) == sorted(want_skipped)
    assert "pool/embedding/0/w" in skipped and "encoder/w_ih" in skipped
    assert merged["decoder"]["w_hh"].dtype == torch.float64
    np.testing.assert_array_equal(merged["decoder"]["w_hh"].numpy(), loaded["decoder"]["w_hh"])
    assert merged["pool"] is not None and torch.equal(merged["encoder"]["w_ih"],
                                                      init["encoder"]["w_ih"])


def test_make_pool():
    from trajnetplusplusbaselines_tpu.ops.pooling import POOL_TYPES as JPOOL_TYPES

    assert POOL_TYPES == JPOOL_TYPES
    assert make_pool("vanilla") is None
    pool = make_pool("directional", types.SimpleNamespace(n=4, cell_side=0.5, pool_dim=16))
    assert (pool.type_, pool.n, pool.cell_side, pool.out_dim) == ("directional", 4, 0.5, 16)
    assert make_pool("occupancy").n == 12
    # every type builds the configuration JAX's make_pool builds, from the
    # same trainer arguments and from the defaults
    from trajnetplusplusbaselines_tpu.ops.pooling import make_pool as jax_make_pool

    args = types.SimpleNamespace(hidden_dim=16, pool_dim=32, vel_dim=4, spatial_dim=8,
                                 attn_logit_cap=3.0, neigh=2, no_vel=True, mp_iters=2, n=4,
                                 front=True, embedding_arch="two_layer", layer_dims=[8],
                                 latent_dim=4, pool_constant=1, norm=0, cell_side=0.5)
    for name in POOL_TYPES[3:]:
        for a in (None, args):
            got, want = make_pool(name, a), jax_make_pool(name, a)
            assert type(got).__name__ == type(want).__name__
            attrs = {k: v for k, v in vars(want).items() if k != "scatter_impl"}
            assert {k: getattr(got, k) for k in attrs} == attrs, name
    with pytest.raises(ValueError):
        make_pool("grid")


@pytest.mark.parametrize("kind", POOL_TYPES)
def test_cli_trains_every_type(data_tree, kind):
    """Every --type trains an epoch on the CPU, and its pickle serves."""
    trainer = _train("--epochs", "1", "--type", kind, "--n", "4", "-o", "e")
    out = f"OUTPUT_BLOCK/synthset/lstm_{kind}_e.pkl"
    records = read_log(out + ".log")
    assert np.isfinite([records["train-epoch"][0]["loss"], records["val-epoch"][0]["loss"],
                        records["val-epoch"][0]["test_loss"]]).all()
    assert type(trainer.model.pool).__name__ == type(make_pool(kind)).__name__
    from trajnetplusplusbaselines_tpu.data import Reader

    _, paths = next(Reader("DATA_BLOCK/synthset/test/synth.ndjson", scene_type="paths").scenes())
    prediction = ckpt.load_predictor(out)(paths, np.zeros((len(paths), 2)))[0]
    assert prediction[0].shape == (12, 2) and np.isfinite(prediction[0]).all()


def test_cli_trains_with_goals(data_tree):
    """--goals reads goal_files/{train,val}, names its output lstm_goals_*,
    and its pickle serves through lstm_cli with the test goal files."""
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli

    write_goal_files("DATA_BLOCK/synthset")
    trainer = _train("--epochs", "2", "--type", "directional", "--n", "4", "--goals",
                     "--goal_dim", "6", "--augment", "-o", "g")
    out = "OUTPUT_BLOCK/synthset/lstm_goals_directional_g.pkl"
    losses = [r["loss"] for r in read_log(out + ".log")["train-epoch"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert trainer.model.goal_flag and trainer.params["goal_embedding"]["linear"]["w"].shape == (2, 4)
    table = lstm_cli.main(["--path", "synthset", "--output", out, "--device", "cpu"])
    assert table.results["lstm_goals_directional_g_modes1"][32] == 4
