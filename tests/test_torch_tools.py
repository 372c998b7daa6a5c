"""The port's tools against the JAX package's, on the CPU.

- ``create_validation``: the same split as JAX's, byte for byte;
- ``collect_results``: JAX's summary on a tree like
  ``tests/test_collect_results.py``'s, but for one deliberate deviation
  (pinned): under ``--merge`` a row whose prediction directory is gone keeps
  its recorded ``col_test``, where JAX resets it to "NA";
- ``plot_log`` reads the records JAX's reads and draws its plots;
  ``visualize_predictions`` writes its image; without matplotlib both raise,
  naming it;
- ``collision_gate --device cpu``: JAX's Pass/Fail on the same pickles; an
  interrupted gate prediction leaves no file behind, and the default device
  raises without a card;
- ``profile_train --device cpu`` writes a Chrome trace of its train steps,
  the grid stage's op in it.
"""

import json
import logging
import os
import sys

import jax
import pytest
import torch

from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.models.lstm import LSTMPredictor as JPredictor
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_tpu.tools import collect_results as jcollect
from trajnetplusplusbaselines_tpu.tools import collision_gate as jgate
from trajnetplusplusbaselines_tpu.tools import create_validation as jsplit
from trajnetplusplusbaselines_tpu.tools import plot_log as jplot
from trajnetplusplusbaselines_torch.evaluator import write_utils
from trajnetplusplusbaselines_torch.tools import (collect_results, collision_gate,
                                                  create_validation, plot_log, profile_train,
                                                  visualize_predictions)

from .helpers import linear_tracks, make_synthetic_dataset, write_ndjson_scene

SUBSETS = ("train", "val", "test", "test_private")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    make_synthetic_dataset(os.path.join(str(tmp_path), "DATA_BLOCK", "synthset"), n_scenes=6)
    monkeypatch.chdir(str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize("ratios", [("0.2", "0.0"), ("0.25", "0.25")])
def test_create_validation_is_jax_byte_for_byte(tmp_path, ratios):
    src = os.path.join(str(tmp_path), "src")
    make_synthetic_dataset(os.path.join(src, "synthset"), n_scenes=12)
    for name in ("more", "other"):  # files split in sorted order, one rng between them
        os.rename(os.path.join(src, "synthset", "val", "synth.ndjson"),
                  os.path.join(src, "synthset", "train", name + ".ndjson"))
        make_synthetic_dataset(os.path.join(src, "tmp"), n_scenes=5)
        os.rename(os.path.join(src, "tmp", "val", "synth.ndjson"),
                  os.path.join(src, "synthset", "val", "synth.ndjson"))
    outs = {}
    for name, module in (("jax", jsplit), ("port", create_validation)):
        out = os.path.join(str(tmp_path), name)
        module.main(["--path", "synthset", "--data_root", src, "--output_root", out,
                     "--val_ratio", ratios[0], "--test_ratio", ratios[1], "--seed", "3"])
        outs[name] = out
    files = 0
    for subset in SUBSETS:
        want_dir = os.path.join(outs["jax"], "synthset_split", subset)
        if not os.path.isdir(want_dir):
            assert not os.path.exists(os.path.join(outs["port"], "synthset_split", subset))
            continue
        assert sorted(os.listdir(want_dir)) == sorted(
            os.listdir(os.path.join(outs["port"], "synthset_split", subset)))
        for f in os.listdir(want_dir):
            with open(os.path.join(want_dir, f), "rb") as a, \
                    open(os.path.join(outs["port"], "synthset_split", subset, f), "rb") as b:
                assert a.read() == b.read(), (subset, f)
            files += 1
    assert files == (12 if ratios[1] != "0.0" else 6)


def _write_cv_predictions(names):
    """Constant-velocity prediction dirs ``names`` under test_pred/ (the
    port's driver)."""
    import types

    from trajnetplusplusbaselines_torch.evaluator.driver import get_predictions
    from trajnetplusplusbaselines_torch.models.classical import constant_velocity

    args = types.SimpleNamespace(path="DATA_BLOCK/synthset/test_pred/", obs_length=9,
                                 pred_length=12, modes=1)
    os.makedirs(args.path, exist_ok=True)
    get_predictions({n: lambda paths, goal: constant_velocity.predict(
        paths, n_predict=12, obs_length=9, device="cpu") for n in names}, args)


def test_collect_results_matches_jax(tree):
    _write_cv_predictions(["cv_seed1_modes1", "cv_seed2_modes1", "other_modes1"])
    with open("DATA_BLOCK/synthset/collision_gate.json", "w") as f:
        json.dump({"cv_seed1_modes1": "Pass"}, f)
    for name, module in (("jax", jcollect), ("port", collect_results)):
        summary = module.main(["--path", "synthset", "--out", name + ".json", "--cache",
                               os.path.join(tree, name + "_cache")])
        if name == "jax":
            want = summary
    assert summary == want
    with open("port.json") as f, open("jax.json") as g:
        assert json.load(f) == json.load(g)
    assert want["cv_seed*_modes1"]["col_test"] == {"pass": 1, "fail": 0, "na": 1}


def test_merge_keeps_a_recorded_gate_where_jax_resets_it(tree):
    """The one deliberate deviation: a merged row whose prediction dir is
    gone keeps its recorded ``col_test``; JAX's reads "NA" (the rest of the
    summary equal)."""
    _write_cv_predictions(["cv_seed1_modes1"])
    old = {"N": 1, "ade": 9.0, "fde": 9.0, "col_i": 0.0, "col_ii": 0.0, "topk_ade": 9.0,
           "topk_fde": 9.0, "nll": 0.0, "col_test": "Fail"}
    got = {}
    for name, module in (("jax", jcollect), ("port", collect_results)):
        with open(name + ".json", "w") as f:
            json.dump({"per_model": {"old_model_modes1": dict(old)}, "groups": {}}, f)
        module.main(["--path", "synthset", "--out", name + ".json", "--cache", "", "--merge"])
        with open(name + ".json") as f:
            got[name] = json.load(f)
    assert got["jax"]["per_model"]["old_model_modes1"]["col_test"] == "NA"
    assert got["port"]["per_model"]["old_model_modes1"]["col_test"] == "Fail"
    assert got["port"]["groups"]["old_model_modes1"]["col_test"] == {"pass": 0, "fail": 1,
                                                                    "na": 0}
    for doc in got.values():
        doc["per_model"]["old_model_modes1"].pop("col_test")
        doc["groups"]["old_model_modes1"].pop("col_test")
    assert got["port"] == got["jax"]


def _train_log(tree):
    from trajnetplusplusbaselines_torch.trainers import lstm as trainer_cli

    trainer_cli.main(argv=["--path", "synthset", "--epochs", "2", "--batch_size", "2",
                           "--hidden-dim", "16", "--coordinate-embedding-dim", "8",
                           "--device", "cpu", "-o", "p"])
    for handler in logging.getLogger().handlers[:]:
        handler.close()
    return "OUTPUT_BLOCK/synthset/lstm_vanilla_p.pkl.log"


def test_plot_log_reads_what_jax_reads_and_draws(tree):
    log = _train_log(tree)
    with open(log, "a") as f:
        f.write("not json\n")
    got, want = plot_log.read_log(log), jplot.read_log(log)
    assert got == want and len(got["train-epoch"]) == 2 and got["val-epoch"]
    plot_log.main(["--log_file", log, "--output", "curves"])
    for kind in ("loss", "epoch-time"):
        assert os.path.getsize(f"curves.{kind}.png") > 0


def test_visualize_predictions_writes_its_image(tree):
    _write_cv_predictions(["cv_modes1"])
    outs = visualize_predictions.visualize(
        "DATA_BLOCK/synthset/test_private/synth.ndjson",
        ["DATA_BLOCK/synthset/test_pred/cv_modes1/synth.ndjson"], n_scenes=2,
        output_prefix="viz")
    assert outs == ["viz.scene0.png", "viz.scene1.png"]
    assert all(os.path.getsize(o) > 0 for o in outs)


def test_plots_without_matplotlib_raise_naming_it(tree, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_log.plots("missing.log")
    with pytest.raises(ImportError, match="matplotlib"):
        visualize_predictions.visualize("a.ndjson", ["b.ndjson"])


def _collision_scene(start=8.0):
    """The head-on gate scene: two pedestrians walking at each other, the
    second from ``start`` metres ahead (at 6.4 they meet at the last
    observed frame)."""
    frames = list(range(0, 210, 10))
    tracks = (linear_tracks(1, 0.0, 0.0, 0.0, 0.4, frames)
              + linear_tracks(2, 0.05, start, 0.0, -0.4, frames))
    for subset in ("test", "test_private"):
        write_ndjson_scene(f"DATA_BLOCK/synthset/{subset}/collision_test.ndjson",
                           [{"id": 0, "p": 1, "s": 0, "e": 200, "tracks": tracks}])


def _jax_pickles(seeds=(0, 1, 2)):
    from trajnetplusplusbaselines_tpu.utils.checkpoint import save_predictor as jax_save

    paths = []
    for seed in seeds:
        model = JLSTM(pool=JGrid(type_="directional", hidden_dim=16, cell_side=0.6, n=4,
                                 out_dim=16), embedding_dim=8, hidden_dim=16)
        path = f"OUTPUT_BLOCK/synthset/lstm_directional_s{seed}.pkl"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jax_save(JPredictor(model, model.init_params(jax.random.PRNGKey(seed))), None, path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("start,verdicts", [(8.0, {"Pass"}), (6.4, {"Fail"})])
def test_collision_gate_matches_jax(tree, monkeypatch, start, verdicts):
    from trajnetplusplusbaselines_tpu.trainers import common as jcommon

    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda *a, **k: None)
    _collision_scene(start)
    pickles = _jax_pickles()
    want = jgate.main(["--path", "synthset", "--output", *pickles])
    os.rename("DATA_BLOCK/synthset/gate_pred", "jax_gate_pred")
    os.remove("DATA_BLOCK/synthset/collision_gate.json")
    got = collision_gate.main(["--path", "synthset", "--device", "cpu", "--output", *pickles])
    assert got == want and set(got.values()) == verdicts
    for name in got:
        with open(f"jax_gate_pred/{name}/collision_test.ndjson") as f, \
                open(f"DATA_BLOCK/synthset/gate_pred/{name}/collision_test.ndjson") as g:
            jax_rows = [json.loads(line) for line in f]
            port_rows = [json.loads(line) for line in g]
        assert len(port_rows) == len(jax_rows)
        for p, j in zip(port_rows, jax_rows):  # positions to the writer's rounding
            if "track" in j:
                assert abs(p["track"]["x"] - j["track"]["x"]) <= 0.011
                assert abs(p["track"]["y"] - j["track"]["y"]) <= 0.011
    assert not [d for d in os.listdir("DATA_BLOCK/synthset/gate_pred") if d.endswith(".tmp")]


def test_interrupted_gate_prediction_leaves_no_file(tree, monkeypatch):
    _collision_scene()
    pickle_path = _jax_pickles(seeds=(0,))[0]
    real = write_utils.write_predictions

    def interrupted(pred_list, scenes, model_name, dataset_name, args):
        real(pred_list[:0], scenes[:0], model_name, dataset_name, args)  # a partial write
        raise KeyboardInterrupt

    monkeypatch.setattr(write_utils, "write_predictions", interrupted)
    argv = ["--path", "synthset", "--device", "cpu", "--output", pickle_path]
    with pytest.raises(KeyboardInterrupt):
        collision_gate.main(argv)
    out = "DATA_BLOCK/synthset/gate_pred/lstm_directional_s0_modes1/collision_test.ndjson"
    assert not os.path.exists(out)
    monkeypatch.setattr(write_utils, "write_predictions", real)
    assert collision_gate.main(argv)["lstm_directional_s0_modes1"] in ("Pass", "Fail")
    assert os.path.exists(out)


def test_collision_gate_default_device_refuses_to_run_on_the_cpu(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collision_gate.main(["--path", "synthset", "--output", "x.pkl"])


def test_profile_train_writes_a_trace_of_the_grid_stage(tmp_path):
    path = profile_train.main(["--device", "cpu", "--steps", "2", "--scenes", "4",
                               "--agents", "4", "--trace_dir", str(tmp_path / "trace")])
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    # two traced steps of 19 grid stages each, forward only
    assert sum(n == "trajnet::directional_grid" for n in names) == 2 * 19
