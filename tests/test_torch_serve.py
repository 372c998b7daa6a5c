"""Serving through the port: batched prediction, predictor pickles, the CLI.

A predictor pickle written by the JAX package loads without jax and serves
through the port's ``lstm_cli`` on the CPU; the ndjson it writes matches the
JAX package's at 1e-6 and the results table is the same.
"""

import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.data.rows import TrackRow
from trajnetplusplusbaselines_tpu.evaluator.learned import BatchedPredictor as JBatched
from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.models.lstm import LSTMPredictor as JPredictor
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_torch.evaluator.learned import BatchedPredictor
from trajnetplusplusbaselines_torch.models.lstm import LSTMPredictor
from trajnetplusplusbaselines_torch.utils.checkpoint import load_predictor, save_predictor
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .helpers import make_synthetic_dataset
from .torch_parity import flagship_params, port_model


def _scene_paths(rng, n_agents, t=9):
    xy = rng.normal(size=(t, n_agents, 2)).cumsum(axis=0) * 0.3
    paths = []
    for p in range(n_agents):
        first = int(rng.integers(0, 4)) if p else 0
        paths.append([TrackRow(10 * f, p + 1, float(xy[f, p, 0]), float(xy[f, p, 1]))
                      for f in range(first, t)])
    return paths


@pytest.mark.parametrize("normalize", [False, True])
def test_predict_dataset_matches_jax(normalize):
    rng = np.random.default_rng(4)
    # buckets 4, 8, 32 and a dynamic bucket above the largest (130 agents)
    scenes = [_scene_paths(rng, n) for n in (1, 3, 5, 3, 9, 20, 130)]
    goals = [np.zeros((len(s), 2)) for s in scenes]
    args = types.SimpleNamespace(pred_length=12, obs_length=9, normalize_scene=normalize)
    jmodel, jparams, params = flagship_params(seed=4)

    want = JBatched(JPredictor(jmodel, jparams), modes=2, batch_scenes=2).predict_dataset(
        scenes, goals, args)
    got = BatchedPredictor(LSTMPredictor(port_model(jmodel), params), modes=2, batch_scenes=2,
                           device="cpu").predict_dataset(scenes, goals, args)
    assert len(got) == len(want) == len(scenes)
    for g, w, paths in zip(got, want, scenes):
        assert sorted(g) == sorted(w) == [0, 1]
        assert g[0][0].shape == (12, 2) and g[0][1].shape == (12, len(paths) - 1, 2)
        np.testing.assert_allclose(g[0][0], w[0][0], atol=1e-8, rtol=0)
        np.testing.assert_allclose(g[0][1], w[0][1], atol=1e-8, rtol=0)
        np.testing.assert_allclose(g[1][0], w[1][0], atol=1e-8, rtol=0)
        assert len(g[1][1]) == len(w[1][1]) == 0


def test_bucket_plan_groups_and_pads_by_agent_bucket():
    from trajnetplusplusbaselines_tpu.data import batching
    from trajnetplusplusbaselines_torch.evaluator.learned import bucket_plan

    counts = [1, 3, 5, 3, 9, 20, 130, 2, 7, 4]
    plan = bucket_plan(counts, batch_scenes=2)
    assert sorted(i for _, _, chunk in plan for i in chunk) == list(range(len(counts)))
    assert [b for b, _, _ in plan] == sorted(b for b, _, _ in plan)  # ascending buckets
    for bucket, per_rollout, chunk in plan:
        assert per_rollout == max(1, 16 // max(bucket, 8))
        assert 1 <= len(chunk) <= per_rollout
        for i in chunk:
            assert bucket == max(batching.agent_bucket(counts[i]), counts[i])
    # 130 agents: a bucket of their own count, one scene per rollout
    assert (130, 1, [6]) in plan
    assert len(bucket_plan(counts, batch_scenes=64)) == len({b for b, _, _ in plan})


def _jax_pickle(path, pool_type="directional"):
    from trajnetplusplusbaselines_tpu.utils.checkpoint import save_predictor as jax_save

    pool = JGrid(type_=pool_type, hidden_dim=128, cell_side=0.6, n=12, out_dim=256)
    model = JLSTM(pool=pool, embedding_dim=64, hidden_dim=128)
    params = model.init_params(jax.random.PRNGKey(7))
    jax_save(JPredictor(model, params), None, path)
    return model, params


def _read_tracks(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_serves_a_jax_pickle(tmp_path, monkeypatch):
    from trajnetplusplusbaselines_tpu.evaluator import lstm_cli as jax_cli
    from trajnetplusplusbaselines_tpu.trainers import common
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli

    src = str(tmp_path / "src")
    make_synthetic_dataset(os.path.join(src, "synthset"), n_scenes=6, n_neighbours=4)
    pkl = str(tmp_path / "dlstm.pkl")
    _jax_pickle(pkl)
    # the JAX CLI's persistent compile cache would outlive this test
    monkeypatch.setattr(common, "enable_compilation_cache", lambda *a, **k: None)

    argv = ["--path", "synthset", "--output", pkl, "--data_root", src]
    tables, files = [], []
    for name, run in (("jax", lambda: jax_cli.main(argv + ["--cpu"])),
                      ("torch", lambda: lstm_cli.main(argv + ["--device", "cpu"]))):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        tables.append(run())
        files.append(_read_tracks("DATA_BLOCK/synthset/test_pred/dlstm_modes1/synth.ndjson"))

    want, got = files
    assert len(got) == len(want) == 6 * (1 + 12 * 5)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if "scene" in w:
            assert g == w
            continue
        gt, wt = g["track"], w["track"]
        assert {k: v for k, v in gt.items() if k not in "xy"} == \
            {k: v for k, v in wt.items() if k not in "xy"}
        np.testing.assert_allclose([gt["x"], gt["y"]], [wt["x"], wt["y"]], atol=1e-6)
    assert tables[1].results == tables[0].results
    assert tables[1].sub_results == tables[0].sub_results
    assert tables[1].collision_test == tables[0].collision_test
    assert tables[1].results["dlstm_modes1"][32] == 6  # every scene scored


def test_save_load_round_trip(tmp_path):
    jmodel, _, params = flagship_params(seed=8)
    model = port_model(jmodel)
    path = str(tmp_path / "port.pkl")
    save_predictor(LSTMPredictor(model, params), path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["predictor_class"] == "LSTMPredictor"
    assert isinstance(payload["params"]["encoder"]["w_ih"], np.ndarray)

    loaded = load_predictor(path)
    assert vars(loaded.model.pool) == vars(model.pool)
    assert loaded.model.fused and loaded.model.hidden_dim == 128
    assert torch.equal(loaded.params["pool"]["embedding"][0]["w"],
                       params["pool"]["embedding"][0]["w"])


def test_load_jax_pickle_keeps_config_and_params(tmp_path):
    path = str(tmp_path / "jax.pkl")
    jmodel, jparams = _jax_pickle(path)
    loaded = load_predictor(path)
    assert loaded.model.pool.type_ == "directional" and loaded.model.pool.n == 12
    assert loaded.model.embedding_dim == 64 and loaded.model.input_dim == jmodel.input_dim
    np.testing.assert_array_equal(loaded.params["decoder"]["w_hh"].numpy(),
                                  np.asarray(jparams["decoder"]["w_hh"]))


def test_load_predictor_refuses_what_is_not_ported(tmp_path):
    social = str(tmp_path / "social.pkl")
    _jax_pickle(social, pool_type="social")
    with pytest.raises(NotImplementedError):
        load_predictor(social)

    foreign = str(tmp_path / "foreign.pkl")
    with open(foreign, "wb") as f:
        pickle.dump({"predictor_class": "LSTMPredictor",
                     "model": types.SimpleNamespace(a=1), "params": {}}, f)
    with pytest.raises(pickle.UnpicklingError, match="unsupported class"):
        load_predictor(foreign)


def test_batched_predictor_moves_params_once():
    jmodel, _, params = flagship_params(seed=9, dtype=jnp.float32)
    pred = BatchedPredictor(LSTMPredictor(port_model(jmodel), params), device="cpu")
    args = types.SimpleNamespace(pred_length=12, obs_length=9)
    scenes = [_scene_paths(np.random.default_rng(0), 3)]
    pred.predict_dataset(scenes, [None], args)
    moved = pred._device_params
    pred.predict_dataset(scenes, [None], args)
    assert pred._device_params is moved
    assert moved["encoder"]["w_ih"].dtype == torch.float32


def test_driver_skips_existing_and_backfills(tmp_path, monkeypatch, capsys):
    """Skip-if-exists and --fill_missing, as in the JAX driver
    (tests/test_evaluator.py), on the port's single-process driver."""
    import shutil

    from trajnetplusplusbaselines_tpu.models.classical import constant_velocity
    from trajnetplusplusbaselines_torch.evaluator.driver import get_predictions, run_evaluation

    root = tmp_path / "DATA_BLOCK" / "synthset"
    make_synthetic_dataset(str(root))
    monkeypatch.chdir(tmp_path)
    args = types.SimpleNamespace(path="DATA_BLOCK/synthset/test_pred/", obs_length=9,
                                 pred_length=12, modes=1, labels=None, output=["/cv.pkl"],
                                 disable_collision=False, write_only=False)
    os.makedirs(args.path)
    calls = []

    def cv(paths, goal):
        calls.append(1)
        return constant_velocity.predict(paths, n_predict=12, obs_length=9)

    table = run_evaluation({"cv_modes1": cv}, args)
    overall = table.results["cv_modes1"][32:40]
    assert overall[0] == 4 and overall[1] == pytest.approx(0.0, abs=1e-6)  # CV is exact
    assert len(calls) == 4

    get_predictions({"cv_modes1": cv}, args)  # the dir exists: skipped
    assert len(calls) == 4 and "already exist" in capsys.readouterr().out
    for sub in ("test", "test_private"):
        shutil.copy(root / sub / "synth.ndjson", root / sub / "synth2.ndjson")
    args.fill_missing = True
    get_predictions({"cv_modes1": cv}, args)
    assert len(calls) == 8
    assert sorted(os.listdir(os.path.join(args.path, "cv_modes1"))) == \
        ["synth.ndjson", "synth2.ndjson"]
    assert not os.path.exists(os.path.join(args.path, "cv_modes1.tmp"))
