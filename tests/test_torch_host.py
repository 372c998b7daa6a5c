"""The port's copies of the host modules against the JAX package's.

``trajnetplusplusbaselines_torch/{data,metrics}`` and the evaluator's
``write_utils``, ``trajnet_evaluator``, ``design_table`` and driver helpers
are copies of the JAX package's numpy-only modules.  The same seeded
synthetic split goes through both: equal scenes and arrays, byte-identical
ndjson, equal evaluation tables.
"""

import contextlib
import json
import os
import pickle
import random
import types

import numpy as np
import pytest

from trajnetplusplusbaselines_torch import data as tdata
from trajnetplusplusbaselines_torch.evaluator import driver as tdriver
from trajnetplusplusbaselines_torch.evaluator import trajnet_evaluator as tevaluator
from trajnetplusplusbaselines_torch.evaluator import write_utils as twrite
from trajnetplusplusbaselines_tpu import data as jdata
from trajnetplusplusbaselines_tpu.evaluator import driver as jdriver
from trajnetplusplusbaselines_tpu.evaluator import trajnet_evaluator as jevaluator
from trajnetplusplusbaselines_tpu.evaluator import write_utils as jwrite

OBS, PRED = 9, 12


def write_split(root, seed=0, files=("alpha", "beta"), n_scenes=12):
    """A seeded TrajNet++ split under root: test/ (observed frames only),
    test_private/, train/ and val/ (21 frames), one ndjson per name in
    files; scenes of 1..9 agents, late-appearing agents, gaps, tags with
    subtypes; and goal_files/<subset>/<file>.pkl under root.  Returns
    root + "/test_pred/"."""
    rng = np.random.default_rng(seed)
    ped = 0
    for f_i, name in enumerate(files):
        full, observed, goals = [], [], {}
        for sid in range(n_scenes):
            frames = [(f_i * 100 + sid) * 1000 + 10 * t for t in range(OBS + PRED)]
            kind = int(rng.integers(1, 5))
            tag = [kind, sorted({int(x) for x in rng.integers(1, 5, size=rng.integers(0, 3))})]
            scene = {"scene": {"id": sid, "p": ped + 1, "s": frames[0], "e": frames[-1],
                               "fps": 2.5, "tag": tag}}
            full.append(scene)
            observed.append(scene)
            n = int(rng.integers(1, 10))
            for j in range(n):
                ped += 1
                start = rng.uniform(-4, 4, size=2)
                vel = rng.normal(scale=0.4, size=2)
                first = 0 if j == 0 else int(rng.choice([0, 0, 2, 5, 10]))
                gap = set() if j == 0 else set(rng.choice(OBS + PRED, size=2).tolist())
                for t in range(first, OBS + PRED):
                    if t in gap:
                        continue
                    x, y = (round(float(v), 2) for v in start + vel * t)
                    row = {"track": {"f": frames[t], "p": ped, "x": x, "y": y}}
                    goals[ped] = (x, y)
                    full.append(row)
                    if t < OBS:
                        observed.append(row)
        for subset, rows in (("test", observed), ("test_private", full), ("train", full),
                             ("val", full)):
            os.makedirs(os.path.join(root, subset), exist_ok=True)
            with open(os.path.join(root, subset, name + ".ndjson"), "w") as out:
                out.writelines(json.dumps(r) + "\n" for r in rows)
            os.makedirs(os.path.join(root, "goal_files", subset), exist_ok=True)
            with open(os.path.join(root, "goal_files", subset, name + ".pkl"), "wb") as out:
                pickle.dump(goals, out)
    return os.path.join(root, "test_pred/")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(str(tmp_path_factory.mktemp("host") / "synth"))


def _args(path, **kw):
    return types.SimpleNamespace(path=path, obs_length=OBS, pred_length=PRED, **kw)


@pytest.mark.parametrize("subset", ["test", "test_private"])
@pytest.mark.parametrize("scene_type", [None, "paths", "tags"])
def test_reader_scenes_match(split, subset, scene_type):
    path = split.replace("test_pred/", subset + "/") + "alpha.ndjson"
    got = list(tdata.Reader(path, scene_type=scene_type).scenes())
    want = list(jdata.Reader(path, scene_type=scene_type).scenes())
    assert got == want and len(got) == 12
    if scene_type == "paths":
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(tdata.Reader.paths_to_xy(g), jdata.Reader.paths_to_xy(w))


def _scene_arrays(split):
    reader = jdata.Reader(split.replace("test_pred/", "test_private/") + "beta.ndjson",
                          scene_type="paths")
    return [jdata.Reader.paths_to_xy(paths) for _, paths in reader.scenes()]


@pytest.mark.parametrize("kw", [{}, {"pad_scenes_to": 16}, {"bucket": 4},
                                {"buckets": (2, 4, 6)}])
def test_pack_scenes_matches(split, kw):
    scenes = _scene_arrays(split)
    rng = np.random.default_rng(1)
    goals = [rng.normal(size=(xy.shape[1], 2)) for xy in scenes]
    with pytest.warns(UserWarning) if kw.get("bucket") else contextlib.nullcontext():
        got = tdata.batching.pack_scenes(scenes, goals, **kw)
    with pytest.warns(UserWarning) if kw.get("bucket") else contextlib.nullcontext():
        want = jdata.batching.pack_scenes(scenes, goals, **kw)
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for n in (1, 4, 5, 128, 129):
        assert tdata.batching.agent_bucket(n) == jdata.batching.agent_bucket(n)
    values, mask = tdata.batching.nan_to_mask(scenes[0])
    np.testing.assert_array_equal(values, jdata.batching.nan_to_mask(scenes[0])[0])
    np.testing.assert_array_equal(tdata.batching.mask_to_nan(values, mask),
                                  jdata.batching.mask_to_nan(values, mask))


@pytest.mark.parametrize("with_goals", [False, True])
def test_center_inverse_and_drop_match(split, with_goals):
    rng = np.random.default_rng(2)
    for xy in _scene_arrays(split):
        if np.isnan(xy[OBS - 2:OBS, 0]).any():
            continue
        goals = rng.normal(size=(xy.shape[1], 2)) if with_goals else None
        got = tdata.augmentation.center_scene(xy, OBS, goals=goals)
        want = jdata.augmentation.center_scene(xy, OBS, goals=goals)
        assert len(got) == len(want) == (4 if with_goals else 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        centred, rotation, center = want[:3]
        np.testing.assert_array_equal(tdata.augmentation.inverse_scene(centred, rotation, center),
                                      jdata.augmentation.inverse_scene(centred, rotation, center))
        for g, w in zip(tdata.augmentation.drop_distant(xy), jdata.augmentation.drop_distant(xy)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tdata.augmentation.theta_rotation(xy, 0.3),
                                      jdata.augmentation.theta_rotation(xy, 0.3))


@pytest.mark.parametrize("subset,goals,sample", [
    ("/train/", True, 1.0), ("/val/", False, 1.0), ("/train/", False, 0.5),
    ("/missing_val/", True, 1.0)])
def test_prepare_data_matches(split, monkeypatch, subset, goals, sample):
    root = split.replace("test_pred/", "")
    monkeypatch.chdir(root)
    random.seed(3)
    got = tdata.prepare_data(root, subset=subset, sample=sample, goals=goals)
    random.seed(3)
    want = jdata.prepare_data(root, subset=subset, sample=sample, goals=goals)
    assert got == want


def _predictions(scenes, modes, seed):
    """Per scene, per mode, (primary [12, 2], neighbours [12, n, 2]) with a
    NaN neighbour track, as the predictors return them."""
    rng = np.random.default_rng(seed)
    out = []
    for _, _, paths in scenes:
        per_mode = []
        for m in range(modes):
            primary = rng.normal(size=(PRED, 2))
            neigh = rng.normal(size=(PRED, len(paths) - 1, 2)) if m == 0 else np.zeros((0,))
            if m == 0 and len(paths) > 2:
                neigh[:, 1] = np.nan
            per_mode.append((primary, neigh))
        out.append(per_mode)
    return out


@pytest.mark.parametrize("modes", [1, 3])
def test_write_predictions_byte_identical(split, tmp_path, modes):
    args = _args(split)
    for name in tdriver.list_test_datasets(split):
        _, t_scenes, _ = twrite.load_test_datasets(name, False, args)
        _, j_scenes, _ = jwrite.load_test_datasets(name, False, args)
        assert t_scenes == j_scenes
        preds = _predictions(j_scenes, modes, seed=len(name))
        for pkg, scenes, tag in ((twrite, t_scenes, "port"), (jwrite, j_scenes, "jax")):
            processed = [pkg.preprocess_test(s, OBS) for _, _, s in scenes]
            assert processed == [jwrite.preprocess_test(s, OBS) for _, _, s in j_scenes]
            pkg.write_predictions(preds, scenes, tag, name + ".ndjson", _args(str(tmp_path) + "/"))
        port = (tmp_path / "port" / (name + ".ndjson")).read_bytes()
        assert port and port == (tmp_path / "jax" / (name + ".ndjson")).read_bytes()


@pytest.mark.parametrize("modes", [1, 3])
def test_trajnet_evaluate_tables_equal(split, tmp_path, monkeypatch, modes):
    model = f"host_m{modes}"
    model_dir = os.path.join(split, f"{model}_modes{modes}")
    args = _args(split, output=[model + ".pkl"], modes=modes, labels=None)
    for name in tdriver.list_test_datasets(split):
        _, scenes, _ = jwrite.load_test_datasets(name, False, args)
        jwrite.write_predictions(_predictions(scenes, modes, seed=7), scenes,
                                 f"{model}_modes{modes}", name + ".ndjson", args)
    monkeypatch.chdir(tmp_path)
    got, want = tevaluator.trajnet_evaluate(args), jevaluator.trajnet_evaluate(args)
    assert got.results == want.results and got.sub_results == want.sub_results
    assert got.collision_test == want.collision_test
    assert got.as_text() == want.as_text()
    assert len(got.results[f"{model}_modes{modes}"]) == 40
    for f in os.listdir(model_dir):
        os.remove(os.path.join(model_dir, f))
    os.rmdir(model_dir)


def test_driver_helpers_match(split, tmp_path):
    assert tdriver.list_test_datasets(split) == jdriver.list_test_datasets(split) == ["alpha",
                                                                                     "beta"]
    src = split.replace("/synth/test_pred/", "")
    for pkg, tag in ((tdriver, "port"), (jdriver, "jax")):
        pkg.ensure_data_block(src, str(tmp_path / tag), ["synth"])
    for tag in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / tag / "synth")) == ["test", "test_private"]
        assert os.path.realpath(tmp_path / tag / "synth" / "test") == os.path.realpath(
            split.replace("test_pred/", "test"))


def test_writers_match():
    rows = [tdata.TrackRow(10, 3, 1.23456, -0.5), tdata.TrackRow(20, 4, 2.0, 3.0, 1, 7),
            tdata.SceneRow(1, 3, 10, 210, 2.5, [3, [1, 2]])]
    j_rows = [jdata.TrackRow(*r) if isinstance(r, tdata.TrackRow) else jdata.SceneRow(*r)
              for r in rows]
    assert [tdata.writers.trajnet(r) for r in rows] == [jdata.writers.trajnet(r) for r in j_rows]
    with pytest.raises(Exception, match="unknown row type"):
        tdata.writers.trajnet(("not", "a", "row"))
