"""The port's ``classical_cli``, ``socialforce_eval`` and ``tools.get_dest``
against the JAX package's on a synthetic split, in f64 on the CPU, and the
ORCA library's build (under ``build/``, never in ``native/``)."""

import glob
import json
import os
import pickle
import threading

import numpy as np
import pytest

from trajnetplusplusbaselines_tpu.evaluator import classical_cli as jcli
from trajnetplusplusbaselines_tpu.models.classical import socialforce_eval as jsfe
from trajnetplusplusbaselines_tpu.tools import get_dest as jget_dest
from trajnetplusplusbaselines_torch.evaluator import classical_cli
from trajnetplusplusbaselines_torch.models.classical import orca, socialforce_eval
from trajnetplusplusbaselines_torch.tools import get_dest

from .helpers import make_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def written(root, model):
    """{(scene, pedestrian, frame): (x, y)} of a written prediction file."""
    rows = {}
    with open(os.path.join(root, "DATA_BLOCK/synthset/test_pred", model, "synth.ndjson")) as f:
        for line in f:
            track = json.loads(line).get("track")
            if track is not None:
                rows[(track["scene_id"], track["p"], track["f"])] = (track["x"], track["y"])
    return rows


def test_cli_writes_and_scores_like_jax(tmp_path, monkeypatch):
    """``classical_cli --cv --kf --sf --orca --device cpu``: CV and ORCA write
    JAX's files, social force within the writer's 0.01 m rounding, and the
    same scores; the KF (whose draws differ from JAX's) is written and
    scored, finite."""
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    for root in (port_root, jax_root):
        make_synthetic_dataset(str(root / "DATA_BLOCK" / "synthset"))
    monkeypatch.chdir(jax_root)
    want = jcli.main(["--path", "synthset", "--cv", "--sf", "--orca"])
    monkeypatch.chdir(port_root)
    got = classical_cli.main(["--path", "synthset", "--cv", "--kf", "--sf", "--orca",
                              "--device", "cpu"])

    models = ["cv", "sf", "sf_opt", "orca", "orca_opt"]
    assert sorted(os.listdir(port_root / "DATA_BLOCK/synthset/test_pred")) == sorted(
        m + "_modes1" for m in models + ["kf"])
    for model in models:
        g, w = written(port_root, model + "_modes1"), written(jax_root, model + "_modes1")
        assert sorted(g) == sorted(w) and len(g) == 4 * 3 * 12, model
        err = max(abs(a - b) for k in g for a, b in zip(g[k], w[k]))
        assert err <= (0.01 + 1e-9 if model.startswith("sf") else 0.0), (model, err)
        if not model.startswith("sf"):
            assert got.results[model + "_modes1"] == want.results[model + "_modes1"]
    kf = got.results["kf_modes1"][32:40]
    assert kf[0] == 4 and np.isfinite(kf[1:3]).all()
    assert got.results["cv_modes1"][33] == pytest.approx(0.0, abs=1e-6)  # CV is exact here


def _split(tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "DATA_BLOCK" / "synthset"))
    return os.path.join(root, "train", "synth.ndjson")


def test_get_dest_equals_jax(tmp_path):
    data = _split(tmp_path)
    assert get_dest.get_dest(data) == jget_dest.get_dest(data)
    get_dest.main(["--data", str(tmp_path / "DATA_BLOCK/synthset/*/synth.ndjson"),
                   "--goal_dir", str(tmp_path / "port_goals")])
    jget_dest.main(["--data", str(tmp_path / "DATA_BLOCK/synthset/*/synth.ndjson"),
                    "--goal_dir", str(tmp_path / "jax_goals")])
    files = sorted(os.path.relpath(f, tmp_path / "port_goals")
                   for f in glob.glob(str(tmp_path / "port_goals/*/*.pkl")))
    assert files == [f"{sub}/synth.pkl" for sub in ("test", "test_private", "train", "val")]
    for f in files:
        with open(tmp_path / "port_goals" / f, "rb") as a, open(tmp_path / "jax_goals" / f,
                                                                "rb") as b:
            assert pickle.load(a) == pickle.load(b)


@pytest.mark.parametrize("extra", [[], ["--interactions"], ["--dest_files", "GOALS"]])
def test_socialforce_eval_equals_jax(tmp_path, extra):
    """The tuning table: social force within 1e-10 m and ORCA equal to JAX's,
    with interpolated or true goals and with the interaction filter; the KF
    column (other draws) finite."""
    data = _split(tmp_path)
    if extra[:1] == ["--dest_files"]:
        extra = ["--dest_files", get_dest.generate_dest(data, str(tmp_path / "goals"))]
    args = ["--data", data, "--tau", "0.5", "--vo", "5.0", "--sigma", "0.3", *extra]
    got = socialforce_eval.main(args + ["--device", "cpu"])["synth"]
    want = [jsfe.main(args + ["--simulator", sim])["synth"] for sim in ("sf", "orca")]
    dest = "true" if "--dest_files" in extra else "interp"
    for index in (0, 1):  # average and final L2
        table = got[index]
        assert table["N"] == 4 and np.isfinite(table["kf"])
        assert table[f"sf_{dest}"] == pytest.approx(want[0][index][f"sf_{dest}"], abs=1e-10)
        assert table[f"orca_{dest}"] == want[1][index][f"orca_{dest}"]


def test_orca_builds_under_build_and_leaves_native_alone(tmp_path, monkeypatch):
    """The library lands in ``build/torch_orca/`` named by the source's and
    the flags' hash; ``native/`` is not written.  Two builds at once into
    an empty directory (parallel test workers) both load a whole library."""
    native = os.path.join(REPO, "native")

    def snapshot():
        return {f: os.stat(os.path.join(native, f)).st_mtime_ns for f in os.listdir(native)}

    before = snapshot()
    lib = orca.build()
    assert lib.parent == orca.ROOT / "build" / "torch_orca" and lib.exists()
    assert orca.ROOT == type(orca.ROOT)(REPO)
    assert snapshot() == before

    monkeypatch.setattr(orca, "BUILD_DIR", tmp_path / "orca")
    built, errors = [], []

    def build():
        try:
            built.append(orca.build())
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert built[0] == built[1] and os.listdir(tmp_path / "orca") == [built[0].name]
    assert snapshot() == before
