"""The port's ``tools.eval_reference_checkpoint`` against the JAX package's.

The reference implementation is not in the repository, so a stand-in
``trajnetbaselines`` package laid out like it is written under ``tmp_path``:
a constant-velocity predictor per engine that reads its scene through
``trajnetplusplustools.Reader.paths_to_xy`` (the stub), loaded by
``torch.load`` like the reference's.  One checkpoint loads under torch's
weights-only unpickler with the predictor class admitted; the other holds a
numpy array, so only the ``weights_only=False`` retry loads it.  On a
synthetic split the port's tool writes the JAX tool's files byte for byte and
scores them the same.  The JAX tool runs in a subprocess, with the stand-in
on ``PYTHONPATH``: its ``load_reference`` registers the JAX package's own
stub.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_torch.tools import eval_reference_checkpoint as tool
from trajnetplusplusbaselines_torch.tools.reference_stub import load_reference

from .torch_parity import classical_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTERED = ("trajnetbaselines", "trajnetplusplustools", "socialforce", "rvo2", "pykalman")

PREDICTOR = '''
import numpy as np
import torch
import trajnetplusplustools


class {cls}:
    """Constant velocity from the last two observed frames; mode m scales
    the velocity by 1 + {spread} m."""

    def __init__(self, scale, extra=None):
        self.scale = scale
        self.extra = extra

    @staticmethod
    def load(filename):
        return torch.load(filename)

    def __call__(self, paths, scene_goal, n_predict=12, obs_length=9, modes=1, args=None):
        xy = trajnetplusplustools.Reader.paths_to_xy(paths)
        last, velocity = xy[obs_length - 1], xy[obs_length - 1] - xy[obs_length - 2]
        steps = np.arange(1, n_predict + 1)[:, None, None]
        out = {{}}
        for m in range(modes):
            pred = last + steps * velocity * self.scale * (1 + {spread} * m)
            out[m] = (pred[:, 0], pred[:, 1:])
        return out
'''

STAND_IN = {
    "trajnetbaselines/__init__.py": "from . import lstm, sgan\n",
    "trajnetbaselines/lstm/__init__.py": "from .lstm import LSTMPredictor\n",
    "trajnetbaselines/lstm/lstm.py": PREDICTOR.format(cls="LSTMPredictor", spread=0.0),
    "trajnetbaselines/sgan/__init__.py": "from .sgan import SGANPredictor\n",
    "trajnetbaselines/sgan/sgan.py": PREDICTOR.format(cls="SGANPredictor", spread=0.25),
}

# the JAX tool in a fresh process; its table goes to a pickle
JAX_RUN = (
    "import pickle, sys\n"
    "from trajnetplusplusbaselines_tpu.tools import eval_reference_checkpoint as tool\n"
    "table = tool.main(sys.argv[1:])\n"
    "with open('table.pkl', 'wb') as f:\n"
    "    pickle.dump((table.results, table.sub_results, table.collision_test), f)\n"
)


def _registered():
    return [name for name in sys.modules if name.split(".")[0] in REGISTERED]


def _forget_reference():
    for name in _registered():
        del sys.modules[name]


@pytest.fixture
def clean_modules(monkeypatch):
    """A case starts with no reference nor stub loaded and leaves none
    behind: modules loaded before it are set aside and put back after it,
    and ``sys.path`` is restored."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in _registered():
        monkeypatch.delitem(sys.modules, name)
    yield
    _forget_reference()


def _write_stand_in(root):
    for rel, text in STAND_IN.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return str(root)


def _write_split(root, n_scenes=8, seed=0):
    """``<root>/synth/{test,test_private}/synth.ndjson``: random-walk
    scenes of 1-6 agents, neighbours appearing late or leaving early; the
    test file holds the observed frames only."""
    rng = np.random.default_rng(seed)
    tags = [[1, []], [2, [1]], [3, [2, 4]], [4, []]]
    files = {"test": [], "test_private": []}
    for sid in range(n_scenes):
        paths = classical_scene(rng, int(rng.integers(1, 7)), scene_id=sid)
        frames = [r.frame for r in paths[0]]
        scene = {"scene": {"id": sid, "p": paths[0][0].pedestrian, "s": frames[0],
                           "e": frames[-1], "fps": 2.5, "tag": tags[sid % 4]}}
        for subset, last in (("test", frames[8]), ("test_private", frames[-1])):
            files[subset].append(json.dumps(scene))
            files[subset] += [json.dumps({"track": {"f": r.frame, "p": r.pedestrian,
                                                    "x": round(r.x, 2), "y": round(r.y, 2)}})
                              for path in paths for r in path if r.frame <= last]
    for subset, lines in files.items():
        os.makedirs(os.path.join(root, "synth", subset))
        with open(os.path.join(root, "synth", subset, "synth.ndjson"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


def _write_checkpoints(reference_root, out_dir, module):
    """(a checkpoint the weights-only unpickler admits, one that only the
    retry loads) of the stand-in's ``module`` predictor."""
    reference = load_reference(reference_root)
    cls = getattr(getattr(reference, module), module).__dict__[
        "SGANPredictor" if module == "sgan" else "LSTMPredictor"]
    safe, full = os.path.join(out_dir, "safe.pkl"), os.path.join(out_dir, "full.pkl")
    torch.save(cls(1.0), safe)
    torch.save(cls(0.5, extra=np.arange(3.0)), full)
    with torch.serialization.safe_globals([cls]):
        assert torch.load(safe).scale == 1.0
        with pytest.raises(pickle.UnpicklingError):
            torch.load(full)
    _forget_reference()
    return [safe, full]


def _jax_tool(cwd, stand_in, argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([stand_in, REPO]))
    out = subprocess.run([sys.executable, "-c", JAX_RUN, *argv], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(os.path.join(cwd, "table.pkl"), "rb") as f:
        return pickle.load(f)


def _written(cwd):
    """{relative path: bytes} of every prediction file under ``cwd``."""
    root = os.path.join(cwd, "DATA_BLOCK", "synth", "test_pred")
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.mark.parametrize("module,modes", [("lstm", 1), ("sgan", 3)])
def test_writes_and_scores_like_the_jax_tool(tmp_path, monkeypatch, clean_modules, module,
                                             modes):
    stand_in = _write_stand_in(tmp_path / "reference")
    src = _write_split(tmp_path / "src")
    outputs = _write_checkpoints(stand_in, str(tmp_path), module)
    argv = ["--path", "synth", "--output", *outputs, "--module", module,
            "--modes", str(modes), "--data_root", src]

    for name in ("port", "jax"):
        os.makedirs(tmp_path / name)
    monkeypatch.chdir(tmp_path / "port")
    original = torch.load
    table = tool.main(["--reference_root", stand_in, *argv])
    assert torch.load is original
    want = _jax_tool(str(tmp_path / "jax"), stand_in, argv)

    got_files, want_files = _written(tmp_path / "port"), _written(tmp_path / "jax")
    names = [f"{n}_modes{modes}" for n in ("safe", "full")]
    assert sorted(got_files) == sorted(f"{n}/synth.ndjson" for n in names)
    assert got_files == want_files
    np.testing.assert_equal((table.results, table.sub_results, table.collision_test), want)
    assert sorted(table.results) == sorted(names)
    assert table.results[names[0]][32] == 8  # every scene scored
    # the two checkpoints predict differently, and their modes differ
    assert table.results[names[0]] != table.results[names[1]]
    lines = got_files[f"{names[0]}/synth.ndjson"].decode().splitlines()
    assert {json.loads(l)["track"].get("prediction_number") for l in lines
            if "track" in l} == set(range(modes))


def test_checkpoint_loading_restores_torch_load(tmp_path, monkeypatch, clean_modules):
    """``torch.load`` is the original function after a load that needed the
    retry and after one that failed both attempts."""
    original = torch.load
    stand_in = _write_stand_in(tmp_path / "reference")
    src = _write_split(tmp_path / "src", n_scenes=2)
    _, full = _write_checkpoints(stand_in, str(tmp_path), "lstm")
    broken = str(tmp_path / "broken.pkl")
    with open(broken, "wb") as f:
        f.write(b"not a checkpoint")
    monkeypatch.chdir(tmp_path)
    argv = ["--reference_root", stand_in, "--path", "synth", "--data_root", src,
            "--write_only"]
    assert tool.main([*argv, "--output", full]) is None
    assert torch.load is original
    with pytest.raises(Exception):
        tool.main([*argv, "--output", broken])
    assert torch.load is original


def test_missing_reference_tree_raises_naming_it(tmp_path, clean_modules):
    missing = tmp_path / "nowhere"
    with pytest.raises(FileNotFoundError, match=str(missing / "trajnetbaselines")):
        tool.main(["--reference_root", str(missing), "--path", "synth", "--output", "x.pkl"])
    assert "trajnetplusplustools" not in sys.modules


def test_stub_is_the_port_data_layer(tmp_path, clean_modules):
    """The stub's names are the port's own, and a simulator module already
    loaded is left in place."""
    from trajnetplusplusbaselines_torch import data
    from trajnetplusplusbaselines_torch.metrics import trajectory

    sys.modules["rvo2"] = marker = type(sys)("rvo2")
    load_reference(_write_stand_in(tmp_path / "reference"))
    stub = sys.modules["trajnetplusplustools"]
    assert stub.Reader is data.Reader and stub.writers is data.writers
    assert sys.modules["trajnetplusplustools.data"].TrackRow is data.TrackRow
    for name in ("average_l2", "final_l2", "collision", "topk", "nll"):
        assert getattr(sys.modules["trajnetplusplustools.metrics"], name) is \
            getattr(trajectory, name)
    assert sys.modules["rvo2"] is marker
    assert sys.modules["socialforce.potentials"].PedPedPotential is object
    assert load_reference("/unused") is sys.modules["trajnetbaselines"]  # imported once
