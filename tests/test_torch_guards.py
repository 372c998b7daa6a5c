"""Guards of the port: no jax, no quiet CPU fallback, and the kernel on the card.

The tests marked ``cuda`` compare the CUDA kernel with its plain version, and
take a train step through its grid stage; they run only where a card is
present, and everywhere else they skip.  The port needs
no jax; where jax is not installed, run it without the suite's conftest
(which imports jax):

    python -m pytest tests/test_torch_guards.py -m cuda --noconftest -p no:cacheprovider
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from .torch_parity import example_batch, flagship_params, port_model, step_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    """Every module of the port, by dotted name."""
    root = os.path.join(REPO, "trajnetplusplusbaselines_torch")
    names = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3].replace(os.sep, ".")
                names.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(names)


# the scripts that drive the port on the card
SCRIPTS = ("chip_smoke", "grid_stage_times")


def test_port_imports_no_jax():
    """Importing every module of the port and its scripts (without running
    them) loads neither jax nor optax nor anything of the JAX package."""
    modules = _port_modules()
    assert len(modules) > 30 and "trajnetplusplusbaselines_torch.data.reader" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules + list(SCRIPTS)!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'optax') or m.startswith(('jax.', 'jaxlib', 'optax.',\n"
        "                                                       'trajnetplusplusbaselines_tpu')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_import_nothing_of_the_jax_package():
    """No ``import`` statement anywhere in the port or its scripts, at module
    level or inside a function, names jax, optax, the JAX package or the
    repository's ``tests`` (whose reference harness imports the JAX
    package)."""
    import ast

    files = [os.path.join(REPO, *m.split(".")) for m in _port_modules()]
    files = [f + ".py" if os.path.exists(f + ".py") else os.path.join(f, "__init__.py")
             for f in files] + [os.path.join(REPO, f"{name}.py") for name in SCRIPTS]
    banned = ("jax", "jaxlib", "optax", "trajnetplusplusbaselines_tpu", "tests")
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [(os.path.relpath(path, REPO), node.lineno, n) for n in names
                      if n.split(".")[0] in banned]
    assert len(files) > 30
    assert not found, found


@pytest.mark.parametrize("cli", ["lstm_cli", "sgan_cli", "vae_cli"])
def test_cli_default_device_refuses_to_run_on_the_cpu(tmp_path, monkeypatch, cli):
    import importlib

    module = importlib.import_module(f"trajnetplusplusbaselines_torch.evaluator.{cli}")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--path", "synthset", "--output", "missing.pkl"])
    assert not os.path.exists(tmp_path / "DATA_BLOCK")  # nothing ran


def test_classical_clis_default_device_refuses_to_run_on_the_cpu(tmp_path, monkeypatch):
    from trajnetplusplusbaselines_torch.evaluator import classical_cli
    from trajnetplusplusbaselines_torch.models.classical import socialforce_eval

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        classical_cli.main(["--path", "synthset", "--cv", "--kf", "--sf", "--orca"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        socialforce_eval.main(["--data", "missing.ndjson"])
    assert not os.listdir(tmp_path)  # nothing ran


@pytest.mark.parametrize("name", ["constant_velocity", "kalman", "socialforce"])
def test_classical_predictors_refuse_to_run_on_the_cpu(name):
    """CV, KF and SF compute on the card by default and raise without one,
    scene by scene and folded."""
    import importlib

    from trajnetplusplusbaselines_torch.data.rows import TrackRow

    module = importlib.import_module(f"trajnetplusplusbaselines_torch.models.classical.{name}")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    scene = [[TrackRow(10 * f, 1, 0.1 * f, 0.0) for f in range(9)],
             [TrackRow(10 * f, 2, 1.0, 0.2 * f) for f in range(9)]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.predict(scene)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.predict_dataset([scene, scene])
    module.predict_dataset([scene], device="cpu")


def test_importing_orca_builds_nothing():
    """ORCA's library is built at its first use, not when the module is
    imported: the import works without a compiler on the path."""
    code = ("import trajnetplusplusbaselines_torch.models.classical.orca as orca\n"
            "assert orca.load_library.cache_info().currsize == 0\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, PATH=os.path.join(REPO, "no-such-dir"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_request_without_cuda_raises():
    from trajnetplusplusbaselines_torch.data.rows import TrackRow
    from trajnetplusplusbaselines_torch.evaluator.learned import BatchedPredictor
    from trajnetplusplusbaselines_torch.models.lstm import LSTMPredictor
    from trajnetplusplusbaselines_torch.ops.cuda import build

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jmodel, _, params = flagship_params(seed=0)
    pred = BatchedPredictor(LSTMPredictor(port_model(jmodel), params), device="cuda")
    args = types.SimpleNamespace(pred_length=12, obs_length=9)
    scene = [[TrackRow(f, 1, 0.1 * f, 0.0) for f in range(9)]]
    with pytest.raises((RuntimeError, AssertionError)):
        pred.predict_dataset([scene], [None], args)
    if build.shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build._nvcc()


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The grid stage bit-exact and the fused step within 2e-5 / 1e-4 of the
    plain version (mask bit-exact): at 64 scenes of 1..150 agents, at row
    counts below one 64-row tile and not a multiple of it (3 x 7, 1 x 1,
    5 x 13), at counts that leave the last cluster's tile partly empty
    (65 x 8, 9 x 150), with absent agents and padded slots throughout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pool = GridBasedPooling(type_="directional", cell_side=0.6, n=12, out_dim=256)
    params = LSTM(pool=pool).init_params(torch.Generator().manual_seed(1), device=dev)
    shapes = [(64, a) for a in (1, 4, 8, 33, 150)] + [(3, 7), (1, 1), (5, 13), (65, 8), (9, 150)]
    for s, a in shapes:
        obs1, obs2, p1, p2 = (torch.from_numpy(x).to(dev) for x in
                              step_inputs(a + s, s, a, n_pad=max(1, a // 8), dtype=np.float32))
        grid = fused_step.directional_grid(obs1, obs2, p1, p2)
        assert torch.equal(grid, fused_step.directional_grid_plain(obs1, obs2, p1, p2))
        rng = np.random.default_rng(a)
        h, c = (torch.from_numpy(rng.normal(scale=0.5, size=(s, a, 128)).astype(np.float32))
                .to(dev) for _ in range(2))
        for cell in ("encoder", "decoder"):
            w = fused_step.weights_from_params(params, cell)
            got = fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, w)
            want = fused_step.fused_dlstm_step_plain(obs1, obs2, p1, p2, h, c, w)
            torch.cuda.synchronize()
            for g, x in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, x, atol=2e-5, rtol=1e-4)
            assert torch.equal(got[3], want[3])


def _flagship(requires_grad):
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    model = LSTM(pool=GridBasedPooling(type_="directional", cell_side=0.6, n=12, out_dim=256))
    params = model.init_params(torch.Generator().manual_seed(2))
    for leaf in (params["encoder"]["w_ih"], params["decoder"]["w_ih"]):
        leaf.requires_grad_(requires_grad)
    return model, params


def test_grid_wrapper_refuses_positions_that_require_grad():
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step

    obs1, obs2, p1, p2 = (torch.from_numpy(x) for x in step_inputs(0, 2, 4, dtype=np.float32))
    fused_step.directional_grid(obs1, obs2, p1, p2)
    with pytest.raises(ValueError, match="no gradient"):
        fused_step.directional_grid(obs1, obs2.clone().requires_grad_(), p1, p2)


def test_fused_step_refuses_to_be_recorded():
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step

    _, params = _flagship(requires_grad=True)
    obs1, obs2, p1, p2 = (torch.from_numpy(x) for x in step_inputs(1, 2, 4, dtype=np.float32))
    h = c = torch.zeros(2, 4, 128)
    weights = fused_step.weights_from_params(params, "encoder")
    with pytest.raises(RuntimeError, match="no backward"):
        fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, weights)
    with torch.no_grad():
        fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, weights)


@pytest.mark.parametrize("grad_mode,requires_grad,want", [
    (True, True, "grid"), (False, True, "fused"), (True, False, "fused")])
def test_step_switch_is_whether_autograd_records(grad_mode, requires_grad, want, monkeypatch):
    """The one switch between the fused step and grid kernel + autograd."""
    from trajnetplusplusbaselines_torch.models import lstm as lstm_module

    calls = {"fused": 0, "grid": 0}
    for name, key in (("fused_dlstm_step", "fused"), ("directional_grid", "grid")):
        def counted(*args, _fn=getattr(lstm_module, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(lstm_module, name, counted)
    model, params = _flagship(requires_grad)
    xy, mask = example_batch(2, 4)
    xy, mask = torch.from_numpy(xy.astype(np.float32)), torch.from_numpy(mask)
    with torch.set_grad_enabled(grad_mode):
        rel, _, _ = model.forward(params, xy[:9], mask[:9], prediction_truth=xy[9:20],
                                  prediction_truth_mask=mask[9:20])
    assert calls[want] == 19 and sum(calls.values()) == 19
    assert rel.requires_grad == (want == "grid")


def test_trainer_default_device_refuses_to_run_on_the_cpu(tmp_path, monkeypatch):
    from trajnetplusplusbaselines_torch.trainers import lstm as trainer_cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer_cli.main(argv=["--path", "synthset", "--type", "directional"])
    assert not os.path.exists(tmp_path / "OUTPUT_BLOCK")  # nothing ran


@pytest.mark.cuda
def test_train_step_through_the_grid_kernel_on_the_card():
    """One flagship train step on the card launches the grid kernel 19 times
    and gives the loss and gradients of the same step with the plain grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from unittest import mock

    from trajnetplusplusbaselines_torch.models import lstm as lstm_module
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.trainers.common import step_lr
    from trajnetplusplusbaselines_torch.trainers.lstm import Trainer
    from trajnetplusplusbaselines_torch.utils.convert import params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    model, params = _flagship(requires_grad=False)
    trainer = Trainer(model, params_to(params, "cuda"), step_lr(1e-3, 10))
    xy, mask = example_batch(8, 8, seed=4)
    batch = (torch.from_numpy(xy.astype(np.float32)).cuda(), torch.from_numpy(mask).cuda(),
             torch.ones(8, dtype=torch.bool, device="cuda"))
    before = fused_step.directional_grid.launches
    loss, grads = trainer.loss_and_grads(*batch)
    torch.cuda.synchronize()
    assert fused_step.directional_grid.launches - before == 19
    with mock.patch.object(lstm_module, "directional_grid", fused_step.directional_grid_plain):
        plain_loss, plain_grads = trainer.loss_and_grads(*batch)
    assert fused_step.directional_grid.launches - before == 19  # the plain grid ran
    assert bool(torch.isfinite(loss))
    # the grid is bit-exact and the rest is the same torch code
    assert torch.equal(loss, plain_loss)
    for path, g, p in zip(trainer.paths, grads, plain_grads):
        assert torch.equal(g, p), path
    trainer.train_step(*batch)
    assert fused_step.directional_grid.launches - before == 38


@pytest.mark.cuda
def test_directional_grids_of_any_width_run_on_the_card():
    """A D-LSTM at n=8, hidden 64, pool 64 rolls out and takes a train step
    on the card through the grid stage, never the fused step; the grid stage
    is bit-exact at other sides and with ``front``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling
    from trajnetplusplusbaselines_torch.trainers.common import step_lr
    from trajnetplusplusbaselines_torch.trainers.lstm import Trainer
    from trajnetplusplusbaselines_torch.utils.convert import params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for n, front in ((1, False), (5, False), (8, True), (24, False), (32, True)):
        obs1, obs2, p1, p2 = (torch.from_numpy(x).to(dev) for x in
                              step_inputs(n, 16, 9, n_pad=1, dtype=np.float32))
        kw = dict(n=n, cell_side=0.6 / (2 if n == 24 else 1), constant=0.5, front=front)
        got = fused_step.directional_grid(obs1, obs2, p1, p2, **kw)
        assert torch.equal(got, fused_step.directional_grid_plain(obs1, obs2, p1, p2, **kw))

    model = LSTM(pool=GridBasedPooling(type_="directional", hidden_dim=64, cell_side=0.6, n=8,
                                       out_dim=64), embedding_dim=64, hidden_dim=64)
    assert not model.fused and model.route(records=False) == "grid"
    params = model.init_params(torch.Generator().manual_seed(3))
    xy, mask = example_batch(8, 8, seed=5)
    xy32 = torch.from_numpy(xy.astype(np.float32))
    mask_t = torch.from_numpy(mask)
    launches = fused_step.fused_dlstm_step.launches, fused_step.directional_grid.launches
    with torch.no_grad():
        _, pred, valid = model.forward(params_to(params, dev), xy32[:9].to(dev),
                                       mask_t[:9].to(dev), n_predict=12)
        _, cpu_pred, cpu_valid = model.forward(params, xy32[:9], mask_t[:9], n_predict=12)
    torch.cuda.synchronize()
    assert fused_step.directional_grid.launches - launches[1] == 19
    assert torch.equal(valid.cpu(), cpu_valid)
    torch.testing.assert_close(pred.cpu(), cpu_pred, atol=1e-3, rtol=0)

    trainer = Trainer(model, params_to(params, dev), step_lr(1e-3, 10))
    batch = (xy32.to(dev), mask_t.to(dev), torch.ones(8, dtype=torch.bool, device=dev))
    loss = trainer.train_step(*batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert fused_step.directional_grid.launches - launches[1] == 38
    assert fused_step.fused_dlstm_step.launches == launches[0]
