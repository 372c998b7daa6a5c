"""Guards of the port: no jax, no quiet CPU fallback, and the kernel on the card.

The test marked ``cuda`` compares the CUDA kernel with its plain version and
runs only where a card is present; everywhere else it skips.  The port needs
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

from .torch_parity import flagship_params, port_model, step_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import trajnetplusplusbaselines_torch\n"
        "import trajnetplusplusbaselines_torch.evaluator.lstm_cli\n"
        "import trajnetplusplusbaselines_torch.evaluator.driver\n"
        "import trajnetplusplusbaselines_torch.evaluator.learned\n"
        "import trajnetplusplusbaselines_torch.utils.checkpoint\n"
        "import trajnetplusplusbaselines_torch.models.lstm\n"
        "import trajnetplusplusbaselines_torch.ops.cuda.fused_step\n"
        "import trajnetplusplusbaselines_torch.ops.cuda.build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cli_default_device_refuses_to_run_on_the_cpu(tmp_path, monkeypatch):
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lstm_cli.main(["--path", "synthset", "--output", "missing.pkl"])
    assert not os.path.exists(tmp_path / "DATA_BLOCK")  # nothing ran


def test_cuda_request_without_cuda_raises():
    from trajnetplusplusbaselines_tpu.data.rows import TrackRow
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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pool = GridBasedPooling(type_="directional", cell_side=0.6, n=12, out_dim=256)
    params = LSTM(pool=pool).init_params(torch.Generator().manual_seed(1), device=dev)
    for a in (1, 4, 8, 33, 150):
        obs1, obs2, p1, p2 = (torch.from_numpy(x).to(dev) for x in
                              step_inputs(a, 64, a, n_pad=1, dtype=np.float32))
        grid = fused_step.directional_grid(obs1, obs2, p1, p2)
        assert torch.equal(grid, fused_step.directional_grid_plain(obs1, obs2, p1, p2))
        rng = np.random.default_rng(a)
        h, c = (torch.from_numpy(rng.normal(scale=0.5, size=(64, a, 128)).astype(np.float32))
                .to(dev) for _ in range(2))
        for cell in ("encoder", "decoder"):
            w = fused_step.weights_from_params(params, cell)
            got = fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, w)
            want = fused_step.fused_dlstm_step_plain(obs1, obs2, p1, p2, h, c, w)
            torch.cuda.synchronize()
            for g, x in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, x, atol=2e-5, rtol=1e-4)
            assert torch.equal(got[3], want[3])
