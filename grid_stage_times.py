#!/usr/bin/env python3
"""Device time per launch of the port's grid stage and fused step, for the
port of one or more checkouts, on one NVIDIA card.

    python3 grid_stage_times.py [TREE ...]

For each TREE (the root of a checkout of the repository; default: this one),
in the order given and each in a process of its own, the script builds that
checkout's kernels (into TREE/build/torch_kernels/) and measures under
``torch.profiler``:

- ``directional_grid_kernel`` at n=12 at ``chip_smoke.GRID_DEVICE_SHAPES``,
  and at phase 7's other geometries (n=8, n=12 with ``front``, n=24 at half
  the cell side) at S=256, A=32, each against its bound
  (``chip_smoke.grid_bound_ms``);
- ``fused_step_kernel`` at S=1024, A=8, the flagship's widths, seeded
  weights.

Every tree gets the same inputs: this checkout's ``chip_smoke`` helpers make
them from fixed seeds.  It prints the card (``nvidia-smi`` name and power
limit), then one JSON line per tree.  To compare two versions on one card,
name them in turns, ``OLD NEW NEW OLD``.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent


def measure(tree: Path) -> dict:
    """This process's measurements of ``tree``'s port."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(tree))
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    if not Path(fused_step.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {fused_step.__file__}, not the port of {tree}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    grid = smoke.grid_stage_rows(fused_step, dev, rng, plain=False)
    geometries = {}
    s, a = smoke.POOL_ROLLOUTS[-1]
    obs1, obs2, p1, p2 = smoke.step_inputs(rng, s, a, dev)
    for tag, geometry in {"n8": dict(n=8), f"n{smoke.N}_front": dict(n=smoke.N, front=True),
                          f"n{2 * smoke.N}_pool2": dict(n=2 * smoke.N,
                                                        cell_side=smoke.CELL_SIDE / 2)}.items():
        geometry = {"cell_side": smoke.CELL_SIDE, **geometry}
        ms = smoke.kernel_ms_per_launch(
            lambda: fused_step.directional_grid(obs1, obs2, p1, p2, **geometry),
            smoke.GRID_REPS, "directional_grid_kernel")
        bound = smoke.grid_bound_ms(s * a, geometry["n"])
        geometries[f"S{s}xA{a}_{tag}"] = {"n": geometry["n"], "device_ms": ms, "bound_ms": bound,
                                          "bound_share": bound / ms}

    model = LSTM(pool=GridBasedPooling(type_="directional", hidden_dim=128,
                                       cell_side=smoke.CELL_SIDE, n=smoke.N, out_dim=256),
                 embedding_dim=64, hidden_dim=128)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    w = model.step_weights(params, "decoder", "fused")
    s, a = 1024, 8
    obs1, obs2, p1, p2 = smoke.step_inputs(rng, s, a, dev)
    h, c = (torch.from_numpy(rng.normal(scale=0.5, size=(s, a, 128)).astype(np.float32)).to(dev)
            for _ in range(2))
    with torch.no_grad():
        fused_ms = smoke.kernel_ms_per_launch(
            lambda: fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, w), 20,
            "fused_step_kernel")
    return {"tree": str(tree), "grid": {f"{s}x{a}": row for (s, a), row in grid.items()},
            "geometries": geometries, "fused_1024x8_device_ms": fused_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("grid_stage_times: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(Path(sys.argv[2]))), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    for tree in sys.argv[1:] or [str(REPO)]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
