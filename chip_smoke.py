#!/usr/bin/env python3
"""Smoke run of the PyTorch port's D-LSTM serving path on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA (no jax needed).  Phases, one line each:

0. the card (nvidia-smi name and power limit), torch and CUDA versions;
1. build: nvcc compiles ``trajnetplusplusbaselines_torch/csrc/*.cu``;
2. grid: the kernel's directional grid against the plain grid, bit-exact,
   at agent buckets 1..150 with ~16k agent rows each;
3. step: the fused step kernel against the plain step, encoder and decoder
   weights, f32, atol 2e-5 / rtol 1e-4 (summation order over K <= 320);
4. rollout: ``LSTM.forward(n_predict=12)`` at full width, kernel against
   plain, positions within 1e-3 m, 19 kernel launches per rollout, and the
   per-step and per-rollout times of both (CUDA events, after warm-up), at
   the CLI's own batch (64 scenes of 8 agents) and two larger ones;
5. serve (the main path): a synthetic TrajNet++ split written to a temporary
   directory, a seeded D-LSTM saved with ``save_predictor``, and
   ``evaluator.lstm_cli.main([... "--device", "cuda"])`` predicting, writing
   and evaluating it; the launch counters are zeroed just before and read
   just after.  The written primaries are checked against a CPU rollout of
   the generated observations, and the warm prediction rate is timed over
   several passes of ``predict_dataset``.

Then one JSON line of the kernels and, last, ``{"ok": true, "device": ...}``.
Any failed phase raises, so the script exits non-zero and prints no result;
so does a machine without CUDA or a directory without the package.

    python3 chip_smoke.py --profile OUT_DIR

adds a profile phase before the last two lines: kernel and plain times at
larger rollouts, and ``torch.profiler`` tables of warm rollouts and of a warm
``predict_dataset`` pass, written into OUT_DIR.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BUCKETS = (1, 4, 8, 16, 32, 64, 128, 150)
ROWS_PER_BUCKET = 16384
BATCH_SCENES = 64  # lstm_cli's --batch_scenes default
ROLLOUTS = ((BATCH_SCENES, 8), (1024, 8), (256, 32))  # (scenes, agents); first: the CLI's
PROFILE_ROLLOUTS = ((64, 8), (1024, 8), (8192, 8), (65536, 8), (256, 32), (2048, 32))
# multiply-adds x 2 per agent row: input embedding, grid embedding, gates, head
FLOP_PER_ROW = 2 * (2 * 62 + 288 * 256 + 320 * 512 + 128 * 512 + 128 * 5)
SERVE_PASSES = 5
CELL_SIDE, N = 0.6, 12
STEP_ATOL, STEP_RTOL = 2e-5, 1e-4
POSITION_ATOL = 1e-3


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3) -> float:
    """Mean milliseconds of fn on the card, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_inputs(rng, s, a, device):
    """One step's positions and presence at [S, A]: absent agents, an agent
    that appears at t (present2 only), padded slots at the highest j, and
    neighbours on exact multiples of the cell side."""
    obs1 = rng.normal(scale=1.5, size=(s, a, 2))
    obs2 = obs1 + rng.normal(scale=0.3, size=(s, a, 2))
    m = min(a, 4)
    k = rng.integers(-7, 8, size=(s, m, 2))
    k[:, 0] = 0
    base = CELL_SIDE * rng.integers(-3, 4, size=(s, 1, 2))
    base[::2] = 0.0
    obs2[:, :m] = base + CELL_SIDE * k
    p1 = rng.random((s, a)) > 0.2
    p2 = rng.random((s, a)) > 0.1
    p1[:, 0] = p2[:, 0] = True
    if a > 2:
        p1[:, 1], p2[:, 1] = False, True  # appears at t
        n_pad = max(1, a // 8)
        p1[:, a - n_pad:] = p2[:, a - n_pad:] = False
    obs1 = np.where(p1[..., None], obs1, 0.0).astype(np.float32)
    obs2 = np.where(p2[..., None], obs2, 0.0).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (obs1, obs2, p1, p2)]


def rollout_inputs(rng, s, a, device):
    """9 observed frames at [S, A]: random walks, a late-appearing agent, an
    agent absent mid-way and padded slots."""
    xy = rng.normal(scale=0.15, size=(9, s, a, 2)).cumsum(axis=0)
    xy += rng.uniform(-3, 3, size=(1, s, a, 2))
    mask = np.ones((9, s, a), bool)
    mask[:3, :, -1] = False
    if a > 3:
        mask[3:5, :, 1] = False
        mask[:, : s // 2, -2] = False
    xy = np.where(mask[..., None], xy, 0.0).astype(np.float32)
    return torch.from_numpy(xy).to(device), torch.from_numpy(mask).to(device)


# --------------------------------------------------------------- split
def write_split(root, rng, n_scenes=300, big=140):
    """A TrajNet++ split: test/ holds the 9 observed frames, test_private/
    all 21.  Scenes of 2..32 agents (buckets 4..32) and one of ``big``.

    Returns per scene (primary's id, observed positions [9, n, 2] as written,
    NaN where absent), agents in the order a TrajNet++ reader gives them:
    the primary, then the others by first frame."""
    sizes = list(rng.integers(2, 33, size=n_scenes - 1)) + [big]
    test, private, observed = [], [], []
    ped = 0
    for sid, n in enumerate(sizes):
        f0 = sid * 1000
        frames = [f0 + 10 * t for t in range(21)]
        kind = int(rng.integers(1, 5))
        tag = [kind, [int(rng.integers(1, 5))] if kind == 3 else []]
        scene = {"scene": {"id": sid, "p": ped + 1, "s": frames[0], "e": frames[-1],
                           "fps": 2.5, "tag": tag}}
        test.append(scene)
        private.append(scene)
        start = rng.uniform(-4, 4, size=(n, 2))
        vel = rng.normal(scale=0.4, size=(n, 2))
        xy = np.full((9, n, 2), np.nan)
        firsts = []
        for j in range(int(n)):
            ped += 1
            first = 0 if j == 0 else int(rng.choice([0, 0, 0, 2, 5]))
            firsts.append(first)
            for t in range(first, 21):
                x, y = start[j] + vel[j] * t + rng.normal(scale=0.02, size=2)
                x, y = round(float(x), 2), round(float(y), 2)
                row = {"track": {"f": frames[t], "p": ped, "x": x, "y": y}}
                private.append(row)
                if t < 9:
                    test.append(row)
                    xy[t, j] = x, y
        observed.append((scene["scene"]["p"], xy[:, np.argsort(firsts, kind="stable")]))
    for sub, rows in (("test", test), ("test_private", private)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "synth.ndjson"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return observed


def profiled(fn, reps, table_path):
    """Run ``fn`` ``reps`` times, warm, under ``torch.profiler``; write the
    op table to ``table_path`` and return the window's device time, the
    fused kernel's share of it, the wall time and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    kernel_ms = sum(e.time_range.elapsed_us() for e in device
                    if "fused_step_kernel" in e.name) / 1e3
    averages = prof.key_averages()
    key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    Path(table_path).write_text(averages.table(sort_by=key, row_limit=30))
    return {"reps": reps, "device_ms": device_ms, "fused_kernel_ms": kernel_ms,
            "wall_ms": wall_ms, "device_busy": device_ms / wall_ms if wall_ms else 0.0}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT_DIR", default=None,
                        help="also run the profile phase, writing its tables here")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 2
    if not (REPO / "trajnetplusplusbaselines_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from trajnetplusplusbaselines_torch.evaluator import lstm_cli
    from trajnetplusplusbaselines_torch.evaluator.driver import test_scenes
    from trajnetplusplusbaselines_torch.evaluator.learned import BatchedPredictor, bucket_plan
    from trajnetplusplusbaselines_torch.models import lstm as lstm_module
    from trajnetplusplusbaselines_torch.models.lstm import LSTM, LSTMPredictor
    from trajnetplusplusbaselines_torch.ops.cuda import build, fused_step
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling
    from trajnetplusplusbaselines_torch.utils.checkpoint import load_predictor, save_predictor
    from trajnetplusplusbaselines_torch.utils.convert import params_to

    # ---- 0: the card; the plain versions run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    torch.manual_seed(0)
    card = card_line()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())

    # ---- 1: build
    t0 = time.perf_counter()
    build.load_library()
    log = build.library_path().with_suffix(".log")
    ptxas = [line.strip() for line in log.read_text().splitlines()
             if "registers" in line or "spill" in line] if log.exists() else []
    say("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=build.build_seconds,
        dims=build.kernel_dims(), ptxas=ptxas)

    rng = np.random.default_rng(0)
    pool = GridBasedPooling(type_="directional", hidden_dim=128, cell_side=CELL_SIDE, n=N,
                            out_dim=256)
    model = LSTM(pool=pool, embedding_dim=64, hidden_dim=128)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)

    # ---- 2: grid, bit-exact
    for a in BUCKETS:
        s = math.ceil(ROWS_PER_BUCKET / a)
        obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
        got = fused_step.directional_grid(obs1, obs2, p1, p2, cell_side=CELL_SIDE)
        want = fused_step.directional_grid_plain(obs1, obs2, p1, p2, cell_side=CELL_SIDE)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"grid differs at A={a}: first cells {bad}")
        say("grid", a=a, s=s, bit_exact=True, cells_hit=int((got != 0).sum()))

    # ---- 3: fused step
    step_err = 0.0
    for a in BUCKETS:
        s = math.ceil(ROWS_PER_BUCKET / a)
        obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
        h, c = (torch.randn(s, a, 128, device=dev) * 0.5 for _ in range(2))
        errs = {}
        for cell in ("encoder", "decoder"):
            w = fused_step.weights_from_params(params, cell)
            got = fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, w)
            want = fused_step.fused_dlstm_step_plain(obs1, obs2, p1, p2, h, c, w)
            torch.cuda.synchronize()
            for name, g, x in zip(("h", "c", "normal"), got[:3], want[:3]):
                torch.testing.assert_close(g, x, atol=STEP_ATOL, rtol=STEP_RTOL,
                                           msg=lambda m: f"{cell} {name} at A={a}: {m}")
                errs[f"{cell}_{name}"] = float((g - x).abs().max())
            if not torch.equal(got[3], want[3]):
                raise AssertionError(f"{cell} mask differs at A={a}")
        step_err = max(step_err, *errs.values())
        say("step", a=a, s=s, max_abs_err=errs)

    # ---- 4: rollout at full width, kernel against plain
    def plain_forward(*args, **kw):
        with mock.patch.object(lstm_module, "fused_dlstm_step",
                               fused_step.fused_dlstm_step_plain):
            return model.forward(*args, **kw)

    def rollout_times(s, a, reps=20, rollout_reps=10):
        """Step and rollout ms of kernel and plain at [S, A], CUDA events."""
        xy, mask = rollout_inputs(rng, s, a, dev)
        w = fused_step.weights_from_params(params, "decoder")
        h, c = (torch.randn(s, a, 128, device=dev) * 0.5 for _ in range(2))
        obs1, obs2, p1, p2 = xy[-2], xy[-1], mask[-2], mask[-1]
        row = {
            "step_ms": time_ms(lambda: fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, w),
                               reps=reps),
            "plain_step_ms": time_ms(
                lambda: fused_step.fused_dlstm_step_plain(obs1, obs2, p1, p2, h, c, w),
                reps=reps),
            "rollout_ms": time_ms(lambda: model.forward(params, xy, mask, n_predict=12),
                                  reps=rollout_reps),
            "plain_rollout_ms": time_ms(lambda: plain_forward(params, xy, mask, n_predict=12),
                                        reps=rollout_reps),
        }
        row["rollout_scenes_per_s"] = s / row["rollout_ms"] * 1e3
        row["plain_rollout_scenes_per_s"] = s / row["plain_rollout_ms"] * 1e3
        row["kernel_share_of_rollout"] = 19 * row["step_ms"] / row["rollout_ms"]
        return row

    times = {}
    for s, a in ROLLOUTS:
        xy, mask = rollout_inputs(rng, s, a, dev)
        before = fused_step.fused_dlstm_step.launches
        rel, pred, valid = model.forward(params, xy, mask, n_predict=12)
        torch.cuda.synchronize()
        launches = fused_step.fused_dlstm_step.launches - before
        if launches != 19:
            raise AssertionError(f"rollout launched the kernel {launches} times, not 19")
        rel_p, pred_p, valid_p = plain_forward(params, xy, mask, n_predict=12)
        if not torch.equal(valid, valid_p):
            raise AssertionError(f"rollout validity differs at S={s} A={a}")
        if pred.shape != (19, s, a, 2) or not torch.isfinite(pred).all():
            raise AssertionError("rollout positions are not finite [19, S, A, 2]")
        pos_err = float((pred - pred_p)[valid].abs().max())
        if pos_err > POSITION_ATOL:
            raise AssertionError(f"rollout positions differ by {pos_err} m at S={s} A={a}")
        times[(s, a)] = rollout_times(s, a)
        say("rollout", s=s, a=a, launches=launches, max_position_err_m=pos_err,
            **times[(s, a)])

    # ---- 5: serve, the main path: predict -> write -> evaluate
    split = "DATA_BLOCK/synth_split"
    predict_args = argparse.Namespace(path=split + "/test_pred/", obs_length=9, pred_length=12)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            observed = write_split(split, rng)
            save_predictor(LSTMPredictor(model, params_to(params, "cpu")), "dlstm.pkl")

            fused_step.fused_dlstm_step.launches = 0
            fused_step.directional_grid.launches = 0
            t0 = time.perf_counter()
            table = lstm_cli.main(["--path", "synth_split", "--output", "dlstm.pkl",
                                   "--device", DEVICE, "--batch_scenes", str(BATCH_SCENES)])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            main_launches = {"fused_dlstm_step": fused_step.fused_dlstm_step.launches,
                             "directional_grid": fused_step.directional_grid.launches}

            overall = table.results["dlstm_modes1"][32:40]
            n_scored, ade, fde = overall[0], overall[1], overall[2]
            if n_scored != len(observed) or not (np.isfinite(ade) and np.isfinite(fde)):
                raise AssertionError(f"evaluation scored {n_scored} of {len(observed)}: {overall}")
            # one rollout of 19 launches per batch of the predictor's plan
            plan = bucket_plan([xy.shape[1] for _, xy in observed], BATCH_SCENES)
            if main_launches["fused_dlstm_step"] != 19 * len(plan):
                raise AssertionError(f"serve launched {main_launches} for {len(plan)} batches")

            # the written primaries against a CPU rollout of the generated
            # observations, each padded to the bucket it was served in
            written = {}
            with open(split + "/test_pred/dlstm_modes1/synth.ndjson") as f:
                for line in f:
                    track = json.loads(line).get("track")
                    if track is not None:
                        written.setdefault((track["scene_id"], track["p"]), []).append(
                            (track["x"], track["y"]))
            bucket_of = {i: bucket for bucket, _, chunk in plan for i in chunk}
            cpu_params = params_to(params, "cpu")
            check_err = 0.0
            for sid in list(range(8)) + [len(observed) - 1]:
                primary, xy = observed[sid]
                padded = np.full((9, 1, bucket_of[sid], 2), np.nan)
                padded[:, 0, : xy.shape[1]] = xy
                mask = np.isfinite(padded[..., 0])
                _, pred, _ = model.forward(cpu_params, torch.from_numpy(np.nan_to_num(padded)),
                                           torch.from_numpy(mask), n_predict=12)
                want = pred[-12:, 0, 0].double().numpy()
                got = np.array(written[(sid, primary)], dtype=np.float64)
                if got.shape != (12, 2) or not np.isfinite(got).all():
                    raise AssertionError(f"scene {sid}: written primary is {got.shape}")
                check_err = max(check_err, float(np.abs(got - want).max()))
            if check_err > 0.005 + POSITION_ATOL:  # the writer rounds to 0.01 m
                raise AssertionError(f"written predictions differ from the CPU by {check_err}")

            # warm prediction rate through the same batched predictor
            _, _, processed, goals = test_scenes("synth", predict_args)
            predictor = BatchedPredictor(load_predictor("dlstm.pkl"),
                                         batch_scenes=BATCH_SCENES, device=dev)
            predictor.predict_dataset(processed, goals, predict_args)
            rates = []
            for _ in range(SERVE_PASSES):
                t0 = time.perf_counter()
                predictor.predict_dataset(processed, goals, predict_args)
                torch.cuda.synchronize()
                rates.append(len(processed) / (time.perf_counter() - t0))
        finally:
            os.chdir(cwd)
    say("serve", scenes=len(observed), biggest_scene=max(xy.shape[1] for _, xy in observed),
        batches=len(plan), cli_seconds=cli_s, launches=main_launches, overall_ade=ade,
        overall_fde=fde, col_test=table.collision_test.get("dlstm_modes1"),
        cpu_check_err_m=check_err, predict_passes=SERVE_PASSES,
        predict_scenes_per_s=rates)
    print("Overall  N={} ADE={:.4f} FDE={:.4f}  predict {:.1f}-{:.1f} scenes/s "
          "(median {:.1f}, {} passes)".format(n_scored, ade, fde, min(rates), max(rates),
                                              float(np.median(rates)), SERVE_PASSES), flush=True)

    # ---- profile (optional): larger rollouts and profiler tables
    if opts.profile:
        out = Path(opts.profile)
        out.mkdir(parents=True, exist_ok=True)
        for s, a in PROFILE_ROLLOUTS:
            runs = [rollout_times(s, a, reps=10, rollout_reps=5) for _ in range(3)]
            step_ms = [r["step_ms"] for r in runs]
            say("profile_rollout", s=s, a=a, step_ms=step_ms,
                plain_step_ms=[r["plain_step_ms"] for r in runs],
                rollout_ms=[r["rollout_ms"] for r in runs],
                plain_rollout_ms=[r["plain_rollout_ms"] for r in runs],
                tflops=FLOP_PER_ROW * s * a / min(step_ms) / 1e9)
        for s, a in ((BATCH_SCENES, 8), (1024, 8)):
            xy, mask = rollout_inputs(rng, s, a, dev)
            say("profile_trace", what=f"rollout S={s} A={a}", **profiled(
                lambda: model.forward(params, xy, mask, n_predict=12), 5,
                out / f"rollout_{s}x{a}.txt"))
        say("profile_trace", what=f"predict_dataset {len(processed)} scenes", **profiled(
            lambda: predictor.predict_dataset(processed, goals, predict_args), 1,
            out / "predict_dataset.txt"))

    main_s, main_a = ROLLOUTS[0]
    print(json.dumps({"kernels": [{
        "name": "fused_dlstm_step",
        "route": "cuda",
        "source": "trajnetplusplusbaselines_torch/csrc/fused_step.cu",
        "replaces": "trajnetplusplusbaselines_tpu/ops/pallas/fused_step.py:52",
        "launches": main_launches["fused_dlstm_step"],
        "max_abs_err": step_err,
        "ms": times[(main_s, main_a)]["step_ms"],
        "plain_ms": times[(main_s, main_a)]["plain_step_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
