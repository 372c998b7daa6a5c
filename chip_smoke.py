#!/usr/bin/env python3
"""Smoke run of the PyTorch port's LSTM family, serving and training, on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA (no jax needed).  Phases, one line each:

0. the card (nvidia-smi name and power limit), torch and CUDA versions;
1. build: nvcc compiles ``trajnetplusplusbaselines_torch/csrc/*.cu``, one
   process per source; the build line counts SASS instructions
   (``cuobjdump``) and fails without a tensor-core one in the fused step or
   a 16-byte store in the grid stage;
2. grid: the grid stage against the plain grid, bit-exact, at agent buckets
   1..150 with ~16k agent rows each, and on ``grid_edge_cases`` (each built
   to hit one rule of the last write; the rules checked on the output);
3. step: the fused step kernel against the plain step, encoder and decoder
   weights, f32, atol 2e-5 / rtol 1e-4 (3xTF32 tensor-core products and
   their summation order over K <= 448), mask bit-exact, at the buckets and
   at row counts off the kernel's 64-row tile (3 x 7, 1 x 1, 65 x 8);
4. rollout: ``LSTM.forward(n_predict=12)`` at full width, kernel against
   plain, positions within 1e-3 m, 19 kernel launches per rollout, and the
   per-step and per-rollout times of both (CUDA events, after warm-up), at
   the CLI's own batch (64 scenes of 8 agents) and two larger ones;
   (b) the fused kernel's device time per launch (``torch.profiler``) at
   those three shapes, its bound (3xTF32 on the tensor cores or the bytes,
   whichever is larger) and the share of it reached, the library
   yardstick (the three products alone through ``torch.addmm``, f32 with
   TF32 off and on), and the weight preparation's cost per rollout; the
   grid stage's device time per launch at n=12 at those shapes, at a train
   step's S=8, A=8 and at S=8192, A=8 (77 MB written, past the L2), against
   its bound (the bytes, ``grid_bound_ms``);
5. serve (the main path): a synthetic TrajNet++ split written to a temporary
   directory, a seeded D-LSTM saved with ``save_predictor``, and
   ``evaluator.lstm_cli.main([... "--device", "cuda"])`` predicting, writing
   and evaluating it; the launch counters are zeroed just before and read
   just after.  The written primaries are checked against a CPU rollout of
   the generated observations, and the warm prediction rate is timed over
   several passes of ``predict_dataset``;
6. train (the main path's second entry point): a synthetic train / val /
   test split, and ``trainers.lstm.main([... "--device", "cuda"])`` training
   the flagship D-LSTM for 2 epochs at batch 8; the counters are zeroed just
   before and read just after: the grid kernel launches 19 times per train
   batch, the fused step 2 x 19 times per val batch (validation records no
   autograd, so its teacher-forced pass and its free rollout both run it).
   Every logged loss is finite, epoch 2's train loss is below epoch 1's, and
   the written pickle serves the test part through ``lstm_cli``.  One train
   step's loss and gradients with the grid kernel against the plain grid
   (equal: the grid is bit-exact and the rest is the same torch code), an
   f32 step on the
   card against an f64 step on the CPU (loss 1e-5 relative, gradients 1e-4
   relative + 1e-5 of each leaf's largest), device augmentation keeping
   pairwise distances, and the train step's time at batch 8 and 256 and the
   grid kernel's against the plain grid's (CUDA events, warm);
7. pools (the main path's other interaction modules), at the trainer's
   default widths (hidden 128, embedding 64, pool 256, n 12, cell 0.6 m,
   latent 16, neigh 4, mp_iters 5):
   (a) ``LSTM.forward(n_predict=12)`` at S=64, A=8 and S=256, A=32 for the
       ten pooled types, a two-layer S-LSTM, an ``lstm_layer`` D-LSTM, a
       goal D-LSTM and a D-LSTM at n=8, hidden 64: positions within 1e-3 m
       of a CPU run of the same params and inputs (nearest neighbours drawn
       ``NEIGHBOUR_GAP`` apart), each rollout timed, and the launch counters
       zeroed before and read after each: 19 grid-stage launches and no
       fused launch for every directional grid off the flagship's widths,
       19 fused launches for the flagship; the grid stage alone against
       the plain grid, bit-exact, at every geometry the grid route gives
       it (n=8, n=12, n=12 with front, and pool_size 2 as n=24 at 0.3 m):
       its device time per launch (``torch.profiler``) against its bound at
       that n, and the time per call of both (CUDA events, the wrapper's
       host time included);
   (b) ``trainers.lstm.main([... "--device", "cuda"])``, one epoch at batch
       8, for social, attentionmlp, nn_lstm and ``directional --goals``
       (goal files written beside the split): finite losses, 19 grid-stage
       launches per train batch and 2 x 19 per val batch for the goal
       model, none for the others; each pickle served through ``lstm_cli``;
   (c) a train step of social and of attentionmlp on the card in f32
       against f64 on the CPU at phase 6's tolerances, its time, and the
       memory high-water mark of a social step.

Then one JSON line of the kernels and, last, ``{"ok": true, "device": ...}``.
Any failed phase raises, so the script exits non-zero and prints no result;
so does a machine without CUDA or a directory without the package.

    python3 chip_smoke.py --profile OUT_DIR

adds a profile phase before the last two lines: kernel and plain times at
larger rollouts, and ``torch.profiler`` tables of warm rollouts, of a warm
``predict_dataset`` pass, of warm train steps, and of phase 7's pool
rollouts and train steps, written into OUT_DIR.
"""

import argparse
import json
import logging
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
from collections import namedtuple
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
# the fused step's bound: the three products run as 3xTF32 on the tensor
# cores, the rest in f32 on CUDA cores; bytes are each input read once and
# each output written once (positions, presence, h and c in; h', c', the
# normal and the mask out; the f32 weights once)
TENSOR_MACS_PER_ROW = 288 * 256 + 320 * 512 + 128 * 512
CUDA_FLOP_PER_ROW = 2 * (2 * 62 + 128 * 5)
STEP_BYTES_PER_ROW = 2 * 8 + 2 + 2 * 128 * 4 + 2 * 128 * 4 + 5 * 4 + 1
WEIGHT_BYTES = 4 * (3 * 62 + 288 * 256 + 256 + 448 * 512 + 512 + 128 * 5 + 5)
# NVIDIA H100 SXM data sheet, dense: TF32 tensor cores, f32 CUDA cores, HBM
PEAK_TF32, PEAK_F32, PEAK_BYTES = 495e12, 67e12, 3.35e12
DEVICE_SHAPES = ((BATCH_SCENES, 8), (1024, 8), (256, 32))  # (scenes, agents) of phase 4b
STEP_EDGES = ((3, 7), (1, 1), (65, 8))  # phase 3: below one tile, one row, a partial last tile
SERVE_PASSES = 5
CELL_SIDE, N = 0.6, 12
STEP_ATOL, STEP_RTOL = 2e-5, 1e-4
POSITION_ATOL = 1e-3
TRAIN_BATCH, TRAIN_EPOCHS = 8, 2  # the trainer's default batch
TRAIN_TIMED = ((TRAIN_BATCH, 8), (256, 8))  # (scenes, agents) of the timed train steps
# phase 4b's grid stage shapes: a train step, the CLI's batch, two of 8,192
# rows (the 9.4 MB written stays in the 50 MB L2) and one past the L2
GRID_DEVICE_SHAPES = ((TRAIN_BATCH, 8), (BATCH_SCENES, 8), (1024, 8), (256, 32), (8192, 8))
GRID_REPS = 50  # grid-stage launches per profiled window
GRID_EDGE_CONSTANT = 0.25  # the edge cases' `constant`: neither zero nor a velocity
# an f32 step on the card against an f64 step on the CPU
CPU_LOSS_RTOL, CPU_GRAD_RTOL, CPU_GRAD_ATOL_SHARE = 1e-5, 1e-4, 1e-5
# a named leaf whose CPU gradient is below VANISHING of the step's largest is
# zero but for rounding; on the card it is held to CPU_VANISHING_ATOL_SHARE
# of it.  Attention's in_k bias: the softmax ignores a shift common to all
# logits.
VANISHING, CPU_VANISHING_ATOL_SHARE = 1e-12, 1e-6
VANISHING_LEAVES = {"attentionmlp": ("pool/in_k/b",)}
# phase 7: make_pool's trainer defaults at full width, the rollout shapes
# (the CLI's batch and a crowded bucket), the scenes of each rollout held
# against the CPU, the trained types and the synthetic split's sizes
POOL_ARGS = dict(hidden_dim=128, pool_dim=256, n=N, cell_side=CELL_SIDE, latent_dim=16,
                 neigh=4, mp_iters=5)
POOL_EMBEDDING = 64
POOL_ROLLOUTS = ((BATCH_SCENES, 8), (256, 32))
POOL_CPU_SCENES = 16
POOL_TRAINED = (("social", False), ("attentionmlp", False), ("nn_lstm", False),
                ("directional", True))
POOL_SPLIT = (320, 96, 64)  # train, val, test scenes
NEIGHBOUR_GAP = 1e-4  # metres between an agent's nearest neighbour distances


def step_bound(rows):
    """(ms, "operations" or "bytes"): the least time the card could take for
    one fused step over ``rows`` agent rows."""
    ops_s = 6 * TENSOR_MACS_PER_ROW * rows / PEAK_TF32 + CUDA_FLOP_PER_ROW * rows / PEAK_F32
    bytes_s = (STEP_BYTES_PER_ROW * rows + WEIGHT_BYTES) / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def grid_bound_ms(rows, n):
    """The least time for the grid stage over ``rows`` rows at side ``n``: its
    bytes (positions at t-1 and t and two presence bytes in, the 2 n^2 f32
    grid out) at the memory's rate."""
    return 1e3 * (2 * 8 + 2 + 2 * n * n * 4) * rows / PEAK_BYTES


def host_ms(fn, reps=20, warmup=2) -> float:
    """Mean milliseconds of fn on the host's clock, the card synchronised at
    the end (for work whose cost is the host's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sass_counts(library, ops=("HGMMA", "HMMA", "FFMA", "UBLKCP", "STG.E.128")):
    """{kernel: {op: count}} of the built library's SASS (``cuobjdump
    -sass``), for the kernels of ``csrc``, summed over a kernel's template
    instances; None where the toolkit has no cuobjdump."""
    from trajnetplusplusbaselines_torch.ops.cuda import build

    tool = Path(build._nvcc()).parent / "cuobjdump"  # beside the nvcc that built it
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernel = next((k for k in ("fused_step_kernel", "directional_grid_kernel")
                           if k in name), name)
            counts.setdefault(kernel, {})
        elif kernel is not None:
            for op in ops:
                if op in line:
                    counts[kernel][op] = counts[kernel].get(op, 0) + 1
    return counts


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


GridCase = namedtuple("GridCase", "name obs1 obs2 p1 p2 geometry checks")


def grid_edge_cases(rng, dtype=np.float32):
    """Batches for the grid stage, each built to hit one rule of its last
    write, as numpy arrays: positions [S, A, 2] in ``dtype`` (an absent
    agent's are 0), presence [S, A] bool, the geometry (``n``,
    ``cell_side``, ``constant``, ``front``) and ``checks``, what the rule
    gives in the grid: ``(kind, s, i, cell, j)``, kind "constant" (cell
    ``cell`` of agent i's grid in scene s holds ``constant``; every cell
    where ``cell`` is None), "zero", "value" (neighbour j's velocity
    relative to agent i's), or "boundary" (j's offset from i, in whole
    centimetres, is a whole number of cells).  The special agents take the
    highest j of their scene, so no other neighbour overwrites them.  Most
    cases use a cell side of 0.5 m, exact in binary, so that an offset lands
    exactly on a cell edge in f32 and f64 alike."""
    cases = []

    def batch(s, a, absent=0.0):
        """A crowd: positions around the origin, velocities, presence."""
        obs2 = rng.normal(scale=1.5, size=(s, a, 2))
        obs1 = obs2 - rng.normal(scale=0.3, size=(s, a, 2))
        p1, p2 = (rng.random((s, a)) >= absent for _ in range(2))
        p1[:, 0] = p2[:, 0] = True
        return [obs1, obs2, p1, p2]

    def place(b, s, j, xy):
        """Agent j of scene s at ``xy`` at t, moving."""
        b[1][s, j] = xy
        b[0][s, j] = np.asarray(xy, float) - rng.normal(scale=0.3, size=2)
        b[2][s, j] = b[3][s, j] = True

    def add(name, b, checks, n=N, cell_side=0.5, front=False):
        obs1, obs2, p1, p2 = b
        cases.append(GridCase(
            name, np.where(p1[..., None], obs1, 0.0).astype(dtype),
            np.where(p2[..., None], obs2, 0.0).astype(dtype), p1, p2,
            dict(n=n, cell_side=cell_side, constant=GRID_EDGE_CONSTANT, front=front), checks))

    # cell 0 of a 12 x 12 grid at 0.5 m: offsets in [-3, -2.5) on both axes
    b = batch(2, 3)
    place(b, 0, 0, (0.0, 0.0)), place(b, 0, 1, (-2.75, -2.75)), place(b, 0, 2, (10.0, 10.0))
    place(b, 1, 0, (1.5, -1.5)), place(b, 1, 1, (11.5, -11.5)), place(b, 1, 2, (-1.25, -4.25))
    add("cell0_out_of_range_overwrites_in_range", b,
        [("constant", 0, 0, 0, None), ("value", 1, 0, 0, 2)])
    b = batch(1, 4)
    place(b, 0, 0, (0.5, 0.5)), place(b, 0, 1, (0.6, 0.7)), place(b, 0, 2, (0.8, 0.9))
    place(b, 0, 3, (-0.5, 2.5))
    add("two_in_one_cell", b, [("value", 0, 0, 78, 2), ("value", 0, 0, 58, 3)])
    b = batch(3, 3)
    for s in range(3):
        place(b, s, 0, (0.0, 0.0))
    place(b, 0, 1, (-2.75, -2.75)), place(b, 0, 2, (3.0, 0.0))     # outer edge: out of range
    place(b, 1, 1, (10.0, 10.0)), place(b, 1, 2, (-3.0, -3.0))     # lower edge: in, cell 0
    place(b, 2, 1, (-0.5, 0.0)), place(b, 2, 2, (0.0, -0.5))       # inner edges: cells 66, 77
    add("grid_edges", b, [("constant", 0, 0, 0, None), ("value", 1, 0, 0, 2),
                          ("value", 2, 0, 66, 1), ("value", 2, 0, 77, 2),
                          ("constant", 2, 0, 54, None), ("constant", 2, 0, 65, None)])
    b = batch(2, 3)
    place(b, 0, 0, (0.0, 0.0)), place(b, 0, 1, (0.25, 0.25)), place(b, 0, 2, (-1.25, 0.25))
    b[2][0, 1] = False                                             # agent 1 appears at t
    place(b, 1, 0, (0.0, 0.0)), place(b, 1, 1, (0.25, 0.25)), place(b, 1, 2, (20.0, 0.0))
    b[2][1, 0] = False                                             # agent 0 appears at t
    add("appears_at_t", b, [("zero", 0, 0, 78, None), ("value", 0, 0, 42, 2),
                            ("zero", 1, 0, 78, None)])
    b = batch(2, 3)
    place(b, 0, 0, (0.0, 0.0)), place(b, 0, 1, (-2.75, -2.75)), place(b, 0, 2, (1.0, 1.0))
    b[3][0, 2] = False                                             # agent 2 absent at t
    place(b, 1, 0, (0.0, 0.0)), place(b, 1, 1, (1.0, 1.0)), place(b, 1, 2, (-2.75, -2.75))
    b[2][1, 1] = b[3][1, 1] = False                                # agent 1 a padded slot
    add("absent_at_t", b, [("constant", 0, 0, 0, None), ("constant", 0, 2, None, None),
                           ("constant", 1, 1, None, None), ("value", 1, 0, 0, 2)])
    add("a1", batch(3, 1), [("constant", s, 0, None, None) for s in range(3)])
    # crowds around the warp's 32 lanes; cell 78 is offsets [0, 0.6) at 0.6 m
    for a in (31, 32, 33, 150):
        b = batch(2, a, absent=0.1)
        place(b, 0, 0, (0.0, 0.0)), place(b, 0, 1, (0.1, 0.1)), place(b, 0, 2, (-3.3, -3.3))
        place(b, 0, a - 2, (20.0, 20.0)), place(b, 0, a - 1, (0.2, 0.2))
        add(f"a{a}", b, [("value", 0, 0, 78, a - 1), ("constant", 0, 0, 0, None)],
            cell_side=CELL_SIDE)
    b = batch(2, 3)
    for s, far in ((0, 2), (1, 1)):                # one cell of 2 m: offsets [-1, 1)
        place(b, s, 0, (0.0, 0.0)), place(b, s, 3 - far, (0.5, 0.5)), place(b, s, far, (5.0, 5.0))
    add("n1", b, [("constant", 0, 0, 0, None), ("value", 1, 0, 0, 2)], n=1, cell_side=2.0)
    b = batch(2, 9)
    place(b, 0, 0, (0.0, 0.0)), place(b, 0, 7, (-4.0, -4.0)), place(b, 0, 8, (3.9, 3.9))
    add("n32", b, [("value", 0, 0, 0, 7), ("value", 0, 0, 1023, 8)], n=32, cell_side=0.25)
    b = batch(1, 3)
    place(b, 0, 0, (0.0, 0.0)), place(b, 0, 1, (0.25, 0.25)), place(b, 0, 2, (0.25, -0.25))
    add("front", b, [("value", 0, 0, 72, 1), ("constant", 0, 0, 0, None)], front=True)
    # TrajNet++ positions are whole centimetres: offsets of whole cells of
    # 0.6 m, which is not exact in binary
    b = batch(8, 16, absent=0.1)
    place(b, 0, 0, (0.37, -1.21)), place(b, 0, 1, (1.57, -1.81))
    b[0], b[1] = np.round(b[0], 2), np.round(b[1], 2)
    add("centimetres", b, [("boundary", 0, 0, None, 1)], cell_side=CELL_SIDE)
    # more agents than a block stages
    b = batch(1, 1024)
    b[1] *= 3.0
    place(b, 0, 0, (0.0, 0.0)), place(b, 0, 1023, (0.5, 0.5))
    add("a1024", b, [("value", 0, 0, 3, 1023)], n=2, cell_side=2.0)
    return cases


def grid_case_failures(case, grid):
    """The checks of ``case`` that the grid [S, A, 2 n^2] breaks."""
    grid = np.asarray(grid)
    g = case.geometry["n"] ** 2
    failed = []
    for kind, s, i, cell, j in case.checks:
        cells = grid[s, i].reshape(2, g)
        if kind == "boundary":
            steps = np.round(100 * (case.obs2[s, j] - case.obs2[s, i]).astype(np.float64))
            ok = (steps % round(100 * case.geometry["cell_side"]) == 0).all()
        elif kind == "constant":
            got = cells if cell is None else cells[:, cell]
            ok = (got == case.geometry["constant"]).all()
        elif kind == "zero":
            ok = (cells[:, cell] == 0).all()
        else:
            vel = case.obs2[s] - case.obs1[s]
            ok = np.array_equal(cells[:, cell], vel[j] - vel[i])
        if not ok:
            failed.append((kind, s, i, cell, j))
    return failed


def grid_stage_rows(fused_step, dev, rng, shapes=GRID_DEVICE_SHAPES, plain=True) -> dict:
    """{(S, A): row} of the grid stage of ``fused_step`` (the port's module,
    of this checkout or another) at side N: its device ms per launch
    (``torch.profiler``, ``GRID_REPS`` warm launches), its bound and the
    share of it reached and, with ``plain``, the plain grid's ms (CUDA
    events)."""
    rows = {}
    for s, a in shapes:
        obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
        ms = kernel_ms_per_launch(lambda: fused_step.directional_grid(obs1, obs2, p1, p2),
                                  GRID_REPS, "directional_grid_kernel")
        bound = grid_bound_ms(s * a, N)
        rows[(s, a)] = {"rows": s * a, "n": N, "device_ms": ms, "bound_ms": bound,
                        "bound_share": bound / ms}
        if plain:
            rows[(s, a)]["plain_ms"] = time_ms(
                lambda: fused_step.directional_grid_plain(obs1, obs2, p1, p2), reps=10)
    return rows


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


def train_inputs(rng, s, a, device):
    """One training batch at [S, A] as the trainer gathers it: 21 frames of
    random walks (xy [21, S, A, 2] f32), a late-appearing agent, an agent
    absent mid-way, padded slots, and every scene real."""
    xy = rng.normal(scale=0.15, size=(21, s, a, 2)).cumsum(axis=0)
    xy += rng.uniform(-3, 3, size=(1, s, a, 2))
    mask = np.ones((21, s, a), bool)
    mask[:3, :, -1] = False
    if a > 3:
        mask[3:5, :, 1] = False
        mask[:, : s // 2, -2] = False
    xy = np.where(mask[..., None], xy, 0.0).astype(np.float32)
    return (torch.from_numpy(xy).to(device), torch.from_numpy(mask).to(device),
            torch.ones(s, dtype=torch.bool, device=device))


def max_diff(got, want) -> float:
    """Largest absolute difference over two sequences of tensors."""
    return max(float((g.double().cpu() - w.double().cpu()).abs().max()) for g, w in zip(got, want))


# --------------------------------------------------------------- split
def write_split(root, rng, n_scenes=300, big=140, observed_only=("test",),
                full=("test_private",), goals=False):
    """A TrajNet++ split: the ``observed_only`` subsets (test/) hold the 9
    observed frames, the ``full`` ones (test_private/, train/, val/) all 21.
    Scenes of 2..32 agents (buckets 4..32) and, unless ``big`` is None, one
    of ``big``.  With ``goals``, ``goal_files/<subset>/synth.pkl`` for each
    ``full`` subset: every pedestrian's last position.

    Returns per scene (primary's id, observed positions [9, n, 2] as written,
    NaN where absent), agents in the order a TrajNet++ reader gives them:
    the primary, then the others by first frame."""
    sizes = list(rng.integers(2, 33, size=n_scenes - (big is not None)))
    sizes += [big] if big is not None else []
    test, private, observed = [], [], []
    goal_of = {}
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
                goal_of[ped] = (x, y)
                private.append(row)
                if t < 9:
                    test.append(row)
                    xy[t, j] = x, y
        observed.append((scene["scene"]["p"], xy[:, np.argsort(firsts, kind="stable")]))
    for sub, rows in [(sub, test) for sub in observed_only] + [(sub, private) for sub in full]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "synth.ndjson"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    for sub in full if goals else ():
        os.makedirs(os.path.join("goal_files", sub), exist_ok=True)
        with open(os.path.join("goal_files", sub, "synth.pkl"), "wb") as f:
            pickle.dump(goal_of, f)
    return observed


def profiled(fn, reps, table_path, kernel="fused_step_kernel"):
    """Run ``fn`` ``reps`` times, warm, under ``torch.profiler``; write the
    op tables (by device time, and by host time beside it) to
    ``table_path`` (unless None) and return the window's device time, the
    named kernel's part of it and its launches, the device events per rep,
    the wall time and the device's busy share."""
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
    named = [e for e in device if kernel in e.name]
    kernel_ms = sum(e.time_range.elapsed_us() for e in named) / 1e3
    if table_path is not None:
        averages = prof.key_averages()
        key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
               else "self_cuda_time_total")
        Path(table_path).write_text(averages.table(sort_by=key, row_limit=30) + "\n"
                                    + averages.table(sort_by="self_cpu_time_total", row_limit=30))
    return {"reps": reps, "device_ms": device_ms, "kernel": kernel, "kernel_ms": kernel_ms,
            "kernel_launches": len(named), "device_events_per_rep": len(device) / reps,
            "wall_ms": wall_ms, "device_busy": device_ms / wall_ms if wall_ms else 0.0}


def held_window(fn, reps, kernel, at_least, windows=3) -> dict:
    """``profiled(fn, reps, None, kernel)`` of a window whose trace holds at
    least ``at_least`` launches of ``kernel``.  The profiler can drop a
    window's device events, some or all of them: a window short of them is
    profiled again, up to ``windows`` times, and then it raises."""
    for _ in range(windows):
        out = profiled(fn, reps, None, kernel=kernel)
        if out["kernel_launches"] >= at_least:
            return out
    raise AssertionError(f"{windows} windows of {reps} calls held {out['kernel_launches']} "
                         f"launches of {kernel!r}, the last, for {at_least} wanted")


def kernel_ms_per_launch(fn, reps, kernel) -> float:
    """Device ms per launch of ``kernel`` over ``reps`` warm calls of ``fn``,
    each launching it once (``torch.profiler``): the mean over the launches
    the trace holds, at least half of them (``held_window``)."""
    out = held_window(fn, reps, kernel, reps / 2)
    if out["kernel_launches"] > reps:
        raise AssertionError(f"{reps} calls left {out['kernel_launches']} launches of {kernel}")
    return out["kernel_ms"] / out["kernel_launches"]


def step_on(trainer, batch, device, dtype):
    """(loss, gradients) of one train step with ``trainer``'s params as
    ``dtype`` on ``device`` (data as it is, moved there)."""
    from trajnetplusplusbaselines_torch.trainers import lstm as train_cli
    from trajnetplusplusbaselines_torch.trainers.common import step_lr
    from trajnetplusplusbaselines_torch.utils.convert import params_from_jax, params_to_numpy

    other = train_cli.Trainer(trainer.model, params_from_jax(
        params_to_numpy(trainer.params), device=device, dtype=dtype), step_lr(1e-3, 10))
    return other.loss_and_grads(*(x.to(device) for x in batch))


def step_errors(got, want, paths, vanishing=()):
    """(loss relative error, largest gradient error as a share of its leaf's
    largest) of the step ``got`` against the f64 step ``want``; raises beyond
    the tolerances.  The leaves named in ``vanishing`` whose f64 gradient is
    zero but for rounding are held to a share of the step's largest."""
    (loss_k, grads_k), (loss_c, grads_c) = got, want
    loss_rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
    if loss_rel > CPU_LOSS_RTOL:
        raise AssertionError(f"losses differ by {loss_rel} relative")
    grad_err = 0.0
    step_scale = max(float(w.abs().max()) for w in grads_c)
    for path, g, w in zip(paths, grads_k, grads_c):
        scale = float(w.abs().max())
        if path in vanishing and scale <= VANISHING * step_scale:
            if float(g.abs().max()) > CPU_VANISHING_ATOL_SHARE * step_scale:
                raise AssertionError(f"gradient of {path} is {float(g.abs().max())}, "
                                     f"where the f64 one vanishes")
            continue
        torch.testing.assert_close(g.cpu().double(), w, rtol=CPU_GRAD_RTOL,
                                   atol=CPU_GRAD_ATOL_SHARE * scale,
                                   msg=lambda m: f"gradient of {path}: {m}")
        grad_err = max(grad_err, max_diff([g], [w]) / max(scale, 1e-30))
    return loss_rel, grad_err


def check_against_cpu(trainer, batch):
    """An f32 train step on the card against an f64 step on the CPU from the
    same params and batch: (loss relative error, largest gradient error as
    a share of its leaf's largest).  Raises beyond the tolerances."""
    return step_errors(trainer.loss_and_grads(*batch),
                       step_on(trainer, batch, "cpu", torch.float64), trainer.paths)


def train_phase(dev, rng) -> dict:
    """Phase 6: train the flagship D-LSTM through ``trainers.lstm.main`` on
    ``dev`` and check it (see the module's docstring).  Returns the launch
    counts of that run, the timings and the timed trainer."""
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli
    from trajnetplusplusbaselines_torch.models import lstm as lstm_module
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.trainers import lstm as train_cli
    from trajnetplusplusbaselines_torch.trainers.common import bucket_batches, step_lr
    from trajnetplusplusbaselines_torch.utils.convert import params_from_jax, params_to_numpy

    cwd = os.getcwd()
    root, name = "DATA_BLOCK/synth_train", "lstm_directional_smoke"
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            write_split(root, rng, n_scenes=320, big=None, observed_only=(), full=("train",))
            write_split(root, rng, n_scenes=96, big=None, observed_only=(), full=("val",))
            test_observed = write_split(root, rng, n_scenes=64, big=None)

            fused_step.fused_dlstm_step.launches = 0
            fused_step.directional_grid.launches = 0
            t0 = time.perf_counter()
            trainer = train_cli.main(argv=[
                "--path", "synth_train", "--type", "directional", "--n", str(N),
                "--cell_side", str(CELL_SIDE), "--pool_dim", "256", "--hidden-dim", "128",
                "--coordinate-embedding-dim", "64", "--epochs", str(TRAIN_EPOCHS),
                "--batch_size", str(TRAIN_BATCH), "--save_every", "1", "--seed", "0",
                "-o", "smoke", "--device", DEVICE])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_launches = {"fused_dlstm_step": fused_step.fused_dlstm_step.launches,
                              "directional_grid": fused_step.directional_grid.launches}
            for handler in logging.getLogger().handlers[:]:  # the trainer's log file
                handler.close()
                logging.getLogger().removeHandler(handler)

            # batches per epoch from the datasets the trainer made resident on
            # the card, train first (epoch 0 trains before it validates)
            (train_ds, resident), (val_ds, val_resident) = trainer._resident.values()

            def batches_per_epoch(dataset):
                plan = dataset.epoch_plan(TRAIN_BATCH, np.random.default_rng(0), shuffle=False)
                return sum(idx.shape[0] for idx, _ in plan.values())

            train_batches, val_batches = map(batches_per_epoch, (resident, val_resident))
            n_train, n_val = len(train_ds), len(val_ds)
            want = {"fused_dlstm_step": 2 * 19 * val_batches * TRAIN_EPOCHS,
                    "directional_grid": 19 * train_batches * TRAIN_EPOCHS}
            if train_launches != want:
                raise AssertionError(f"training launched {train_launches}, expected {want}")
            out = f"OUTPUT_BLOCK/synth_train/{name}.pkl"
            with open(out + ".log") as f:
                records = [json.loads(line) for line in f]
            by_type = {kind: [r for r in records if r.get("type") == kind]
                       for kind in ("train", "train-epoch", "val-epoch")}
            losses = ([r["loss"] for r in by_type["train"] + by_type["train-epoch"]]
                      + [r[k] for r in by_type["val-epoch"] for k in ("loss", "test_loss")])
            epoch_losses = [r["loss"] for r in by_type["train-epoch"]]
            if (len(epoch_losses) != TRAIN_EPOCHS or len(by_type["val-epoch"]) != TRAIN_EPOCHS
                    or not np.isfinite(losses).all()):
                raise AssertionError(f"training logged {by_type}")
            if not epoch_losses[1] < epoch_losses[0]:
                raise AssertionError(f"train loss did not fall: {epoch_losses}")

            # the trained pickle serves the test part through lstm_cli
            table = lstm_cli.main(["--path", "synth_train", "--output", out, "--device", DEVICE])
            served = table.results[f"{name}_modes1"][32:40]
            if served[0] != len(test_observed) or not np.isfinite(served[1:3]).all():
                raise AssertionError(f"the trained model scored {served}")

            # one batch of the train split, gathered on the card
            key =(21, 8) if (21, 8) in resident.buckets else next(iter(resident.buckets))
            idx, valid = resident.epoch_plan(TRAIN_BATCH, np.random.default_rng(1))[key]
            batch = next(bucket_batches(resident.buckets[key], idx, valid))
            rotated = next(bucket_batches(resident.buckets[key], idx, valid, augment=True,
                                          generator=torch.Generator(device=dev).manual_seed(0)))
            flat = [x[0].reshape(-1, key[1], 2) for x in (batch, rotated)]
            rotation_err = max_diff([torch.cdist(flat[1], flat[1])], [torch.cdist(flat[0], flat[0])])
            if rotation_err > 1e-4:
                raise AssertionError(f"rotation moved pairwise distances by {rotation_err} m")
        finally:
            os.chdir(cwd)

    # one train step with the grid kernel and with the plain grid
    loss_k, grads_k = trainer.loss_and_grads(*batch)
    launched = fused_step.directional_grid.launches
    with mock.patch.object(lstm_module, "directional_grid", fused_step.directional_grid_plain):
        loss_p, grads_p = trainer.loss_and_grads(*batch)
    if fused_step.directional_grid.launches != launched:
        raise AssertionError("the plain-grid train step launched the grid kernel")
    grid_train_err = max_diff([loss_k, *grads_k], [loss_p, *grads_p])
    for path, g, w in zip(("loss", *trainer.paths), [loss_k, *grads_k], [loss_p, *grads_p]):
        if not torch.equal(g, w):
            raise AssertionError(f"{path} with the grid kernel differs from the plain grid's "
                                 f"by {max_diff([g], [w])}")

    # an f32 step on the card against an f64 step on the CPU
    cpu_loss_rel, cpu_grad_err = check_against_cpu(trainer, batch)

    # warm train steps (CUDA events), and the grid kernel at the batch-8 shape
    timed = train_cli.Trainer(trainer.model, params_from_jax(params_to_numpy(trainer.params),
                                                             device=dev), step_lr(1e-3, 10))
    train_times = {}
    for s, a in TRAIN_TIMED:
        b = train_inputs(rng, s, a, dev)
        reps = 20 if s <= TRAIN_BATCH else 10
        train_times[(s, a)] = {
            "train_step_ms": time_ms(lambda: timed.train_step(*b), reps=reps),
            "fwd_bwd_ms": time_ms(lambda: timed.loss_and_grads(*b), reps=reps),
        }
        train_times[(s, a)]["train_scenes_per_s"] = s / train_times[(s, a)]["train_step_ms"] * 1e3
    # per call: the wrapper's host time and the launch, not the kernel alone
    obs1, obs2, p1, p2 = step_inputs(rng, TRAIN_BATCH, 8, dev)
    grid_ms = time_ms(lambda: fused_step.directional_grid(obs1, obs2, p1, p2), reps=50)
    plain_grid_ms = time_ms(lambda: fused_step.directional_grid_plain(obs1, obs2, p1, p2),
                            reps=50)
    say("train", train_scenes=n_train, val_scenes=n_val, train_batches_per_epoch=train_batches,
        val_batches_per_epoch=val_batches, epochs=TRAIN_EPOCHS, cli_seconds=train_s,
        launches=train_launches, epoch_losses=epoch_losses,
        val_losses=[(r["loss"], r["test_loss"]) for r in by_type["val-epoch"]],
        served_ade_fde=served[1:3], rotation_err_m=rotation_err, check_bucket=key,
        grid_vs_plain_max_diff=grid_train_err,
        cpu_loss_rel_err=cpu_loss_rel, cpu_grad_max_err_share=cpu_grad_err,
        grid_per_call_ms=grid_ms, plain_grid_ms=plain_grid_ms,
        steps={f"{s}x{a}": row for (s, a), row in train_times.items()})
    print("Train  " + "  ".join(
        "S={} A={}: {:.3f} ms/step, {:.1f} scenes/s".format(
            s, a, row["train_step_ms"], row["train_scenes_per_s"])
        for (s, a), row in train_times.items())
        + "  grid {:.4f} ms per call vs plain {:.4f} ms".format(grid_ms, plain_grid_ms),
        flush=True)
    return {"launches": train_launches, "grid_ms": grid_ms, "plain_grid_ms": plain_grid_ms,
            "timed": timed}


def device_phase(dev, rng, model, params, rollout_ms) -> dict:
    """Phase 4b: the fused step's device time per launch under
    ``torch.profiler`` at ``DEVICE_SHAPES``, its bound and the share of the
    bound reached, and its library yardstick: the three products alone
    (grid embedding and the two gate products, one ``torch.addmm`` each, on
    the same weights) in f32 with TF32 off, and again with TF32 on; the port
    never calls it.  The weight preparation's cost per rollout (the packing
    of both cells, uncached, and ``LSTM.step_weights`` as a rollout calls
    it, cached), against ``rollout_ms`` of a rollout at the CLI's batch.
    Then the grid stage at ``GRID_DEVICE_SHAPES`` (``grid_stage_rows``).
    Returns {"shapes": {(S, A): row}, "prep": row, "grid": {(S, A): row}}."""
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step

    shapes = {}
    reps = 20
    with tempfile.TemporaryDirectory() as tmp:
        for s, a in DEVICE_SHAPES:
            n = s * a
            obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
            h, c = (torch.randn(s, a, 128, device=dev) * 0.5 for _ in range(2))
            w = model.step_weights(params, "decoder", "fused")
            device_ms = kernel_ms_per_launch(
                lambda: fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, w), reps,
                "fused_step_kernel")
            grid, inp = torch.rand(n, 288, device=dev), torch.rand(n, 320, device=dev)
            hh = h.reshape(n, 128)

            def products():
                torch.addmm(w["b_grid"], grid, w["w_grid"])
                torch.addmm(torch.addmm(w["b_gates"], inp, w["w_ih"]), hh, w["w_hh"])

            library = {}
            for tf32 in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                try:
                    # every launch of the window: three products a rep
                    library[tf32] = held_window(products, reps, "", 3 * reps)["device_ms"] / reps
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            bound_ms, bound_by = step_bound(n)
            shapes[(s, a)] = row = {
                "rows": n, "device_ms": device_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_share": bound_ms / device_ms, "library_f32_ms": library[False],
                "library_tf32_ms": library[True], "tflops": FLOP_PER_ROW * n / device_ms / 1e9}
            say("device", s=s, a=a, **row)

        cells = ("encoder", "decoder")
        sources = [fused_step.weights_from_params(params, cell) for cell in cells]

        def pack():
            for src in sources:
                fused_step.pack_weights(src["w_grid"], src["w_ih"], src["w_hh"],
                                        **fused_step.PACK_LAYOUT)

        pack_ms = host_ms(pack, reps=10)
        pack_events = profiled(pack, 5, Path(tmp) / "pack.txt", kernel="")
        cached_ms = host_ms(lambda: [model.step_weights(params, cell, "fused") for cell in cells])
    prep = {"packs_per_rollout": len(cells), "pack_ms_per_rollout": pack_ms,
            "pack_launches_per_rollout": pack_events["device_events_per_rep"],
            "pack_device_ms_per_rollout": pack_events["device_ms"] / 5,
            "cached_step_weights_ms_per_rollout": cached_ms,
            "rollout_ms": rollout_ms, "pack_share_of_rollout": pack_ms / rollout_ms,
            "cached_share_of_rollout": cached_ms / rollout_ms}
    say("weight_prep", **prep)
    grid = grid_stage_rows(fused_step, dev, rng)
    for (s, a), row in grid.items():
        say("device_grid", s=s, a=a, **row)
    print("Device  " + "  ".join(
        "S={} A={}: {:.4f} ms/step ({:.0%} of the {:.4f} ms bound), library f32 {:.4f} / "
        "tf32 {:.4f} ms".format(s, a, r["device_ms"], r["bound_share"], r["bound_ms"],
                                r["library_f32_ms"], r["library_tf32_ms"])
        for (s, a), r in shapes.items()), flush=True)
    print("Grid  " + "  ".join(
        "S={} A={}: {:.2f} us ({:.0%} of the {:.2f} us bound)".format(
            s, a, 1e3 * r["device_ms"], r["bound_share"], 1e3 * r["bound_ms"])
        for (s, a), r in grid.items()), flush=True)
    return {"shapes": shapes, "prep": prep, "grid": grid}


def pool_models() -> dict:
    """Phase 7's models, name -> ``LSTM``: the ten pooled ``--type`` values
    at ``make_pool``'s trainer defaults, a two-layer S-LSTM, a stateful
    ``lstm_layer`` D-LSTM, a goal D-LSTM and a D-LSTM at n=8, hidden 64."""
    from types import SimpleNamespace

    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.pooling import POOL_TYPES, make_pool

    def model(type_, goal_flag=False, **kw):
        args = SimpleNamespace(**{**POOL_ARGS, **kw})
        return LSTM(pool=make_pool(type_, args), embedding_dim=POOL_EMBEDDING,
                    hidden_dim=args.hidden_dim, goal_flag=goal_flag)

    models = {t: model(t) for t in POOL_TYPES[1:]}
    models["social_two_layer"] = model("social", embedding_arch="two_layer")
    models["directional_lstm_layer"] = model("directional", embedding_arch="lstm_layer")
    models["directional_goals"] = model("directional", goal_flag=True)
    models["directional_n8"] = model("directional", n=8, hidden_dim=64, pool_dim=64)
    return models


def close_neighbours(xy, mask, k):
    """[S] bool: scenes where some agent's k + 1 nearest neighbours at some
    frame lie within ``NEIGHBOUR_GAP`` of each other's distance."""
    d = np.linalg.norm(xy[:, :, :, None] - xy[:, :, None, :], axis=-1)  # [T, S, A, A]
    valid = mask[:, :, :, None] & mask[:, :, None, :] & ~np.eye(xy.shape[2], dtype=bool)
    d = np.sort(np.where(valid, d, np.inf), axis=-1)[..., : k + 1]
    gaps = np.diff(d, axis=-1)
    return ((gaps < NEIGHBOUR_GAP) & np.isfinite(d[..., 1:])).any(axis=(0, 2, 3))


def pool_inputs(rng, s, a, device):
    """``rollout_inputs`` with every agent's nearest neighbours at distances
    ``NEIGHBOUR_GAP`` apart or more (scenes redrawn until they are), so that
    the nearest-neighbour order is the same on the card and on the CPU;
    goals [S, A, 2], agent 0's on its last observed position; and the slot
    mask, the slots observed at some frame."""
    xy, mask = (x.numpy() for x in rollout_inputs(rng, s, a, "cpu"))
    for _ in range(200):
        bad = close_neighbours(xy, mask, POOL_ARGS["neigh"])
        if not bad.any():
            break
        redrawn = rollout_inputs(rng, s, a, "cpu")[0].numpy()
        xy[:, bad] = redrawn[:, bad]
    else:
        raise AssertionError("could not draw scenes with separated neighbours")
    goals = rng.uniform(-5, 5, size=(s, a, 2)).astype(np.float32)
    goals[:, 0] = xy[-1, :, 0]
    return [torch.from_numpy(x).to(device)
            for x in (xy, mask, goals, mask.any(axis=0))]


def pools_phase(dev, rng) -> dict:
    """Phase 7 (see the module's docstring).  Returns the launch counts of
    its rollouts and its training and serving runs."""
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli
    from trajnetplusplusbaselines_torch.evaluator.learned import bucket_plan
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling
    from trajnetplusplusbaselines_torch.trainers import lstm as train_cli
    from trajnetplusplusbaselines_torch.trainers.common import Batch
    from trajnetplusplusbaselines_torch.utils.convert import params_to

    kernels = (("fused_dlstm_step", fused_step.fused_dlstm_step),
               ("directional_grid", fused_step.directional_grid))
    totals = {name: 0 for name, _ in kernels}

    def zero():
        for _, fn in kernels:
            fn.launches = 0

    def read(want):
        got = {name: fn.launches for name, fn in kernels}
        for name in totals:
            totals[name] += got[name]
        if got != want:
            raise AssertionError(f"launched {got}, expected {want}")
        return got

    # (a) rollouts of every pool at two shapes, card against CPU
    inputs = {shape: pool_inputs(rng, *shape, dev) for shape in POOL_ROLLOUTS}
    rollout_ms = {}
    for name, model in pool_models().items():
        params = model.init_params(torch.Generator().manual_seed(7), device=dev)
        cpu_params = params_to(params, "cpu")
        route = model.route(records=False)
        for s, a in POOL_ROLLOUTS:
            xy, mask, goals, slot = inputs[(s, a)]
            kw = dict(n_predict=12, goals=goals, slot_mask=slot)
            zero()
            with torch.no_grad():
                _, pred, valid = model.forward(params, xy, mask, **kw)
            torch.cuda.synchronize()
            launches = read({"fused_dlstm_step": 19 * (route == "fused"),
                             "directional_grid": 19 * (route == "grid")})
            k = POOL_CPU_SCENES
            with torch.no_grad():
                _, cpu_pred, cpu_valid = model.forward(
                    cpu_params, xy[:, :k].cpu(), mask[:, :k].cpu(), n_predict=12,
                    goals=goals[:k].cpu(), slot_mask=slot[:k].cpu())
            if pred.shape != (19, s, a, 2) or not torch.isfinite(pred).all():
                raise AssertionError(f"{name}: positions are not finite [19, S, A, 2]")
            if not torch.equal(valid[:, :k].cpu(), cpu_valid):
                raise AssertionError(f"{name}: validity differs from the CPU's at S={s} A={a}")
            err = float((pred[:, :k].cpu() - cpu_pred)[cpu_valid].abs().max())
            if err > POSITION_ATOL:
                raise AssertionError(f"{name}: positions differ from the CPU's by {err} m "
                                     f"at S={s} A={a}")
            with torch.no_grad():
                ms = time_ms(lambda: model.forward(params, xy, mask, **kw), reps=5, warmup=2)
            rollout_ms[(name, s, a)] = ms
            say("pools_rollout", model=name, s=s, a=a, route=route, launches=launches,
                max_position_err_m=err, cpu_scenes=k, rollout_ms=ms,
                rollout_scenes_per_s=s / ms * 1e3)

    # the grid stage alone at the geometries the grid route gives it: n=8,
    # n=12, n=12 with front, and pool_size 2 (side 24 at half the cell);
    # kernel against plain, bit-exact; the kernel's device time against its
    # bound at that side, and the time per call of both
    geometries = {"n8": dict(n=8), f"n{N}": dict(n=N), f"n{N}_front": dict(n=N, front=True),
                  f"n{2 * N}_pool2": GridBasedPooling(
                      type_="directional", n=N, cell_side=CELL_SIDE, pool_size=2).grid_stage_args}
    grid_us, grid_err = {}, 0.0
    for s, a in ((TRAIN_BATCH, 8), *POOL_ROLLOUTS):
        obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
        for tag, geometry in geometries.items():
            geometry = {"cell_side": CELL_SIDE, **geometry}
            got = fused_step.directional_grid(obs1, obs2, p1, p2, **geometry)
            want = fused_step.directional_grid_plain(obs1, obs2, p1, p2, **geometry)
            torch.cuda.synchronize()
            grid_err = max(grid_err, max_diff([got], [want]))
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:5].tolist()
                raise AssertionError(f"grid {tag} differs at S={s} A={a}: first cells {bad}")
            def kernel():
                return fused_step.directional_grid(obs1, obs2, p1, p2, **geometry)

            device_us = 1e3 * kernel_ms_per_launch(kernel, GRID_REPS, "directional_grid_kernel")
            bound_us = 1e3 * grid_bound_ms(s * a, geometry["n"])
            grid_us[f"S{s}xA{a}_{tag}"] = {
                "n": geometry["n"], "device_us": device_us, "bound_us": bound_us,
                "bound_share": bound_us / device_us,
                "per_call_us": 1e3 * time_ms(kernel, reps=50),
                "plain_us": 1e3 * time_ms(lambda: fused_step.directional_grid_plain(
                    obs1, obs2, p1, p2, **geometry), reps=50),
                "cells_hit": int((got != 0).sum())}
    say("pools_grid", bit_exact=True, max_abs_err=grid_err, **grid_us)

    # (b) training and serving through the CLIs, one epoch per type
    cwd = os.getcwd()
    root = "DATA_BLOCK/synth_pools"
    trained = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            n_train, n_val, n_test = POOL_SPLIT
            write_split(root, rng, n_scenes=n_train, big=None, observed_only=(),
                        full=("train",), goals=True)
            write_split(root, rng, n_scenes=n_val, big=None, observed_only=(),
                        full=("val",), goals=True)
            observed = write_split(root, rng, n_scenes=n_test, big=None, goals=True)
            serve_plan = bucket_plan([xy.shape[1] for _, xy in observed], BATCH_SCENES)
            for kind, goals in POOL_TRAINED:
                zero()
                t0 = time.perf_counter()
                trainer = train_cli.main(argv=[
                    "--path", "synth_pools", "--type", kind, "--n", str(POOL_ARGS["n"]),
                    "--cell_side", str(POOL_ARGS["cell_side"]),
                    "--pool_dim", str(POOL_ARGS["pool_dim"]),
                    "--hidden-dim", str(POOL_ARGS["hidden_dim"]),
                    "--coordinate-embedding-dim", str(POOL_EMBEDDING),
                    "--latent_dim", str(POOL_ARGS["latent_dim"]),
                    "--neigh", str(POOL_ARGS["neigh"]), "--mp_iters", str(POOL_ARGS["mp_iters"]),
                    "--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--seed", "0",
                    "-o", "pools", "--device", DEVICE, *(["--goals"] if goals else [])])
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t0
                for handler in logging.getLogger().handlers[:]:  # the trainer's log file
                    handler.close()
                    logging.getLogger().removeHandler(handler)
                (_, resident), (_, val_resident) = trainer._resident.values()
                batches = [sum(idx.shape[0] for idx, _ in
                               r.epoch_plan(TRAIN_BATCH, np.random.default_rng(0)).values())
                           for r in (resident, val_resident)]
                route = trainer.model.route(records=True)
                train_launches = read({"fused_dlstm_step": 0, "directional_grid":
                                       19 * (batches[0] + 2 * batches[1]) * (route == "grid")})
                out = f"OUTPUT_BLOCK/synth_pools/{'lstm_goals' if goals else 'lstm'}_{kind}_pools.pkl"
                with open(out + ".log") as f:
                    records = [json.loads(line) for line in f]
                losses = [r[key] for r in records for key in ("loss", "test_loss")
                          if r.get("type") in ("train", "train-epoch", "val-epoch") and key in r]
                if not losses or not np.isfinite(losses).all():
                    raise AssertionError(f"{kind}: training logged {records}")

                zero()
                table = lstm_cli.main(["--path", "synth_pools", "--output", out,
                                       "--device", DEVICE])
                torch.cuda.synchronize()
                serve_launches = read({"fused_dlstm_step": 0, "directional_grid":
                                       19 * len(serve_plan) * (route == "grid")})
                served = table.results[os.path.basename(out)[:-4] + "_modes1"][32:40]
                if served[0] != n_test or not np.isfinite(served[1:3]).all():
                    raise AssertionError(f"{kind}: the trained model scored {served}")

                trained[kind] = trainer
                say("pools_train", type=kind, goals=goals, route=route, cli_seconds=cli_s,
                    train_batches=batches[0], val_batches=batches[1],
                    train_launches=train_launches, serve_launches=serve_launches,
                    epoch_loss=[r["loss"] for r in records if r.get("type") == "train-epoch"],
                    served_ade_fde=served[1:3])
        finally:
            os.chdir(cwd)

    # (c) one train step on the card against the CPU, its time and memory.
    # A grid is not continuous in the positions, so the f32 and f64 steps
    # agree only where no neighbour sits within rounding of a cell boundary.
    # The split's positions are whole centimetres, and 0.6 m is not exact in
    # f32: every offset of a multiple of 0.6 m lands in another cell in f32
    # than in f64.  So the check runs on a random-walk batch.
    xy, mask, scene = train_inputs(rng, TRAIN_BATCH, 8, dev)
    batch = Batch(xy, mask, scene, torch.zeros_like(xy[0]), mask.any(dim=0))
    for kind in ("social", "attentionmlp"):
        trainer = trained[kind]
        loss_rel, grad_err = step_errors(trainer.loss_and_grads(*batch),
                                         step_on(trainer, batch, "cpu", torch.float64),
                                         trainer.paths, VANISHING_LEAVES.get(kind, ()))
        step_ms = time_ms(lambda: trainer.train_step(*batch), reps=10)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        peak = {f"A{batch.xy.shape[2]}": torch.cuda.max_memory_allocated() - base}
        if kind == "social":  # and in a crowded bucket
            crowded = train_inputs(rng, TRAIN_BATCH, 32, dev)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            trainer.train_step(*crowded)
            torch.cuda.synchronize()
            peak["A32"] = torch.cuda.max_memory_allocated() - base
        say("pools_step", type=kind, batch=list(batch.xy.shape), cpu_loss_rel_err=loss_rel,
            cpu_grad_max_err_share=grad_err, train_step_ms=step_ms,
            train_scenes_per_s=TRAIN_BATCH / step_ms * 1e3, step_peak_bytes=peak)
    print("Pools  " + "  ".join(f"{m} {s}x{a}: {ms:.2f} ms"
                                for (m, s, a), ms in rollout_ms.items()), flush=True)
    return {"launches": totals, "grid_err": grid_err, "grid": grid_us}


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
    ptxas = ([line.strip() for line in log.read_text().splitlines()
              if "registers" in line or "spill" in line or "entry function" in line]
             if log.exists() else [])
    sass = sass_counts(build.library_path())
    if sass is not None and not sass.get("fused_step_kernel", {}).get("HGMMA"):
        raise AssertionError(f"fused_step_kernel has no tensor-core instruction: {sass}")
    if sass is not None and not sass.get("directional_grid_kernel", {}).get("STG.E.128"):
        raise AssertionError(f"directional_grid_kernel has no 16-byte store: {sass}")
    say("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=build.build_seconds,
        dims=build.kernel_dims(), ptxas=ptxas, sass=sass)

    rng = np.random.default_rng(0)
    pool = GridBasedPooling(type_="directional", hidden_dim=128, cell_side=CELL_SIDE, n=N,
                            out_dim=256)
    model = LSTM(pool=pool, embedding_dim=64, hidden_dim=128)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)

    # ---- 2: grid, bit-exact
    grid_err = 0.0
    for a in BUCKETS:
        s = math.ceil(ROWS_PER_BUCKET / a)
        obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
        got = fused_step.directional_grid(obs1, obs2, p1, p2, cell_side=CELL_SIDE)
        want = fused_step.directional_grid_plain(obs1, obs2, p1, p2, cell_side=CELL_SIDE)
        torch.cuda.synchronize()
        grid_err = max(grid_err, max_diff([got], [want]))
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"grid differs at A={a}: first cells {bad}")
        say("grid", a=a, s=s, bit_exact=True, cells_hit=int((got != 0).sum()))
    for case in grid_edge_cases(np.random.default_rng(3)):
        obs1, obs2 = (torch.from_numpy(x).to(dev) for x in (case.obs1, case.obs2))
        p1, p2 = (torch.from_numpy(x).to(dev) for x in (case.p1, case.p2))
        got = fused_step.directional_grid(obs1, obs2, p1, p2, **case.geometry)
        want = fused_step.directional_grid_plain(obs1, obs2, p1, p2, **case.geometry)
        torch.cuda.synchronize()
        grid_err = max(grid_err, max_diff([got], [want]))
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"grid edge case {case.name} differs: first cells {bad}")
        failed = grid_case_failures(case, got.cpu())
        if failed:
            raise AssertionError(f"grid edge case {case.name} misses its rules: {failed}")
        say("grid_edge", case=case.name, s=case.obs2.shape[0], a=case.obs2.shape[1],
            bit_exact=True, checks=len(case.checks), **case.geometry)

    # ---- 3: fused step, at the buckets and at row counts off the 64-row tile
    step_err = 0.0
    edge_rng = np.random.default_rng(1)  # the later phases draw from rng as before
    for s, a, gen in ([(math.ceil(ROWS_PER_BUCKET / a), a, rng) for a in BUCKETS]
                      + [(s, a, edge_rng) for s, a in STEP_EDGES]):
        obs1, obs2, p1, p2 = step_inputs(gen, s, a, dev)
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

    # ---- 4b: the fused step's device time, bound and library yardstick
    device = device_phase(dev, np.random.default_rng(2), model, params,
                          times[ROLLOUTS[0]]["rollout_ms"])

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


    # ---- 6: train, the main path's second entry point
    train = train_phase(dev, rng)

    # ---- 7: pools: every interaction module, rolled out, trained and served
    pools = pools_phase(dev, rng)

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
        for s, a in TRAIN_TIMED:
            b = train_inputs(rng, s, a, dev)
            say("profile_trace", what=f"train_step S={s} A={a}", **profiled(
                lambda: train["timed"].train_step(*b), 10, out / f"train_step_{s}x{a}.txt",
                kernel="directional_grid_kernel"))
        # phase 7's pools: rollouts in the crowded bucket and a train step
        from trajnetplusplusbaselines_torch.trainers.lstm import Trainer
        from trajnetplusplusbaselines_torch.trainers.common import Batch, step_lr

        models = pool_models()
        s, a = POOL_ROLLOUTS[-1]
        xy, mask, goals, slot = pool_inputs(rng, s, a, dev)
        for name in ("social", "attentionmlp", "nmmp", "directional_goals"):
            model = models[name]
            pool_params = model.init_params(torch.Generator().manual_seed(7), device=dev)

            def rollout():
                with torch.no_grad():
                    model.forward(pool_params, xy, mask, n_predict=12, goals=goals,
                                  slot_mask=slot)

            say("profile_trace", what=f"{name} rollout S={s} A={a}", **profiled(
                rollout, 3, out / f"pools_{name}_{s}x{a}.txt", kernel="directional_grid_kernel"))
            if name in ("social", "attentionmlp"):
                trainer = Trainer(model, pool_params, step_lr(1e-3, 10))
                b_xy, b_mask, b_scene = train_inputs(rng, TRAIN_BATCH, 8, dev)
                batch = Batch(b_xy, b_mask, b_scene, torch.zeros_like(b_xy[0]),
                              b_mask.any(dim=0))
                say("profile_trace", what=f"{name} train_step S={TRAIN_BATCH} A=8",
                    **profiled(lambda: trainer.train_step(*batch), 5,
                               out / f"pools_{name}_train_step.txt"))

    main_s, main_a = ROLLOUTS[0]
    main_device = device["shapes"][(main_s, main_a)]
    train_grid = device["grid"][(TRAIN_BATCH, 8)]
    csrc = "trajnetplusplusbaselines_torch/csrc/"
    by_path = {name: {"serve": main_launches[name], "train": train["launches"][name],
                      "pools": pools["launches"][name]}
               for name in main_launches}
    print(json.dumps({"kernels": [{
        "name": "fused_dlstm_step",
        "route": "cuda",
        "source": csrc + "fused_step.cu",
        "replaces": "trajnetplusplusbaselines_tpu/ops/pallas/fused_step.py:52",
        "launches": sum(by_path["fused_dlstm_step"].values()),
        "launches_by_path": by_path["fused_dlstm_step"],
        "max_abs_err": step_err,
        "ms": times[(main_s, main_a)]["step_ms"],
        "plain_ms": times[(main_s, main_a)]["plain_step_ms"],
        "device_ms": main_device["device_ms"],
        "bound_ms": main_device["bound_ms"],
        "bound_by": main_device["bound_by"],
        "library_ms": main_device["library_f32_ms"],
        "library_tf32_ms": main_device["library_tf32_ms"],
        "shapes": {f"{s}x{a}": row for (s, a), row in device["shapes"].items()},
    }, {
        # the fused kernel's grid stage alone, launched by the training step
        # and by every other directional grid
        "name": "directional_grid",
        "route": "cuda",
        "source": csrc + "directional_grid.cu",
        "replaces": "trajnetplusplusbaselines_tpu/ops/pallas/fused_step.py:76",
        "launches": sum(by_path["directional_grid"].values()),
        "launches_by_path": by_path["directional_grid"],
        "max_abs_err": max(grid_err, pools["grid_err"]),
        # device time per launch at a train step's S=8, A=8, and its bound there
        "ms": train_grid["device_ms"],
        "device_ms": train_grid["device_ms"],
        "plain_ms": train["plain_grid_ms"],
        "bound_ms": train_grid["bound_ms"],
        "bound_by": "bytes",
        "bound_share": train_grid["bound_share"],
        "per_call_ms": train["grid_ms"],
        # no single PyTorch call computes a last-write-wins scatter: index_put_
        # and scatter_ leave the winner among duplicate indices unspecified
        "library_ms": None,
        "shapes": {f"{s}x{a}": row for (s, a), row in device["grid"].items()},
        "geometries": pools["grid"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
