#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: every model family, trainer, option, tool.

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
   plain, positions within 1e-3 m free and within 4e-5 m along the fused
   rollout's own trajectory (``along_positions``: the model's step on the
   CPU fed that rollout's inputs, so both see the same grids), 19 kernel
   launches per rollout, and the per-step and per-rollout times of both
   (CUDA events, after warm-up), at the CLI's own batch (64 scenes of 8
   agents) and two larger ones;
   (b) the fused kernel's device time per launch (``torch.profiler``) at
   those three shapes and at the bench cell's 1,048,576 rows, its bound
   (3xTF32 on the tensor cores or the bytes, whichever is larger) and the
   share of it reached, the plain step's time, the library yardstick (the
   three products alone through ``torch.addmm``, f32 with TF32 off and
   on), and the weight preparation's cost per rollout; the grid stage's
   device time per launch at n=12 at those shapes, at a train step's S=8,
   A=8 and at S=8192, A=8 (77 MB written, past the L2), against its bound
   (the bytes, ``grid_bound_ms``);
   (c) rollout parting (``"phase": "rollout_parting"``): the bench's
   rollout cell at seeds 0-4 (131,072 scenes of 8 agents, its params and
   walks), read on its 1,024 checked scenes against ``bench_torch``'s
   plain D-LSTM along the fused rollout's trajectory (4e-5 m) and free;
   each scene whose free rollouts part by more than 4e-5 m with the first
   step whose grid differs, the pair, the axis, both offsets and their
   distance to the cell edge, and the fused step's one-step error on the
   plain rollout's own inputs there; it raises on an along reading over
   4e-5 m, a departure not explained by a cell flip from agreeing inputs,
   or a one-step error over phase 3's tolerance;
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
   batch, and so does each per-step kernel of the fused train route (6c;
   ``fused_train_in_backward`` and the loss's two kernels once), the fused
   step 2 x 19 times per val batch (validation records no
   autograd, so its teacher-forced pass and its free rollout both run it),
   and the loss kernel twice per val batch (every ``pred``-criterion loss of
   ``trainers/lstm.Trainer`` in f32 on the card is the loss kernel's,
   whichever route made the rollout, in every phase below too).
   Every logged loss is finite, epoch 2's train loss is below epoch 1's, and
   the written pickle serves the test part through ``lstm_cli``.  One train
   step's loss and gradients with the grid kernel against the plain grid
   (equal: the grid is bit-exact and the rest is the same torch code), an
   f32 step on the
   card against an f64 step on the CPU (loss 1e-5 relative, gradients 1e-4
   relative + 1e-5 of each leaf's largest), device augmentation keeping
   pairwise distances, and the train step's time at batch 8 and 256 (CUDA
   graph replays, ``trainers/graphs.py``) and the grid kernel's against the
   plain grid's (CUDA events, warm);
6b. graphs: the flagship's ``Trainer.train``, 3 epochs over two bucket
   shapes (A=8 and A=4) with the learning rate dropping every epoch, its
   step replayed as CUDA graphs against eager steps with the same capturable
   Adam, from the same params, batches and draws: after each epoch every
   leaf and Adam moment within twice what two eager runs differ by (or
   1e-6) relative to its largest, a control (one step left out) above that
   limit, the host-side Adam beside it; every run's grid launches read exactly
   (19 a step, 38 under remat); the grid stage's events in a traced window
   of two graph epochs (at least half their launches, no more than all);
   ms per step on graphs against eager, beside the card.
   In every phase a CUDA graph replay's launches are read from the graph:
   once captured, each graph's kernel nodes are counted in its DOT dump
   (``install_graph_counting``), each replay counts them, and the counts
   ``trainers/graphs.StepGraphs`` adds to the wrappers' counters a replay
   must equal them;
6c. fused train: the flagship's teacher-forced rollout under autograd as
   ``ops/cuda/fused_train.FusedTrainRollout`` and its loss as
   ``FusedPredictionLoss`` (the route of every flagship train step above):
   (a) their six kernels against their plain versions at 64 and 8,192 rows
   (1e-6 of each output's largest magnitude, masks equal), each one's time
   a call and a launch at 64 rows, its bound (the bytes) and its plain
   version's time; (b) the route's loss and every leaf's gradient against
   the grid route's on one batch (defaults, a collision term,
   ``start_length`` 3), 1e-5 of each leaf's largest (the loss: of its own
   magnitude or the batch size), each run's launches read exactly; (c) one
   ``train_step``'s launches, eager and replayed: 19 grid, 19 of each
   per-step kernel, one ``fused_train_in_backward`` and one of each loss
   kernel; (d) ``train_step`` at batch 8 on graphs, this route against the
   grid route in turns: ms a step, device events and device time a step.
   In (b) and (d) the grid route's step is the parent's: the grid route
   and ``losses.prediction_loss`` (``plain_prediction_loss``);
7. pools (the main path's other interaction modules), at the trainer's
   default widths (hidden 128, embedding 64, pool 256, n 12, cell 0.6 m,
   latent 16, neigh 4, mp_iters 5):
   (a) ``LSTM.forward(n_predict=12)`` at S=64, A=8 and S=256, A=32 for the
       ten pooled types, a two-layer S-LSTM, an ``lstm_layer`` D-LSTM, a
       goal D-LSTM and a D-LSTM at n=8, hidden 64, each read on its first
       ``POOL_CPU_SCENES`` scenes against the CPU, the same params and
       inputs (nearest neighbours drawn ``NEIGHBOUR_GAP`` apart): positions
       within 4e-5 m along the card's own rollout (``along_positions``: the
       model's own step on the CPU fed that rollout's inputs at every step,
       its carry, goals and slot mask its own; the worst scene, step and
       agent printed) and within 1e-3 m of a free CPU run; an along reading
       over 4e-5 m raises once every model has been read, naming each;
       each rollout timed, and the launch counters
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
       memory high-water mark of a social step;
8. generative (the SGAN and the VAE), at the flagship's widths, noise 16,
   latent 128 with ``desire``, k=3 modes folded into one decoder batch:
   (a) rollouts at S=64, A=8 and S=256, A=32: 19 fused-step launches per
       rollout; on the first ``POOL_CPU_SCENES`` scenes of each mode,
       positions within 4e-5 m along the card's own rollout (the CPU's
       decoder starts from the same noise or latent normals and decodes the
       k modes as one mode-major batch, each mode along its own rows of the
       card's rollout) and within 1e-3 m of a free CPU run, raising as
       phase 7(a) does; times (CUDA events) as a range over 3 windows;
   (b) an SGAN generator and discriminator step and a VAE step at batch 8
       against f64 on the CPU at phase 7c's tolerances, label and draws
       pinned, with their launches (19 grid-stage; 19 fused and 40
       grid-stage; 30 grid-stage) and times;
   (c) ``trainers.sgan.main`` and ``trainers.vae.main`` (--k 3), one epoch
       each at batch 8 on a split of phase 6's sizes, their launches held
       to the batches, and each pickle served through ``sgan_cli`` /
       ``vae_cli --modes 3``.  Every time is printed beside the card;
9. classical (constant velocity, the Kalman filter, social force, ORCA; no
   kernel of the port; f64):
   (a) the folded KF, SF and CV at 1,024 scenes of 2-8 agents and 64 of
       2-32 on the card against the port's CPU run of the same inputs: KF
       parameters and smoothed last states within 1e-8 relative, F F^T = Q,
       samples given the CPU's factors and normals within 1e-8 m; SF
       within 1e-6 m; CV bit-exact;
   (b) ``evaluator.classical_cli.main([... "--cv", "--kf", "--sf", "--orca",
       "--device", "cuda"])`` on a 300-scene split (one scene of 140
       agents): six prediction directories, every scene scored, the written
       CV primaries the numpy CV of the observations, no kernel launched;
   (c) folded ``predict_dataset`` scenes/s, the per-scene ``__call__`` on 32
       scenes, ORCA's host ms per scene and each predictor's wall time in
       (b), beside the card; the profile adds the device events of one
       folded KF fit and one SF bucket;
10. training options, at the flagship's widths (every line beside the card):
   (a) the grid stage's bf16 instantiation against the plain bf16 grid,
       bit-exact, at phase 2's buckets and on ``grid_edge_cases``; its
       device time per launch against its bf16 bound (``grid_bound_ms``
       with 2-byte values) at phase 4b's grid shapes, the f32
       instantiation's beside it in the same call;
   (b) ``trainers.lstm.main([... "--bf16", "--device", "cuda"])``, 2 epochs
       at batch 8 on a split of phase 6's sizes: 19 bf16 grid-stage
       launches per train batch and 2 x 19 per val batch, no fused launch;
       finite losses, f32 masters and Adam state; the pickle served in f32
       through ``lstm_cli`` on the fused route; one bf16 step on the card
       against the same step on the CPU (loss 1e-2 relative, gradient
       cosine above 0.99);
   (d) ``--obs_dropout``, one epoch: 19 - start_length grid-stage launches
       per batch, from the start lengths the trainer logs;
   (e) ``trainers.ensemble.main([... "--seeds", "42", "10", "20", "30",
       "40", "--device", "cuda"])``, 2 epochs at batch 8: five pickles and
       sidecars, finite member losses, 19 grid-stage launches per ensemble
       step (train and val); one member resumed by the sequential trainer;
       an ensemble step's member gradients against five sequential steps on
       the card (phase 6's tolerances); the ensemble step at E=5 and one
       sequential step timed (CUDA events) with their device busy shares;
   (c) ``--remat``: a flagship and an attentionmlp step at S=256, A=32 with
       and without it: loss and gradients within 1e-6 of each leaf's
       largest, the peak memory, the time and the grid-stage launches (19
       more with remat) both ways.

11. parallel (every line beside the card), two ranks on the one card, which
    share it through gloo (NCCL refuses two ranks on one card), started by
    ``python -m torch.distributed.run --standalone --nproc_per_node 2
    chip_smoke.py --rank-run DIR``, each rank driving the port's entry
    points, its launch counters zeroed before and read after each run:
   (a) ``trainers.lstm.main([... "--dp", "2", "--tp", "1"])`` and then
       ``--dp 1 --tp 2``, one epoch at batch 8 on phase 6's sizes: every
       batch loss within 1e-5 relative of a one-process run of the same
       seed, 19 grid-stage launches per train step (and 2 x 19 fused per
       val batch) in each rank; one ``make_sharded_train_step`` step's
       all-reduced gradients within 1e-5 of each leaf's largest of the
       one-process step's; each rank's ms per step against one process's,
       labelled "two ranks on one card; not a scaling number";
   (b) ``trainers.ensemble.main([... "--dp", "2"])``, two members, one
       epoch: member losses within 1e-5 relative of the one-process
       ensemble, 19 grid launches per ensemble step in each rank;
   (c) ``make_sharded_rollout`` at S=64, A=8 over the two ranks: positions
       within 1e-6 m of the one-process rollout, 19 fused launches in each
       rank; ``evaluator.lstm_cli`` over the two ranks on a split of three
       test datasets (shares of 2 and 1) serving phase 6's pickle: the
       files one process writes, line for line, scored once, by rank 0;
   (d) ``tools.collision_gate --device cuda`` on phase 6's pickle over a
       head-on ``collision_test`` scene: the Pass/Fail of ``--device cpu``,
       19 fused launches;
   (e) ``tools.profile_train --device cuda --steps 2``: its Chrome trace
       holds ``directional_grid_kernel`` events (19 grid launches a step).

Then one JSON line of the kernels and, last, ``{"ok": true, "device": ...}``.
Any failed phase raises, so the script exits non-zero and prints no result;
so does a machine without CUDA or a directory without the package.

    python3 chip_smoke.py --profile OUT_DIR

adds a profile phase before the last two lines: kernel and plain times at
larger rollouts, and ``torch.profiler`` tables of warm rollouts, of a warm
``predict_dataset`` pass, of warm train steps, of phase 7's pool rollouts
and train steps, of phase 8's folded rollouts and train steps, and of
phase 9's folded KF fit and SF bucket, written into OUT_DIR.
"""

import argparse
import contextlib
import json
import logging
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter, namedtuple
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from roofline import FLOP_PER_ROW, PEAK_BYTES, card_line, grid_bound_ms, step_bound

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BUCKETS = (1, 4, 8, 16, 32, 64, 128, 150)
ROWS_PER_BUCKET = 16384
BATCH_SCENES = 64  # lstm_cli's --batch_scenes default
ROLLOUTS = ((BATCH_SCENES, 8), (1024, 8), (256, 32))  # (scenes, agents); first: the CLI's
PROFILE_ROLLOUTS = ((64, 8), (1024, 8), (8192, 8), (65536, 8), (256, 32), (2048, 32))
# (scenes, agents) of phase 4b; the last, 1,048,576 rows: the bench's rollout cell
DEVICE_SHAPES = ((BATCH_SCENES, 8), (1024, 8), (256, 32), (131072, 8))
STEP_EDGES = ((3, 7), (1, 1), (65, 8))  # phase 3: below one tile, one row, a partial last tile
SERVE_PASSES = 5
CELL_SIDE, N = 0.6, 12
STEP_ATOL, STEP_RTOL = 2e-5, 1e-4
# metres: the free readings of phases 4, 7(a) and 8(a), a card's rollout
# against a CPU run of its own
POSITION_ATOL = 1e-3
# metres: the rollouts of phases 4, 7(a) and 8(a) along their own trajectory
# (``along_positions``), and phase 4c's departures (``bench_torch.POSITION_ATOL``)
ALONG_ATOL = 4e-5
PARTING_SEEDS = range(5)  # phase 4c: the bench's rollout cell at these seeds
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
# phase 8: the SGAN and the VAE at the flagship's widths, k modes folded
GEN_MODES, GEN_NOISE_DIM, GEN_LATENT = 3, 16, 128
GEN_ROLLOUTS = ((BATCH_SCENES, 8), (256, 32))
GEN_TIMED_REPEATS = 3  # timed windows per rollout, each of GEN_TIMED_REPS rollouts
GEN_TIMED_REPS = 5
GEN_LABEL = 0.9  # the smoothed real label of the checked GAN steps
# phase 9: the classical predictors, f64; (scenes, fewest, most agents) of
# the folded buckets, the scenes of the per-scene contrast, the tolerances
CLASSICAL_BUCKETS = ((1024, 2, 8), (64, 2, 32))
CLASSICAL_PER_SCENE = 32
CLASSICAL_FOLD_REPS = 3
SF_ATOL_M, KF_RTOL, KF_SAMPLE_ATOL_M = 1e-6, 1e-8, 1e-8
# phase 10: the rest of training, at the flagship's widths
ENSEMBLE_SEEDS = (42, 10, 20, 30, 40)  # the published protocol's five seeds
REMAT_SHAPE = (256, 32)  # (scenes, agents) of the remat steps: a crowded bucket
REMAT_REPS = 5
# a bf16 step on the card against the same bf16 step on the CPU: losses
# within 1e-2 relative and gradients' cosine above 0.99 (cuBLAS and the
# CPU's bf16 products accumulate differently), the CPU tests' tolerance of
# the port's bf16 step against JAX's
BF16_LOSS_RTOL, BF16_GRAD_COSINE = 1e-2, 0.99
# a step with remat against one without: the same kernels recomputed; held
# to 1e-6 of each leaf's largest gradient
REMAT_ATOL_SHARE = 1e-6
CLASSICAL_MODELS = ("kf", "sf", "sf_opt", "orca", "orca_opt", "cv")  # classical_cli's order
# phase 11: two ranks on the one card (gloo), at the flagship's widths
PARALLEL_SPLIT = (320, 96, 64)  # phase 6's train, val, test scenes
PARALLEL_SERVE = (("a", 40), ("b", 24), ("c", 16))  # three test datasets, unequal shares
PARALLEL_SEEDS = ("42", "10")  # the ensemble's members
PARALLEL_ROLLOUT = (64, 8)  # (scenes, agents) of the sharded rollout
PARALLEL_LOSS_RTOL = 1e-5  # each batch loss of a sharded run against one process
PARALLEL_GRAD_ATOL_SHARE = 1e-5  # a sharded step's gradients, of each leaf's largest
PARALLEL_POSITION_ATOL = 1e-6  # metres, the sharded rollout against one process
PARALLEL_TIMEOUT_S = 420  # the two ranks' whole run; then they are killed
PARALLEL_TIMED_REPS = 10
NOT_SCALING = "two ranks on one card; not a scaling number"
GRID_KERNEL = "directional_grid_kernel"  # the grid stage's name in a profiler trace
# phase 6b: the train step as CUDA graphs against eager steps, at the
# flagship's widths; (scenes, agents) of the two buckets (a scene of 3
# agents pads to the trainer's bucket of 4), epochs at StepLR step 1
GRAPH_SCENES = ((48, 8), (48, 3))
GRAPH_EPOCHS = 3
GRAPH_SEED = 13
GRAPH_RTOL_FLOOR = 1e-6  # the limit's floor, where two eager runs agree closer
GRAPH_LEFT_OUT = 2  # the control's step left out, counted from 1
# phase 6c: the fused train route (``ops/cuda/fused_train.py``); its kernels
# against their plain versions at (scenes, agents): the bench's train step
# (64 rows) and 8,192 rows; within TRAIN_KERNEL_RTOL of each output's
# largest magnitude (f32 rounding: expf and tanhf against torch's, the
# order of Hidden2Normal's sums and of the K = 2 embedding)
TRAIN_KERNELS = ("fused_train_in", "fused_train_cell", "fused_train_cell_backward",
                 "fused_train_in_backward", "fused_train_loss", "fused_train_loss_backward")
TRAIN_KERNEL_SHAPES = ((TRAIN_BATCH, 8), (1024, 8))
TRAIN_KERNEL_RTOL = 1e-6
TRAIN_KERNEL_REPS = 50  # launches per timed or profiled window
# the route's loss and each leaf's gradient against the grid route's on one
# batch, of the leaf's largest magnitude: two f32 orders of the same sums
FUSED_TRAIN_RTOL = 1e-5
FUSED_TRAIN_TIMED_STEPS = 100  # graph replays per timed window of a train step


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


def flagship_argv(path, *extra):
    """``trainers.lstm`` / ``trainers.ensemble`` arguments of the flagship
    D-LSTM at batch 8 on the card."""
    return ["--path", path, "--type", "directional", "--n", str(N), "--cell_side",
            str(CELL_SIDE), "--pool_dim", "256", "--hidden-dim", "128",
            "--coordinate-embedding-dim", "64", "--batch_size", str(TRAIN_BATCH),
            "--device", DEVICE, *extra]


def close_log():
    """Close a trainer's log file, which it opened as the root logger's."""
    for handler in logging.getLogger().handlers[:]:
        handler.close()
        logging.getLogger().removeHandler(handler)


def log_records(path) -> dict:
    """A trainer's JSON log, records by type."""
    with open(path) as f:
        records = [json.loads(line) for line in f]
    out = {}
    for r in records:
        out.setdefault(r.get("type"), []).append(r)
    return out


def batches_per_epoch(resident) -> int:
    """The batches of one epoch over a ``ResidentDataset`` at batch 8."""
    plan = resident.epoch_plan(TRAIN_BATCH, np.random.default_rng(0), shuffle=False)
    return sum(idx.shape[0] for idx, _ in plan.values())


def train_phase(dev, rng) -> dict:
    """Phase 6: train the flagship D-LSTM through ``trainers.lstm.main`` on
    ``dev`` and check it (see the module's docstring).  Returns the launch
    counts of that run, the timings and the timed trainer."""
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli
    from trajnetplusplusbaselines_torch.models import lstm as lstm_module
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step
    from trajnetplusplusbaselines_torch.trainers import lstm as train_cli
    from trajnetplusplusbaselines_torch.trainers.common import bucket_batches, step_lr
    from trajnetplusplusbaselines_torch.utils.checkpoint import load_predictor
    from trajnetplusplusbaselines_torch.utils.convert import params_from_jax, params_to_numpy

    cwd = os.getcwd()
    root, name = "DATA_BLOCK/synth_train", "lstm_directional_smoke"
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            write_split(root, rng, n_scenes=320, big=None, observed_only=(), full=("train",))
            write_split(root, rng, n_scenes=96, big=None, observed_only=(), full=("val",))
            test_observed = write_split(root, rng, n_scenes=64, big=None)

            counters = Launches()
            counters.zero()
            t0 = time.perf_counter()
            trainer = train_cli.main(argv=flagship_argv(
                "synth_train", "--epochs", str(TRAIN_EPOCHS), "--save_every", "1", "--seed", "0",
                "-o", "smoke"))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_launches = counters.current()
            replayed = dict(REPLAYED["ran"])
            close_log()

            # batches per epoch from the datasets the trainer made resident on
            # the card, train first (epoch 0 trains before it validates)
            (train_ds, resident), (val_ds, val_resident) = trainer._resident.values()
            train_batches, val_batches = map(batches_per_epoch, (resident, val_resident))
            n_train, n_val = len(train_ds), len(val_ds)
            want = {"fused_dlstm_step": 2 * 19 * val_batches * TRAIN_EPOCHS,
                    "directional_grid": 19 * train_batches * TRAIN_EPOCHS,
                    "directional_grid_bf16": 0,
                    **fused_train_launches(19 * train_batches * TRAIN_EPOCHS,
                                           train_batches * TRAIN_EPOCHS,
                                           val_losses=2 * val_batches * TRAIN_EPOCHS)}
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
            trained = load_predictor(out)
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
        launches=train_launches, replayed_launches=replayed, epoch_losses=epoch_losses,
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
            "timed": timed, "predictor": trained}


def graph_scenes(rng):
    """Phase 6b's ``SceneDataset``: random walks of 21 frames in two agent
    buckets (``GRAPH_SCENES``), every agent present, no goals."""
    from trajnetplusplusbaselines_torch.trainers.common import SceneDataset

    data = SceneDataset([], 9, normalize_scene=False)
    for s, a in GRAPH_SCENES:
        xy = (rng.normal(scale=0.15, size=(21, s, a, 2)).cumsum(axis=0)
              + rng.uniform(-3, 3, size=(1, s, a, 2)))
        data.xys += [xy[:, i] for i in range(s)]
        data.goals += [np.zeros((a, 2)) for _ in range(s)]
    return data


def largest_relative(got, want) -> float:
    """The largest relative difference over pairs of tensors, each taken
    against its ``want``'s largest magnitude."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def graph_phase(dev, rng, card) -> dict:
    """Phase 6b: the flagship's ``Trainer.train`` with its step replayed as
    CUDA graphs (``trainers/graphs.py``) against eager steps with the same
    capturable Adam, from the same params, batches and augmentation draws,
    ``GRAPH_EPOCHS`` epochs over two bucket shapes with the learning rate
    dropping every epoch.  After each epoch every leaf and Adam moment of
    the graph run is held, relative to its largest magnitude, within twice
    what two eager runs differ by, or ``GRAPH_RTOL_FLOOR``; a control (the
    graph run with step ``GRAPH_LEFT_OUT`` left out) must sit above that
    limit, and the host-side Adam (``make_optimizer``: a float rate, the step
    count and bias correction on the host) shows what
    capturable Adam alone changes.  Every run's grid launches are read
    exactly (19 a step; 38 a step under remat, one epoch), the replays' from
    their graphs' kernel nodes (``Launches``); the graph run's is this
    phase's main-path read.  A traced window of two more graph epochs holds
    the grid stage's events.  Returns its launches and figures."""
    from torch.utils._pytree import tree_map

    from trajnetplusplusbaselines_torch.trainers import graphs
    from trajnetplusplusbaselines_torch.trainers.common import make_optimizer, step_lr
    from trajnetplusplusbaselines_torch.trainers.lstm import Trainer

    data = graph_scenes(rng)
    model = flagship_model()
    init = model.init_params(torch.Generator().manual_seed(GRAPH_SEED), device=dev)
    counters = Launches()

    def run(kind, epochs=GRAPH_EPOCHS, remat=False):
        """(per epoch: leaves, moments, losses, ms a step; launches; graphs)."""
        run_model = flagship_model()
        run_model.remat = remat
        trainer = Trainer(run_model, tree_map(lambda x: x.clone(), init), step_lr(1e-3, 1),
                          seed=GRAPH_SEED)
        if not isinstance(trainer.graphs, graphs.StepGraphs):
            raise AssertionError("a trainer on the card in one process took no graphs")
        if kind not in ("graphs", "left_out"):
            trainer.graphs = None
        if kind == "host_adam":
            trainer.optimizer = make_optimizer(trainer.leaves)
        calls = [0]
        if kind == "left_out":
            real = trainer.train_step

            def step(*batch, **kw):
                calls[0] += 1
                return torch.zeros((), device=dev) if calls[0] == GRAPH_LEFT_OUT else real(
                    *batch, **kw)

            trainer.train_step = step
        counters.zero()
        epochs_out = []
        for epoch in range(epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(data, epoch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(trainer.epoch_losses)
            state = trainer.optimizer.state
            moments = [state[leaf][k].clone() for leaf in trainer.leaves
                       for k in ("exp_avg", "exp_avg_sq")]
            epochs_out.append({"leaves": [x.detach().clone() for x in trainer.leaves],
                               "moments": moments, "losses": torch.from_numpy(
                                   trainer.epoch_losses.copy()), "ms": ms})
        steps = epochs * len(trainer.epoch_losses) - (kind == "left_out")
        want = ({"directional_grid": 38 * steps, **loss_launches(steps)} if remat else
                {"directional_grid": 19 * steps, **fused_train_launches(19 * steps, steps)})
        launches = counters.read(want, add=kind == "graphs")
        captured = 0 if trainer.graphs is None else len(trainer.graphs.graphs)
        return epochs_out, launches, captured, steps, trainer

    print("(phase 6b: eager trainers with capturable Adam warn once that it runs uncaptured)",
          file=sys.stderr)
    t_phase = time.perf_counter()
    runs = {kind: run(kind) for kind in ("eager", "graphs", "eager_again", "host_adam", "left_out")}
    remat_epochs, remat_launches, remat_graphs, _, _ = run("graphs", epochs=1, remat=True)
    if runs["graphs"][2] != len(GRAPH_SCENES) or remat_graphs != len(GRAPH_SCENES):
        raise AssertionError(f"captured {runs['graphs'][2]} and {remat_graphs} graphs, "
                             f"one a bucket of {GRAPH_SCENES} wanted")

    def distance(kind, epoch):
        got, want = runs[kind][0][epoch], runs["eager"][0][epoch]
        return {"leaves": largest_relative(got["leaves"], want["leaves"]),
                "moments": largest_relative(got["moments"], want["moments"]),
                "losses": largest_relative([got["losses"]], [want["losses"]])}

    rows = []
    for epoch in range(GRAPH_EPOCHS):
        row = {kind: distance(kind, epoch)
               for kind in ("graphs", "eager_again", "host_adam", "left_out")}
        limit = max(2 * max(row["eager_again"].values()), GRAPH_RTOL_FLOOR)
        worst = max(row["graphs"]["leaves"], row["graphs"]["moments"])
        control = max(row["left_out"]["leaves"], row["left_out"]["moments"])
        if not worst <= limit:
            raise AssertionError(f"epoch {epoch}: the graph run differs from the eager run by "
                                 f"{row['graphs']}, beyond {limit}")
        if not control > limit:
            raise AssertionError(f"epoch {epoch}: the control (step {GRAPH_LEFT_OUT} left "
                                 f"out) differs by only {row['left_out']}, within {limit}")
        rows.append({"epoch": epoch, "limit": limit, **row})
        say("graphs_epoch", epoch=epoch, limit=limit, graph_vs_eager=row["graphs"],
            eager_vs_eager=row["eager_again"], control_step_left_out=row["left_out"],
            host_adam_vs_capturable=row["host_adam"])
    # the replays run the grid stage on the card: its events in a traced
    # window of two more graph epochs, at least half of their launches (the
    # profiler can drop events, ``held_window``) and no more than all
    trainer = runs["graphs"][4]
    epoch_launches = 19 * len(trainer.epoch_losses)
    traced = held_window(lambda: trainer.train(data, GRAPH_EPOCHS), 2, GRID_KERNEL,
                         epoch_launches)["kernel_launches"]
    if traced > 2 * epoch_launches:
        raise AssertionError(f"two graph epochs traced {traced} grid launches, "
                             f"{2 * epoch_launches} launched")
    ms = {kind: [e["ms"] for e in runs[kind][0]] for kind in ("eager", "graphs", "host_adam")}
    figures = {"scenes": GRAPH_SCENES, "epochs": GRAPH_EPOCHS, "steps": runs["graphs"][3],
               "graphs": runs["graphs"][2], "epochs_checked": rows,
               "launches": {kind: r[1] for kind, r in runs.items()},
               "remat_launches": remat_launches,
               "traced_grid_launches": {"traced": traced, "launched": 2 * epoch_launches},
               "ms_per_step": ms,
               "last_epoch_speedup": ms["eager"][-1] / ms["graphs"][-1],
               "seconds": time.perf_counter() - t_phase}
    say("graphs", **{k: v for k, v in figures.items() if k != "epochs_checked"}, card=card)
    print("Graphs  {} steps of {} scenes a batch: {:.3f} ms/step on graphs against {:.3f} eager "
          "(host-side Adam {:.3f}), last epoch; graph run within {:.3g} of eager, control {:.3g} "
          "({})".format(runs["graphs"][3], TRAIN_BATCH, ms["graphs"][-1], ms["eager"][-1],
                        ms["host_adam"][-1], max(rows[-1]["graphs"]["leaves"],
                                             rows[-1]["graphs"]["moments"]),
                        max(rows[-1]["left_out"]["leaves"], rows[-1]["left_out"]["moments"]),
                        card), flush=True)
    return {"launches": runs["graphs"][1], "figures": figures}


def train_kernel_case(name, rng, s, a, dev, params) -> tuple:
    """One fused train kernel's arguments at [S, A] and the flagship's
    widths (``fused_train_in_backward``: a rollout's 19 steps of rows), drawn
    from ``rng``, every buffer it writes filled at random too, so that the
    kernel and its plain version start from the same values; the indices of
    the arguments it writes; and the bytes it must move (each input read
    once, each output written once)."""
    hidden = params["hidden2normal"]["linear"]["w"].shape[0]
    lin = params["input_embedding"]["linear"]["w"].shape[1]
    pool = params["pool"]["embedding"][0]["w"].shape[1]
    x_width = lin + 2 + pool
    ld, r = x_width + hidden + 1, s * a

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    def b(*shape):
        return torch.from_numpy(rng.random(shape) > 0.2).to(dev)

    h2n = params["hidden2normal"]["linear"]
    if name == "fused_train_in":
        emb = params["input_embedding"]["linear"]
        args = (f(s, a, 2), f(s, a, 2), b(s, a), b(s, a), f(r, pool), emb["w"], emb["b"],
                params["pool"]["embedding"][0]["b"], f(r, ld), f(r, 3), b(r))
        nbytes = r * (2 * 8 + 2 + 4 * pool) + 4 * (3 * lin + pool) + r * (4 * (x_width + 1) + 13)
        return args, (8, 9, 10), nbytes
    if name == "fused_train_cell":
        args = (2 * f(r, 4 * hidden), f(r, ld), f(r, hidden), b(r), f(r, 2), h2n["w"], h2n["b"],
                f(r, ld), f(r, hidden), f(r, 4 * hidden), f(r, hidden), f(r, 3), f(r, 5),
                f(r, 2), (f(s, a, 2), b(s, a)))
        nbytes = (r * (4 * 6 * hidden + 9) + 4 * 6 * hidden
                  + r * (4 * (7 * hidden + 1) + 40) + 9 * s)
        return args, (7, 8, 9, 10, 11, 12, 13, 14), nbytes
    if name == "fused_train_cell_backward":
        args = (f(r, 5), f(r, 2), b(r), torch.sigmoid(f(r, 3)), torch.sigmoid(f(r, 4 * hidden)),
                torch.tanh(f(r, hidden)), f(r, hidden), h2n["w"], f(r, hidden), f(r, hidden),
                f(r, hidden), f(r, 4 * hidden), f(r, 5))
        nbytes = r * (41 + 4 * 9 * hidden) + 4 * 5 * hidden + r * (4 * 6 * hidden + 20)
        return args, (9, 10, 11, 12), nbytes
    if name == "fused_train_in_backward":
        n = 19 * r
        return (f(n, x_width), f(n, ld)), (0,), 3 * 4 * n * x_width
    # the loss: the trainer's 12 predicted steps of the primaries, sigmas
    # and rho in the head's ranges, one scene in eight padded
    p, rel = 12, f(19, s, a, 5)
    rel[..., 2:4] = 0.01 + 0.2 * torch.sigmoid(rel[..., 2:4])
    rel[..., 4] = 0.7 * torch.sigmoid(rel[..., 4])
    scenes = torch.arange(s, device=dev) % 8 != 7
    if name == "fused_train_loss":
        args = (rel, 0.1 * f(p, s, 2), scenes, f(), f(), f(p, s, 5))
        return args, (3, 4, 5), 4 * (p * s * 7 + 2 + p * s * 5) + s
    args = (8.0 + f(), f(p, s, 5), 60.0 + f(), f(19, s, a, 5))
    return args, (3,), 4 * (2 + p * s * 5 + 19 * r * 5)


def run_train_kernel(fn, args, writes) -> list:
    """``fn`` on copies of ``args``; the written tensors, flat."""
    copies = [tuple(x.clone() for x in a) if isinstance(a, tuple) else a.clone()
              for a in args]
    fn(*copies)
    return [x for i in writes
            for x in (copies[i] if isinstance(copies[i], tuple) else (copies[i],))]


def fused_train_phase(dev, rng, card) -> dict:
    """Phase 6c: the fused train route (``ops/cuda/fused_train.py``).  (a)
    Each of its six kernels against its plain version at
    ``TRAIN_KERNEL_SHAPES``, within ``TRAIN_KERNEL_RTOL`` of each output's
    largest magnitude (masks equal), with its time a call and a launch at
    the train step's 64 rows beside its bound (its bytes at the memory's
    rate), the plain version's time and, for the relu masks, the one
    PyTorch call of the same function (``threshold_backward``).  (b) The
    route's loss and every leaf's gradient against the grid route's (and
    the plain loss's) on one batch (the trainer's defaults, a collision
    term, ``start_length`` 3), each leaf within ``FUSED_TRAIN_RTOL`` of its
    largest magnitude, the loss within it of its own magnitude or of the
    batch size, whichever is larger (the NLL sums terms of both signs, one
    nat or so a scene, so the sum can sit near zero), each run's launches
    read exactly.  (c) The launches of one ``train_step``, eager and
    replayed from its CUDA graph: 19 grid, 19 of each per-step kernel, one
    ``fused_train_in_backward`` and one of each loss kernel.  (d)
    ``train_step`` at batch 8 on CUDA graphs, the fused train route against
    the grid route in turns: ms a step (CUDA events over back to back
    replays) and the device events and device time a step
    (``torch.profiler``).  Returns its launches and figures."""
    from torch.utils._pytree import tree_map

    from trajnetplusplusbaselines_torch.ops.cuda import fused_train
    from trajnetplusplusbaselines_torch.trainers import graphs
    from trajnetplusplusbaselines_torch.trainers.common import step_lr
    from trajnetplusplusbaselines_torch.trainers.lstm import Trainer

    t_phase = time.perf_counter()
    model = flagship_model()
    params = model.init_params(torch.Generator().manual_seed(GRAPH_SEED), device=dev)
    counters = Launches()

    # (a) each kernel against its plain version
    kernels = {}
    for name in TRAIN_KERNELS:
        wrapper, plain = getattr(fused_train, name), getattr(fused_train, name + "_plain")
        row = {"max_abs_err": 0.0, "max_rel_err": 0.0}
        for s, a in TRAIN_KERNEL_SHAPES:
            args, writes, nbytes = train_kernel_case(name, rng, s, a, dev, params)
            got, want = run_train_kernel(wrapper, args, writes), run_train_kernel(plain, args,
                                                                                  writes)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.dtype == torch.bool:
                    if not torch.equal(g, w):
                        raise AssertionError(f"{name} at S={s} A={a}: a mask differs")
                    continue
                err = float((g - w).abs().max())
                rel = err / max(float(w.abs().max()), 1e-30)
                if not rel <= TRAIN_KERNEL_RTOL:
                    raise AssertionError(f"{name} at S={s} A={a}: an output differs by {rel} of "
                                         f"its largest, beyond {TRAIN_KERNEL_RTOL}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["max_rel_err"] = max(row["max_rel_err"], rel)
            if (s, a) != TRAIN_KERNEL_SHAPES[0]:
                continue
            # times at the train step's rows, on one set of buffers
            copies = [tuple(x.clone() for x in v) if isinstance(v, tuple) else v.clone()
                      for v in args]
            row.update(
                rows=s * a, bytes=nbytes, bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
                ms=time_ms(lambda: wrapper(*copies), reps=TRAIN_KERNEL_REPS),
                plain_ms=time_ms(lambda: plain(*copies), reps=TRAIN_KERNEL_REPS),
                device_ms=kernel_ms_per_launch(lambda: wrapper(*copies), TRAIN_KERNEL_REPS,
                                               f"{name}_kernel"),
                library_ms=None)
            if name == "fused_train_in_backward":
                dx, xh = copies
                x = xh[:, :dx.shape[1]]
                row["library_ms"] = time_ms(
                    lambda: torch.ops.aten.threshold_backward(dx, x, 0.0),
                    reps=TRAIN_KERNEL_REPS)
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
        kernels[name] = row
        say("fused_train_kernel", kernel=name, shapes=TRAIN_KERNEL_SHAPES, card=card, **row)

    # (b) the route against the grid route on one batch
    batch = train_inputs(rng, TRAIN_BATCH, 8, dev)

    def grid_route(run_model):
        """The parent's train step: the grid route and the plain loss."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(run_model, "takes_fused_train",
                                              lambda *args, **kw: False))
        stack.enter_context(mock.patch.object(fused_train, "prediction_loss",
                                              plain_prediction_loss))
        return stack

    route_errs = {}
    # the collision term at 3 m, so that most pairs collide and pred's
    # gradient reaches the rollout
    for label, options, call in (("defaults", {}, {}),
                                 ("collision", {"col_wt": 2.0, "col_distance": 3.0}, {}),
                                 ("start_length_3", {}, {"start_length": 3})):
        trainer = Trainer(model, tree_map(lambda x: x.clone(), params), step_lr(1e-3, 10),
                          **options)
        steps = 19 - call.get("start_length", 0)
        counters.zero()
        fused = trainer.loss_and_grads(*batch, **call)
        counters.read({"directional_grid": steps, **fused_train_launches(steps, 1)}, add=False)
        with grid_route(model):
            counters.zero()
            plain = trainer.loss_and_grads(*batch, **call)
            counters.read({"directional_grid": steps}, add=False)
        loss_scale = max(abs(float(plain[0])), TRAIN_BATCH)
        route_errs[label] = {
            "loss": abs(float(fused[0]) - float(plain[0])) / loss_scale,
            "losses": [float(fused[0]), float(plain[0])],
            "grads": largest_relative(fused[1], plain[1])}
        if not max(route_errs[label]["loss"], route_errs[label]["grads"]) <= FUSED_TRAIN_RTOL:
            raise AssertionError(f"{label}: the fused train route differs from the grid route "
                                 f"by {route_errs[label]}, beyond {FUSED_TRAIN_RTOL}")
    say("fused_train_route", against="grid route", rtol=FUSED_TRAIN_RTOL, card=card,
        **route_errs)

    # (c) a train step's launches, eager and replayed
    want_step = {"directional_grid": 19, **fused_train_launches(19, 1)}
    eager = Trainer(model, tree_map(lambda x: x.clone(), params), step_lr(1e-3, 10))
    eager.graphs = None
    counters.zero()
    eager.train_step(*batch)
    step_launches = {"eager": counters.read(want_step, add=False)}

    def graph_trainer(run_model):
        trainer = Trainer(run_model, tree_map(lambda x: x.clone(), params), step_lr(1e-3, 10))
        for _ in range(graphs.WARM_CALLS + 2):  # eager, then captured and replayed
            trainer.train_step(*batch)
        if len(trainer.graphs.graphs) != 1:
            raise AssertionError("the train step captured no graph")
        return trainer

    fast = graph_trainer(model)
    counters.zero()
    fast.train_step(*batch)
    step_launches["replay"] = counters.read(want_step)

    # (d) train steps on graphs, the fused train route against the grid route
    grid_model = flagship_model()
    with grid_route(grid_model):  # captured there, then replayed
        slow = graph_trainer(grid_model)
    timed = {"fused_train": [], "grid": []}
    for label, trainer in (("fused_train", fast), ("grid", slow), ("grid", slow),
                           ("fused_train", fast)):
        ms = time_ms(lambda: trainer.train_step(*batch), reps=FUSED_TRAIN_TIMED_STEPS)
        trace = profiled(lambda: trainer.train_step(*batch), 10, None,
                         kernel="fused_train_cell_kernel" if label == "fused_train"
                         else GRID_KERNEL)
        timed[label].append({"ms_per_step": ms, "scenes_per_s": TRAIN_BATCH / ms * 1e3,
                             "device_events_per_step": trace["device_events_per_rep"],
                             "device_ms_per_step": trace["device_ms"] / trace["reps"]})
    figures = {"kernels": kernels, "route_vs_grid": route_errs, "step_launches": step_launches,
               "train_step": timed, "seconds": time.perf_counter() - t_phase}
    say("fused_train", step_launches=step_launches, train_step=timed, card=card,
        seconds=figures["seconds"])
    print("Fused train route  S={} A=8: {:.3f} ms/step and {:.0f} device events on graphs, "
          "the grid route {:.3f} and {:.0f} ({})".format(
              TRAIN_BATCH, min(r["ms_per_step"] for r in timed["fused_train"]),
              timed["fused_train"][0]["device_events_per_step"],
              min(r["ms_per_step"] for r in timed["grid"]),
              timed["grid"][0]["device_events_per_step"], card), flush=True)
    return {"launches": step_launches["replay"], "figures": figures}


def device_phase(dev, rng, model, params, rollout_ms) -> dict:
    """Phase 4b: the fused step's device time per launch under
    ``torch.profiler`` at ``DEVICE_SHAPES``, its bound and the share of the
    bound reached, the plain step's time (CUDA events), and its library
    yardstick: the three products alone
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

            plain_ms = time_ms(
                lambda: fused_step.fused_dlstm_step_plain(obs1, obs2, p1, p2, h, c, w), reps=5)
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
                "bound_share": bound_ms / device_ms, "plain_ms": plain_ms,
                "library_f32_ms": library[False],
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
        "S={} A={}: {:.4f} ms/step ({:.0%} of the {:.4f} ms bound), plain {:.4f}, library "
        "f32 {:.4f} / tf32 {:.4f} ms".format(s, a, r["device_ms"], r["bound_share"],
                                             r["bound_ms"], r["plain_ms"], r["library_f32_ms"],
                                             r["library_tf32_ms"])
        for (s, a), r in shapes.items()), flush=True)
    print("Grid  " + "  ".join(
        "S={} A={}: {:.2f} us ({:.0%} of the {:.2f} us bound)".format(
            s, a, 1e3 * r["device_ms"], r["bound_share"], 1e3 * r["bound_ms"])
        for (s, a), r in grid.items()), flush=True)
    return {"shapes": shapes, "prep": prep, "grid": grid}


def along_positions(params, xy, mask, pred, valid, model=None, *, draws=None, goals=None,
                    slot_mask=None):
    """The along reading of a rollout made on the card: the positions that
    ``model``'s own step (``LSTM.step``, through its ``forward``) gives on
    the CPU, in the dtype of ``params``, when each of its 19 steps reads the
    inputs of the rollout ``pred`` / ``valid`` of ``xy`` / ``mask``: the
    observed frames, then that rollout's positions and validity, the
    primary's first decoder input as ``LSTM.start_decoder`` makes it (the
    rollout's ``pred[obs_len - 3]``).  The carry (h, c and a stateful pool's
    state), the goals and the slot mask are the CPU's own.  Both sides see
    the same inputs at every step, so the difference from ``pred`` is each
    step's arithmetic, never a parting of two rollouts at a grid cell edge.

    model: an ``LSTM`` of ``pool_models`` (the flagship by default), pred
    [19, S, A, 2]; or an SGAN or a VAE of ``generative_models``, pred [k,
    19, S, A, 2] and its ``draws`` (the noise [k, noise_dim], or the latent
    normals [k, S, A, latent]): the CPU builds the decoder's start with the
    model's own ``start_decoder`` and the same draws and decodes the k modes
    as one mode-major batch, each along its own mode's rows.  Returns
    positions shaped like ``pred``, on the CPU."""
    from trajnetplusplusbaselines_torch.models.lstm import join_modes
    from trajnetplusplusbaselines_torch.models.sgan import SGAN
    from trajnetplusplusbaselines_torch.models.vae import VAE
    from trajnetplusplusbaselines_torch.utils.convert import params_to

    model = flagship_model() if model is None else model
    params = params_to(params, "cpu")
    xy, mask, pred, valid = (x.cpu().contiguous() for x in (xy, mask, pred, valid))
    goals, slot_mask, draws = (None if x is None else x.cpu() for x in (goals, slot_mask, draws))
    folded = pred.dim() == 5
    if not folded:
        pred, valid = pred[None], valid[None]
    modes, steps, s, a = pred.shape[:4]
    obs_len = xy.shape[0]
    # the decoder's inputs, mode m in rows m * S .. (m + 1) * S - 1
    seq = pred.transpose(0, 1).reshape(steps, modes * s, a, 2).contiguous()
    seq_valid = valid.transpose(0, 1).reshape(steps, modes * s, a).contiguous()
    stepping = model.generator if isinstance(model, SGAN) else model
    out = []

    def along_step(params, cell, carry, obs1, obs2, p1, p2, *args, **kw):
        t = len(out)
        if t < obs_len - 1:
            obs1, obs2, p1, p2 = xy[t], xy[t + 1], mask[t], mask[t + 1]
        else:
            if t == obs_len - 1:
                obs1, p1 = xy[-1].repeat(modes, 1, 1), mask[-1].repeat(modes, 1)
                obs1[:, 0], p1[:, 0] = seq[t - 2][:, 0], seq_valid[t - 2][:, 0]
            else:
                obs1, p1 = seq[t - 2], seq_valid[t - 2]
            obs2, p2 = seq[t - 1], seq_valid[t - 1]
        carry, normal, m = stepping.step(params, cell, carry, obs1, obs2, p1, p2, *args, **kw)
        out.append((obs2 + normal[..., :2]) * m[..., None])
        return carry, normal, m

    kw = dict(n_predict=steps - obs_len + 2, goals=goals, slot_mask=slot_mask)
    with torch.no_grad(), mock.patch.object(stepping, "step_fn", lambda params: along_step):
        if isinstance(model, SGAN):
            model.generate(params, xy, mask, modes=modes, noise=draws, **kw)
        elif isinstance(model, VAE):
            model.forward(params, xy, mask, training=False, modes=modes, eps=draws, **kw)
        else:
            model.forward(params, xy, mask, **kw)
    if len(out) != steps:
        raise AssertionError(f"the along reading ran {len(out)} steps, the rollout {steps}")
    if not folded:
        return torch.stack(out)
    return join_modes(out[:obs_len - 1], out[obs_len - 1:], modes)


def along_reading(params, xy, mask, pred, valid, model=None, **kw) -> dict:
    """``along_positions``' largest difference from ``pred`` over ``valid``
    positions (``max_position_err_m``), where it lies (``worst_along``: its
    mode, if ``pred`` has modes, step, scene and agent) and the seconds the
    reading took (``along_seconds``, host clock)."""
    t0 = time.perf_counter()
    along = along_positions(params, xy, mask, pred, valid, model, **kw)
    pred, valid = pred.cpu(), valid.cpu()
    err = torch.where(valid, (along - pred).abs().amax(dim=-1), torch.zeros((), dtype=pred.dtype))
    where = np.unravel_index(int(err.argmax()), tuple(err.shape))
    names = ("mode", "step", "scene", "agent")[-err.dim():]
    return {"max_position_err_m": float(err.max()),
            "worst_along": dict(zip(names, map(int, where))),
            "along_seconds": time.perf_counter() - t0}


def raise_on_along(failures):
    """Raise, naming each rollout read over ``ALONG_ATOL``, if any was."""
    if failures:
        raise AssertionError(f"positions along the card's own rollout differ from the CPU "
                             f"step's by more than {ALONG_ATOL} m: " + "; ".join(failures))


def one_step_errors(params, observed):
    """The fused step against the bench's ``plain_step`` on identical inputs:
    at each of the 19 steps of ``bench_torch.plain_rollout(params,
    observed)``, that rollout's own obs1, obs2, h and c.  Returns
    ({"h", "c", "normal": [19, S] largest error of each scene}, [19, S]
    True where every value is within ``STEP_ATOL`` / ``STEP_RTOL``)."""
    import bench_torch
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step

    record = []
    bench_torch.plain_rollout(params, observed, record=record)
    errors, within = {"h": [], "c": [], "normal": []}, []
    for cell, obs1, obs2, h, c in record:
        present = torch.ones(obs2.shape[:2], dtype=torch.bool, device=obs2.device)
        got = fused_step.fused_dlstm_step(obs1, obs2, present, present, h, c,
                                          fused_step.weights_from_params(params, cell))
        want = bench_torch.plain_step(params, cell, obs1, obs2, h, c)
        ok = torch.ones(obs2.shape[0], dtype=torch.bool, device=obs2.device)
        for name, g, x in zip(errors, got[:3], want):
            errors[name].append((g - x).abs().amax(dim=(1, 2)))
            ok &= ((g - x).abs() <= STEP_ATOL + STEP_RTOL * x.abs()).all(dim=2).all(dim=1)
        within.append(ok)
    return {name: torch.stack(e) for name, e in errors.items()}, torch.stack(within)


def rollout_parting_phase(dev, card) -> dict:
    """Phase 4c: where the fused rollout parts from the plain one, on the
    bench's rollout cell's own inputs at ``PARTING_SEEDS``: each seed's whole
    ``random_walks(seed, 131072)`` batch and ``init_params`` from
    ``torch.Generator().manual_seed(seed)``, as ``bench_torch.rollout_cell``
    builds them, through ``LSTM.forward`` (19 fused launches), read on its
    1,024 checked scenes by ``bench_torch.rollout_readings``: the along
    reading and, for each scene whose free rollouts differ by more than
    ``ALONG_ATOL``, where they part (``bench_torch.parting``), with the fused
    step's one-step error on identical inputs there (``one_step_errors``).
    Raises after the last seed on an along reading over ``ALONG_ATOL``, a
    departure left unexplained, or a one-step error over the step
    tolerance.  Returns {seed: line}."""
    import bench_torch
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step

    scenes, lines, failed = bench_torch.ROLLOUT_SCENES, {}, []
    for seed in PARTING_SEEDS:
        model = bench_torch.flagship_model()
        params = model.init_params(torch.Generator().manual_seed(seed), device=dev)
        xy = torch.from_numpy(bench_torch.random_walks(seed, scenes)[:bench_torch.OBS]).to(dev)
        picked = bench_torch.checked_scenes(scenes, dev)
        with torch.no_grad():
            before = fused_step.fused_dlstm_step.launches
            _, pred, _ = model.forward(params, xy, torch.ones(xy.shape[:3], dtype=torch.bool,
                                                              device=dev), n_predict=12)
            torch.cuda.synchronize()
            launches = fused_step.fused_dlstm_step.launches - before
            observed, got = xy[:, picked], pred[:, picked]
            del xy, pred
            readings = bench_torch.rollout_readings(params, observed, got, picked.tolist())
            errors, within = one_step_errors(params, observed)
        for d in readings["departures"]:
            k, t = d["checked_index"], d["first_step"]
            steps = slice(None) if t is None else slice(t, t + 1)  # no flip: every step
            d["one_step_err"] = {name: float(e[steps, k].max()) for name, e in errors.items()}
            d["one_step_within_tolerance"] = bool(within[steps, k].all())
        line = {"seed": seed, "scenes": scenes, "checked_scenes": len(picked),
                "launches": launches, **readings, "along_atol_m": ALONG_ATOL,
                "one_step_max_err": {name: float(e.max()) for name, e in errors.items()},
                "one_step_within_tolerance": bool(within.all()),
                "step_atol": STEP_ATOL, "step_rtol": STEP_RTOL, "card": card}
        say("rollout_parting", **line)
        lines[seed] = line
        if launches != 19:
            failed.append(f"seed {seed}: {launches} fused launches, not 19")
        if readings["max_position_err_m"] > ALONG_ATOL:
            failed.append(f"seed {seed}: along {readings['max_position_err_m']} m")
        if not readings["departures_explained"]:
            failed.append(f"seed {seed}: departures unexplained: "
                          f"{[d['scene'] for d in readings['departures'] if not d['explained']]}")
        if not line["one_step_within_tolerance"]:
            failed.append(f"seed {seed}: one-step errors {line['one_step_max_err']}")
    if failed:
        raise AssertionError("rollout parting: " + "; ".join(failed))
    return lines


# the launches CUDA graph replays ran, by kernel: "ran", the kernel nodes of
# each replayed graph read from the graph itself; "bookkept", what
# ``StepGraphs`` added to the wrappers' counters for the same replays
REPLAYED = {"ran": Counter(), "bookkept": Counter()}
COUNTER_NAMES = ("fused_dlstm_step", "directional_grid", "directional_grid_bf16",
                 *TRAIN_KERNELS)


def loss_launches(train_losses: int, val_losses: int = 0) -> dict:
    """The loss kernels' launches of a ``pred``-criterion trainer in f32 on
    the card, whichever route made its rollouts: ``fused_train_loss`` for
    each of ``train_losses`` train losses and ``val_losses`` validation
    losses (two a validation batch), ``fused_train_loss_backward`` for each
    train loss."""
    return {TRAIN_KERNELS[4]: train_losses + val_losses, TRAIN_KERNELS[5]: train_losses}


def fused_train_launches(steps: int, rollouts: int, losses=None, val_losses: int = 0) -> dict:
    """The fused train route's launches over ``rollouts`` train steps (a
    teacher-forced rollout under autograd, its loss and their backward) of
    ``steps`` rollout steps in all: each per-step kernel once a step,
    ``fused_train_in_backward`` once a rollout, and ``loss_launches`` of
    ``losses`` train losses (by default one a rollout; a caller with its
    own loss, as ``tools.profile_train``, none) and ``val_losses``."""
    losses = rollouts if losses is None else losses
    return {**dict.fromkeys(TRAIN_KERNELS[:3], steps), TRAIN_KERNELS[3]: rollouts,
            **loss_launches(losses, val_losses)}


def plain_prediction_loss(rel, targets, scene_mask):
    """``losses.prediction_loss`` of the primaries' last normals of ``rel``:
    the trainer's ``pred`` criterion before the loss kernels, the grid
    route's loss where phase 6c holds the fused train route against it."""
    from trajnetplusplusbaselines_torch.losses import prediction_loss

    return prediction_loss(rel[-targets.shape[0]:, :, 0], targets, scene_mask)


def graph_kernel_nodes(dot: str) -> Counter:
    """The nodes of the port's kernels in a CUDA graph's DOT dump
    (``CUDAGraph.debug_dump``), by launch counter: each node is defined at
    the start of a line, ``"id"[...]``, up to the next one, and a kernel
    node's label names its function; the grid stage's bf16 instantiation
    names ``__nv_bfloat16``; the fused train route's kernels are named
    after their wrappers (``TRAIN_KERNELS``, ``<name>_kernel``)."""
    nodes = Counter()
    starts = list(re.finditer(r'(?m)^\s*"[^"]+"\s*\[', dot))
    for start, end in zip(starts, starts[1:] + [None]):
        label = dot[start.end():end.start() if end else len(dot)]
        if "fused_step_kernel" in label:
            nodes["fused_dlstm_step"] += 1
        elif "directional_grid_kernel" in label:
            nodes["directional_grid_bf16" if "bfloat16" in label else "directional_grid"] += 1
        else:
            nodes.update(name for name in TRAIN_KERNELS if f"{name}_kernel" in label)
    return nodes


def install_graph_counting():
    """Measure what the port's CUDA graph replays launch.  Every graph a
    ``trainers/graphs.StepGraphs`` captures is made a ``CountedGraph``: once
    captured it reads its own kernel nodes from its DOT dump
    (``graph_kernel_nodes``), and each replay adds them to
    ``REPLAYED["ran"]``.  Each ``StepGraphs`` replay is held to its graph:
    the counts it adds to the wrappers' counters (what the capture's
    wrappers counted) must equal the graph's nodes, and go to
    ``REPLAYED["bookkept"]``, so that ``Launches`` swaps them for the
    measured ones."""
    from trajnetplusplusbaselines_torch.trainers import graphs

    class CountedGraph(torch.cuda.CUDAGraph):
        # ``keep_graph``: the captured graph outlives ``capture_end``, so
        # that ``debug_dump`` can print it; it is instantiated after that
        def __new__(cls, keep_graph=True):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=True):
            super().__init__(True)
            self.kernels = Counter()

        def capture_end(self):
            super().capture_end()
            with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="DEBUG: calling")
                path = Path(tmp) / "graph.dot"
                self.debug_dump(str(path))
                self.kernels = graph_kernel_nodes(path.read_text())
            self.instantiate()

        def replay(self):
            super().replay()
            REPLAYED["ran"].update(self.kernels)

    replay = graphs.StepGraphs._replay

    def held_replay(self, captured, batch):
        bookkept = Counter(dict(zip(COUNTER_NAMES, captured.counts)))
        if bookkept != captured.graph.graph.kernels:
            raise AssertionError(f"a replay adds {dict(bookkept)} launches, its graph holds "
                                 f"{dict(captured.graph.graph.kernels)} kernel nodes")
        REPLAYED["bookkept"].update(bookkept)
        return replay(self, captured, batch)

    torch.cuda.CUDAGraph = CountedGraph
    graphs.StepGraphs._replay = held_replay


class Launches:
    """The launches of the port's kernels (the fused step, the grid stage
    and its bf16 instantiation, the fused train route's four), zeroed just
    before a run and read just after it, with a running total by kernel of
    the runs read into it: the wrappers' counters, where CUDA graph replays
    launched a kernel the kernel nodes they ran (``install_graph_counting``)."""

    def __init__(self):
        from trajnetplusplusbaselines_torch.ops.cuda import fused_step, fused_train

        self.kernels = (("fused_dlstm_step", fused_step.fused_dlstm_step, "launches"),
                        ("directional_grid", fused_step.directional_grid, "launches"),
                        ("directional_grid_bf16", fused_step.directional_grid, "bf16_launches"),
                        *((name, getattr(fused_train, name), "launches")
                          for name in TRAIN_KERNELS))
        self.totals = {name: 0 for name, _, _ in self.kernels}

    def zero(self):
        for _, fn, attr in self.kernels:
            setattr(fn, attr, 0)
        for tally in REPLAYED.values():
            tally.clear()

    def current(self) -> dict:
        """The launches since ``zero``, by kernel."""
        torch.cuda.synchronize()
        return {name: getattr(fn, attr) - REPLAYED["bookkept"][name] + REPLAYED["ran"][name]
                for name, fn, attr in self.kernels}

    def read(self, want, add=True) -> dict:
        """The counts since ``zero``, held to ``want`` (a kernel it does not
        name: none); ``add`` takes them into the totals."""
        got = self.current()
        if add:
            for name in self.totals:
                self.totals[name] += got[name]
        want = {name: want.get(name, 0) for name in self.totals}
        if got != want:
            raise AssertionError(f"launched {got}, expected {want}")
        return got


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

    counters = Launches()
    zero, read = counters.zero, counters.read

    # (a) rollouts of every pool at two shapes, card against CPU: free, and
    # along the card's own rollout (``along_positions``)
    inputs = {shape: pool_inputs(rng, *shape, dev) for shape in POOL_ROLLOUTS}
    rollout_ms, along_failures = {}, []
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
            along = along_reading(params, xy[:, :k], mask[:, :k], pred[:, :k], valid[:, :k],
                                  model, goals=goals[:k], slot_mask=slot[:k])
            if along["max_position_err_m"] > ALONG_ATOL:
                along_failures.append(f"{name} at S={s} A={a}: {along}")
            with torch.no_grad():
                ms = time_ms(lambda: model.forward(params, xy, mask, **kw), reps=5, warmup=2)
            rollout_ms[(name, s, a)] = ms
            say("pools_rollout", model=name, s=s, a=a, route=route, launches=launches,
                **along, free_max_position_err_m=err, along_atol_m=ALONG_ATOL, cpu_scenes=k,
                rollout_ms=ms, rollout_scenes_per_s=s / ms * 1e3)
    raise_on_along(along_failures)

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
                close_log()
                (_, resident), (_, val_resident) = trainer._resident.values()
                batches = [batches_per_epoch(r) for r in (resident, val_resident)]
                route = trainer.model.route(records=True)
                train_launches = read({"fused_dlstm_step": 0, "directional_grid":
                                       19 * (batches[0] + 2 * batches[1]) * (route == "grid"),
                                       **loss_launches(batches[0], 2 * batches[1])})
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
    return {"launches": counters.totals, "grid_err": grid_err, "grid": grid_us}


def generative_models() -> dict:
    """Phase 8's models at the flagship's widths (directional n=12, cell
    0.6 m, pool 256, embedding 64, hidden 128): an SGAN (noise 16, k=3, the
    discriminator with its own pool) and a VAE (latent 128, desire, k=3)."""
    from trajnetplusplusbaselines_torch.models.sgan import SGAN, LSTMDiscriminator, LSTMGenerator
    from trajnetplusplusbaselines_torch.models.vae import VAE
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    def pool():
        return GridBasedPooling(type_="directional", hidden_dim=128, cell_side=CELL_SIDE, n=N,
                                out_dim=256)

    generator = LSTMGenerator(pool=pool(), noise_dim=GEN_NOISE_DIM)
    models = {"sgan": SGAN(generator, LSTMDiscriminator(pool=pool()), k=GEN_MODES),
              "vae": VAE(pool=pool(), num_modes=GEN_MODES, latent_dim=GEN_LATENT)}
    if not (generator.fused and models["vae"].fused):
        raise AssertionError("phase 8's models are not at the fused step's widths")
    return models


def generative_rollout(kind, model, params, xy, mask, draws):
    """(pred [k, 19, S, A, 2], valid) of GEN_MODES folded modes, without
    autograd: an SGAN's noise or a VAE's latent normals given as ``draws``."""
    with torch.no_grad():
        if kind == "sgan":
            return model.generate(params, xy, mask, n_predict=12, modes=GEN_MODES,
                                  noise=draws)[1:]
        return model.forward(params, xy, mask, n_predict=12, training=False, modes=GEN_MODES,
                             eps=draws)[1:3]


def generative_steps(kind, model, params, dev, rng, card, counted) -> dict:
    """Phase 8b: one SGAN generator and discriminator step, or one VAE step,
    at batch 8 on the card in f32 against f64 on the CPU (phase 7c's
    tolerances), noise, latent normals and label pinned; the launches of
    each step on the card (``counted``) and its time."""
    from trajnetplusplusbaselines_torch.trainers import sgan as sgan_trainer
    from trajnetplusplusbaselines_torch.trainers import vae as vae_trainer
    from trajnetplusplusbaselines_torch.trainers.common import Batch, step_lr
    from trajnetplusplusbaselines_torch.utils.convert import params_from_jax, params_to_numpy

    xy, mask, scene = train_inputs(rng, TRAIN_BATCH, 8, dev)
    batch = Batch(xy, mask, scene, torch.zeros_like(xy[0]), mask.any(dim=0))
    cpu_batch = Batch(*(x.cpu() for x in batch))
    gen = torch.Generator().manual_seed(5)

    def trainer(device, dtype):
        own = params_from_jax(params_to_numpy(params), device=device, dtype=dtype)
        if kind == "sgan":
            return sgan_trainer.Trainer(model, own, step_lr(1e-3, 10), step_lr(1e-3, 10),
                                        criterion="pred")
        return vae_trainer.Trainer(model, own, step_lr(1e-3, 10))

    card_tr, cpu_tr = trainer(dev, torch.float32), trainer("cpu", torch.float64)
    rows = {}
    if kind == "sgan":
        noise = torch.randn(GEN_MODES, GEN_NOISE_DIM, generator=gen)
        steps = {"g": (card_tr.g_loss_and_grads, cpu_tr.g_loss_and_grads, noise, card_tr.g_paths,
                       {"directional_grid": 19, "fused_dlstm_step": 0}),
                 "d": (card_tr.d_loss_and_grads, cpu_tr.d_loss_and_grads, noise[:1],
                       card_tr.d_paths, {"directional_grid": 40, "fused_dlstm_step": 19})}
        for step_type, (on_card, on_cpu, draws, paths, want) in steps.items():
            got = counted(lambda: on_card(*batch, noise=draws.to(dev), label=GEN_LABEL), want)
            loss_rel, grad_err = step_errors(
                got, on_cpu(*cpu_batch, noise=draws.double(), label=GEN_LABEL), paths)
            rows[step_type] = {"cpu_loss_rel_err": loss_rel, "cpu_grad_max_err_share": grad_err,
                               "launches": want}
        for step_type, row in rows.items():  # the timed steps train: after the checks
            row["train_step_ms"] = time_ms(
                lambda: card_tr.train_step(*batch, step_type=step_type), reps=10)
    else:
        eps = torch.randn(GEN_MODES, TRAIN_BATCH, 8, GEN_LATENT, generator=gen)
        want = {"directional_grid": 30, "fused_dlstm_step": 0}
        got = counted(lambda: card_tr.loss_and_grads(*batch, eps=eps.to(dev)), want)
        loss, _, grads = cpu_tr.loss_and_grads(*cpu_batch, eps=eps.double())
        loss_rel, grad_err = step_errors((got[0], got[2]), (loss, grads), card_tr.paths)
        rows["vae"] = {"cpu_loss_rel_err": loss_rel, "cpu_grad_max_err_share": grad_err,
                       "launches": want,
                       "train_step_ms": time_ms(lambda: card_tr.train_step(*batch), reps=10)}
    for step, row in rows.items():
        say("generative_step", model=kind, step=step, batch=list(batch.xy.shape), card=card,
            **row)
    return rows


def generative_phase(dev, rng, card) -> dict:
    """Phase 8: the SGAN and the VAE, served and trained, on the card.

    (a) rollouts of GEN_MODES modes folded at GEN_ROLLOUTS: 19 fused-step
        launches per rollout whatever the modes; on its first
        POOL_CPU_SCENES scenes of each mode, positions within ALONG_ATOL
        along the card's own rollout (``along_positions``) and within
        POSITION_ATOL of a free CPU run of the same model on the same
        draws; and each rollout's time (CUDA events) over
        GEN_TIMED_REPEATS windows of GEN_TIMED_REPS rollouts, as a range;
    (b) ``generative_steps``;
    (c) ``trainers.sgan.main`` (--k 3) and ``trainers.vae.main`` (--k 3),
        one epoch each at batch 8 on a split of phase 6's sizes, the
        launches of each counted against the batches (19 grid-stage
        launches per generator forward), then each pickle served through
        ``sgan_cli`` / ``vae_cli --modes 3`` (predict, write, evaluate).

    Returns the launch counts of (a) and (c) by kernel."""
    from trajnetplusplusbaselines_torch.evaluator import sgan_cli, vae_cli
    from trajnetplusplusbaselines_torch.evaluator.learned import bucket_plan
    from trajnetplusplusbaselines_torch.trainers import sgan as sgan_trainer
    from trajnetplusplusbaselines_torch.trainers import vae as vae_trainer
    from trajnetplusplusbaselines_torch.utils.convert import params_to

    counters = Launches()
    zero, read = counters.zero, counters.read

    def counted(fn, want):
        """fn() with the launches it makes held to ``want``, which phase 8's
        totals do not take (a comparison with the CPU)."""
        zero()
        out = fn()
        read(want, add=False)
        return out

    models = generative_models()
    params = {kind: model.init_params(torch.Generator().manual_seed(11), device=dev)
              for kind, model in models.items()}
    gen = torch.Generator().manual_seed(12)
    rollout_ms, along_failures = {}, []
    for kind, model in models.items():
        cpu_params = params_to(params[kind], "cpu")
        for s, a in GEN_ROLLOUTS:
            xy, mask = rollout_inputs(rng, s, a, dev)
            draws = (torch.randn(GEN_MODES, GEN_NOISE_DIM, generator=gen) if kind == "sgan"
                     else torch.randn(GEN_MODES, s, a, GEN_LATENT, generator=gen))
            card_draws = draws.to(dev)
            zero()
            pred, valid = generative_rollout(kind, model, params[kind], xy, mask, card_draws)
            launches = read({"fused_dlstm_step": 19, "directional_grid": 0})
            k = POOL_CPU_SCENES
            cpu_draws = draws if kind == "sgan" else draws[:, :k]
            cpu_pred, cpu_valid = generative_rollout(
                kind, model, cpu_params, xy[:, :k].cpu(), mask[:, :k].cpu(), cpu_draws)
            if pred.shape != (GEN_MODES, 19, s, a, 2) or not torch.isfinite(pred).all():
                raise AssertionError(f"{kind}: positions are not finite [k, 19, S, A, 2]")
            if not torch.equal(valid[:, :, :k].cpu(), cpu_valid):
                raise AssertionError(f"{kind}: validity differs from the CPU's at S={s} A={a}")
            err = float((pred[:, :, :k].cpu() - cpu_pred)[cpu_valid].abs().max())
            if err > POSITION_ATOL:
                raise AssertionError(f"{kind}: positions differ from the CPU's by {err} m "
                                     f"at S={s} A={a}")
            along = along_reading(params[kind], xy[:, :k], mask[:, :k], pred[:, :, :k],
                                  valid[:, :, :k], model, draws=cpu_draws)
            if along["max_position_err_m"] > ALONG_ATOL:
                along_failures.append(f"{kind} at S={s} A={a}: {along}")
            spread = float((pred[0] - pred[1])[valid[0]].abs().max())
            if not spread > 0:
                raise AssertionError(f"{kind}: the modes are the same rollout")
            ms = [time_ms(lambda: generative_rollout(kind, model, params[kind], xy, mask,
                                                     card_draws),
                          reps=GEN_TIMED_REPS, warmup=2 if i == 0 else 0)
                  for i in range(GEN_TIMED_REPEATS)]
            rollout_ms[(kind, s, a)] = ms
            say("generative_rollout", model=kind, s=s, a=a, modes=GEN_MODES, launches=launches,
                **along, free_max_position_err_m=err, along_atol_m=ALONG_ATOL, cpu_scenes=k,
                mode_spread_m=spread, rollout_ms=[min(ms), max(ms)],
                rollout_scenes_per_s=s / min(ms) * 1e3, card=card)
    raise_on_along(along_failures)

    steps = {kind: generative_steps(kind, models[kind], params[kind], dev, rng, card, counted)
             for kind in models}

    cwd = os.getcwd()
    root = "DATA_BLOCK/synth_gen"
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            n_train, n_val, n_test = POOL_SPLIT  # phase 6's sizes
            write_split(root, rng, n_scenes=n_train, big=None, observed_only=(), full=("train",))
            write_split(root, rng, n_scenes=n_val, big=None, observed_only=(), full=("val",))
            observed = write_split(root, rng, n_scenes=n_test, big=None)
            serve_plan = bucket_plan([xy.shape[1] for _, xy in observed], BATCH_SCENES)
            runs = (("sgan", sgan_trainer.main, sgan_cli, ["--noise_dim", str(GEN_NOISE_DIM)]),
                    ("vae", vae_trainer.main, vae_cli, ["--vae_latent_dim", str(GEN_LATENT)]))
            for kind, train_main, cli, extra in runs:
                zero()
                t0 = time.perf_counter()
                trainer = train_main(argv=[
                    "--path", "synth_gen", "--type", "directional", "--n", str(N),
                    "--cell_side", str(CELL_SIDE), "--pool_dim", "256", "--hidden-dim", "128",
                    "--coordinate-embedding-dim", "64", "--epochs", "1",
                    "--batch_size", str(TRAIN_BATCH), "--seed", "0", "--k", str(GEN_MODES),
                    "-o", "gen", "--device", DEVICE, *extra])
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t0
                close_log()
                (_, resident), (_, val_resident) = trainer._resident.values()
                batches = [batches_per_epoch(r) for r in (resident, val_resident)]
                if kind == "sgan":
                    kinds = trainer.step_types(batches[0])
                    g, d = kinds.count("g"), kinds.count("d")
                    want = {"fused_dlstm_step": 19 * (d + batches[1]),
                            "directional_grid": 19 * g + 40 * d}
                else:
                    want = {"fused_dlstm_step": 30 * batches[1],
                            "directional_grid": 30 * batches[0]}
                train_launches = read(want)
                out = f"OUTPUT_BLOCK/synth_gen/{kind}_directional_gen.pkl"
                with open(out + ".log") as f:
                    records = [json.loads(line) for line in f]
                losses = [r[key] for r in records for key in ("loss", "test_loss")
                          if r.get("type") in ("train", "train-epoch", "val-epoch") and key in r]
                if not losses or not np.isfinite(losses).all():
                    raise AssertionError(f"{kind}: training logged {records}")

                zero()
                t0 = time.perf_counter()
                table = cli.main(["--path", "synth_gen", "--output", out, "--modes",
                                  str(GEN_MODES), "--device", DEVICE])
                serve_s = time.perf_counter() - t0
                serve_launches = read({"fused_dlstm_step": 19 * len(serve_plan),
                                       "directional_grid": 0})
                scored = table.results[f"{kind}_directional_gen_modes{GEN_MODES}"][32:40]
                if scored[0] != n_test or not np.isfinite(scored[1:3]).all():
                    raise AssertionError(f"{kind}: the trained model scored {scored}")
                served[kind] = scored[1:3]
                say("generative_train", model=kind, cli_seconds=cli_s, serve_seconds=serve_s,
                    train_batches=batches[0], val_batches=batches[1],
                    train_launches=train_launches, serve_launches=serve_launches,
                    serve_batches=len(serve_plan),
                    epoch_loss=[r["loss"] for r in records if r.get("type") == "train-epoch"],
                    served_ade_fde=scored[1:3], card=card)
        finally:
            os.chdir(cwd)
    print("Generative  " + "  ".join(
        f"{m} {s}x{a} k={GEN_MODES}: {min(ms):.2f}-{max(ms):.2f} ms"
        for (m, s, a), ms in rollout_ms.items())
        + "  steps at batch 8: " + "  ".join(
            f"{kind} {step} {row['train_step_ms']:.1f} ms" for kind, rows in steps.items()
            for step, row in rows.items()) + f"  ({card})", flush=True)
    return {"launches": counters.totals}

def bf16_grid_phase(dev, rng, card) -> dict:
    """Phase 10(a): the grid stage's bf16 instantiation against the plain
    bf16 grid, bit-exact, at phase 2's buckets and on ``grid_edge_cases``;
    its device time per launch (``torch.profiler``) against its bf16 bound at
    ``GRID_DEVICE_SHAPES``, the f32 instantiation's beside it in the same
    call, and the plain bf16 grid's time per call at a train step's shape."""
    from trajnetplusplusbaselines_torch.ops.cuda import fused_step

    for a in BUCKETS:
        s = math.ceil(ROWS_PER_BUCKET / a)
        obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
        obs1, obs2 = obs1.bfloat16(), obs2.bfloat16()
        got = fused_step.directional_grid(obs1, obs2, p1, p2, cell_side=CELL_SIDE)
        want = fused_step.directional_grid_plain(obs1, obs2, p1, p2, cell_side=CELL_SIDE)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"bf16 grid differs at A={a}: first cells {bad}")
    cases = grid_edge_cases(np.random.default_rng(3))
    for case in cases:
        obs1, obs2 = (torch.from_numpy(x).to(dev).bfloat16() for x in (case.obs1, case.obs2))
        p1, p2 = (torch.from_numpy(x).to(dev) for x in (case.p1, case.p2))
        got = fused_step.directional_grid(obs1, obs2, p1, p2, **case.geometry)
        want = fused_step.directional_grid_plain(obs1, obs2, p1, p2, **case.geometry)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"bf16 grid edge case {case.name} differs: first cells {bad}")

    rows = {}
    for s, a in GRID_DEVICE_SHAPES:
        obs1, obs2, p1, p2 = step_inputs(rng, s, a, dev)
        row = {"rows": s * a, "n": N}
        for tag, dtype, value_bytes in (("f32", torch.float32, 4), ("bf16", torch.bfloat16, 2)):
            x1, x2 = obs1.to(dtype), obs2.to(dtype)
            ms = kernel_ms_per_launch(lambda: fused_step.directional_grid(x1, x2, p1, p2),
                                      GRID_REPS, "directional_grid_kernel")
            bound = grid_bound_ms(s * a, N, value_bytes)
            row.update({f"{tag}_device_ms": ms, f"{tag}_bound_ms": bound,
                        f"{tag}_bound_share": bound / ms})
        rows[(s, a)] = row
    obs1, obs2, p1, p2 = step_inputs(rng, TRAIN_BATCH, 8, dev)
    obs1, obs2 = obs1.bfloat16(), obs2.bfloat16()
    per_call_ms = time_ms(lambda: fused_step.directional_grid(obs1, obs2, p1, p2), reps=50)
    plain_ms = time_ms(lambda: fused_step.directional_grid_plain(obs1, obs2, p1, p2), reps=50)
    say("bf16_grid", buckets=list(BUCKETS), edge_cases=len(cases), bit_exact=True,
        per_call_ms=per_call_ms, plain_ms=plain_ms,
        shapes={f"{s}x{a}": row for (s, a), row in rows.items()}, card=card)
    return {"rows": rows, "per_call_ms": per_call_ms, "plain_ms": plain_ms}


def training_options_phase(dev, rng, card) -> dict:
    """Phase 10 (b)-(e) (see the module's docstring): ``--bf16``,
    ``--remat``, ``--obs_dropout`` and the seed ensemble at the flagship's
    widths.  Returns the launch counts of its trainer runs by run and
    kernel, and its figures."""
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli
    from trajnetplusplusbaselines_torch.evaluator.learned import bucket_plan
    from trajnetplusplusbaselines_torch.trainers import ensemble
    from trajnetplusplusbaselines_torch.trainers import lstm as train_cli
    from trajnetplusplusbaselines_torch.trainers.common import Batch, bucket_batches, step_lr
    from trajnetplusplusbaselines_torch.utils.convert import params_from_jax, params_to_numpy

    counters = Launches()
    launches, figures = {}, {}
    cwd = os.getcwd()
    root, path = "DATA_BLOCK/synth_options", "synth_options"
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            n_train, n_val, n_test = POOL_SPLIT  # phase 6's sizes
            write_split(root, rng, n_scenes=n_train, big=None, observed_only=(), full=("train",))
            write_split(root, rng, n_scenes=n_val, big=None, observed_only=(), full=("val",))
            observed = write_split(root, rng, n_scenes=n_test, big=None)
            serve_plan = bucket_plan([xy.shape[1] for _, xy in observed], BATCH_SCENES)

            # (b) --bf16: the grid stage in bf16, no fused step
            counters.zero()
            t0 = time.perf_counter()
            trainer = train_cli.main(argv=flagship_argv(
                path, "--bf16", "--epochs", str(TRAIN_EPOCHS), "--save_every", "1",
                "--seed", "0", "-o", "bf16"))
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            close_log()
            (_, resident), (_, val_resident) = trainer._resident.values()
            tb, vb = batches_per_epoch(resident), batches_per_epoch(val_resident)
            launches["bf16_train"] = counters.read(
                {"directional_grid_bf16": 19 * (tb + 2 * vb) * TRAIN_EPOCHS,
                 **loss_launches(tb * TRAIN_EPOCHS, 2 * vb * TRAIN_EPOCHS)})
            out = f"OUTPUT_BLOCK/{path}/lstm_directional_bf16.pkl"
            records = log_records(out + ".log")
            losses = ([r["loss"] for r in records["train-epoch"]]
                      + [r[k] for r in records["val-epoch"] for k in ("loss", "test_loss")])
            if len(records["train-epoch"]) != TRAIN_EPOCHS or not np.isfinite(losses).all():
                raise AssertionError(f"bf16 training logged {records}")
            if any(leaf.dtype != torch.float32 for leaf in trainer.leaves) or any(
                    st["exp_avg"].dtype != torch.float32 for st in trainer.optimizer.state.values()):
                raise AssertionError("bf16 training left masters or Adam state off f32")
            counters.zero()
            table = lstm_cli.main(["--path", path, "--output", out, "--device", DEVICE])
            launches["bf16_serve"] = counters.read({"fused_dlstm_step": 19 * len(serve_plan)})
            served = table.results["lstm_directional_bf16_modes1"][32:40]
            if served[0] != n_test or not np.isfinite(served[1:3]).all():
                raise AssertionError(f"the bf16-trained model scored {served}")
            # one bf16 step on the card against the same step on the CPU
            key = (21, 8) if (21, 8) in resident.buckets else next(iter(resident.buckets))
            idx, valid = resident.epoch_plan(TRAIN_BATCH, np.random.default_rng(1))[key]
            batch = next(bucket_batches(resident.buckets[key], idx, valid))
            loss_k, grads_k = trainer.loss_and_grads(*batch)
            cpu = train_cli.Trainer(trainer.model, params_from_jax(params_to_numpy(
                trainer.params)), step_lr(1e-3, 10))
            loss_c, grads_c = cpu.loss_and_grads(*(x.cpu() for x in batch))
            bf16_loss_rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
            flat_k, flat_c = (torch.cat([g.detach().double().cpu().flatten() for g in grads])
                              for grads in (grads_k, grads_c))
            bf16_cosine = float(flat_k @ flat_c / (flat_k.norm() * flat_c.norm()))
            if bf16_loss_rel > BF16_LOSS_RTOL or not bf16_cosine > BF16_GRAD_COSINE:
                raise AssertionError(f"bf16 step: loss {bf16_loss_rel} relative, gradient "
                                     f"cosine {bf16_cosine} against the CPU")
            step_ms = time_ms(lambda: trainer.train_step(*batch), reps=10)
            figures["bf16"] = {"cli_seconds": cli_s, "train_batches": tb, "val_batches": vb,
                               "epoch_losses": [r["loss"] for r in records["train-epoch"]],
                               "served_ade_fde": served[1:3], "cpu_loss_rel_err": bf16_loss_rel,
                               "cpu_grad_cosine": bf16_cosine, "train_step_ms": step_ms}
            say("bf16_train", launches=[launches["bf16_train"], launches["bf16_serve"]],
                **figures["bf16"], card=card)

            # (d) --obs_dropout: 19 - start_length grid launches a batch
            counters.zero()
            trainer = train_cli.main(argv=flagship_argv(
                path, "--obs_dropout", "--epochs", "1", "--seed", "0", "-o", "drop"))
            torch.cuda.synchronize()
            close_log()
            records = log_records(f"OUTPUT_BLOCK/{path}/lstm_directional_drop.pkl.log")
            (dropout,) = records["obs-dropout"]
            start_lengths = dropout["start_lengths"]
            hb = math.ceil(n_train / TRAIN_BATCH)  # the host path's batches: not by bucket
            if len(start_lengths) != hb or not all(0 <= sl <= 7 for sl in start_lengths):
                raise AssertionError(f"--obs_dropout logged {start_lengths} for {hb} batches")
            launches["obs_dropout"] = counters.read(
                {"directional_grid": sum(19 - sl for sl in start_lengths),
                 "fused_dlstm_step": 2 * 19 * vb,
                 **fused_train_launches(sum(19 - sl for sl in start_lengths), hb,
                                        val_losses=2 * vb)})
            if not np.isfinite([r["loss"] for r in records["train-epoch"]]).all():
                raise AssertionError(f"--obs_dropout logged {records['train-epoch']}")
            figures["obs_dropout"] = {"start_lengths": start_lengths,
                                      "epoch_loss": records["train-epoch"][0]["loss"]}
            say("obs_dropout", launches=launches["obs_dropout"], batches=hb,
                start_length_counts=np.bincount(start_lengths, minlength=8).tolist(), card=card)

            # (e) the seed ensemble: 19 grid launches an ensemble step
            seeds = [str(s) for s in ENSEMBLE_SEEDS]
            counters.zero()
            t0 = time.perf_counter()
            ens = ensemble.main(argv=flagship_argv(
                path, "--epochs", str(TRAIN_EPOCHS), "--save_every", "1", "--seeds", *seeds))
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            close_log()
            launches["ensemble"] = counters.read(
                {"directional_grid": 19 * (tb + vb) * TRAIN_EPOCHS})
            outs = [f"OUTPUT_BLOCK/{path}/lstm_directional_seed{s}.pkl" for s in seeds]
            missing = [o + x for o in outs for x in ("", ".state") if not os.path.exists(o + x)]
            if missing:
                raise AssertionError(f"the ensemble wrote no {missing}")
            records = log_records(f"OUTPUT_BLOCK/{path}/lstm_directional_seed{seeds[0]}"
                                  "_ensemble.pkl.log")
            member_losses = [r["loss"] for r in records["train-epoch"]]
            if (len(member_losses) != TRAIN_EPOCHS
                    or not all(len(x) == len(seeds) for x in member_losses)
                    or not np.isfinite(member_losses + [r["loss"] for r in
                                                        records["val-epoch"]]).all()):
                raise AssertionError(f"the ensemble logged {records}")
            # one member resumed by the sequential trainer
            trainer = train_cli.main(argv=flagship_argv(
                path, "--epochs", str(TRAIN_EPOCHS + 1), "--seed", seeds[1], "-o", "resumed",
                "--load-full-state", outs[1] + ".state"))
            close_log()
            resumed = log_records(f"OUTPUT_BLOCK/{path}/lstm_directional_resumed.pkl.log")
            if [r["epoch"] for r in resumed["train-epoch"]] != [TRAIN_EPOCHS + 1] or not (
                    np.isfinite(resumed["train-epoch"][0]["loss"])):
                raise AssertionError(f"the resumed member logged {resumed}")
        finally:
            os.chdir(cwd)

    # (e) an ensemble step's member gradients against five sequential steps
    (train_scenes, _), _ = ens._resident.values()
    stacked = next(ens._member_batches(train_scenes, shuffle=False))
    losses_e, grads_e = ens.loss_and_grads(*stacked)
    member_err = {"loss_rel": 0.0, "grad_share": 0.0}
    sequential = []
    for k, seed in enumerate(ENSEMBLE_SEEDS):
        member = Batch(stacked.xy[:, k], stacked.mask[:, k], stacked.scene_mask[k],
                       stacked.goals[k], stacked.slot_mask[k])
        seq = train_cli.Trainer(ens.model, ensemble.tree_map(
            lambda x: x.clone(), ensemble.member_params(ens.params, k)), step_lr(1e-3, 10),
            seed=seed)
        loss_s, grads_s = seq.loss_and_grads(*member)
        loss_rel, grad_err = step_errors((losses_e[k], [g[k] for g in grads_e]),
                                         (loss_s.cpu().double(),
                                          [g.cpu().double() for g in grads_s]), seq.paths)
        member_err = {"loss_rel": max(member_err["loss_rel"], loss_rel),
                      "grad_share": max(member_err["grad_share"], grad_err)}
        sequential.append((seq, member))

    # (e) timed: the ensemble step at E=5 and one sequential step, warm
    seq, member = sequential[0]
    timed = {"ensemble_step_ms": time_ms(lambda: ens.train_step(*stacked), reps=10),
             "sequential_step_ms": time_ms(lambda: seq.train_step(*member), reps=10)}
    busy = {"ensemble": profiled(lambda: ens.train_step(*stacked), 5, None,
                                 kernel="directional_grid_kernel"),
            "sequential": profiled(lambda: seq.train_step(*member), 5, None,
                                   kernel="directional_grid_kernel")}
    timed["ensemble_per_member_ms"] = timed["ensemble_step_ms"] / len(ENSEMBLE_SEEDS)
    timed["ensemble_scenes_per_s"] = (len(ENSEMBLE_SEEDS) * TRAIN_BATCH
                                      / timed["ensemble_step_ms"] * 1e3)
    timed["sequential_scenes_per_s"] = TRAIN_BATCH / timed["sequential_step_ms"] * 1e3
    figures["ensemble"] = {
        "cli_seconds": cli_s, "members": len(ENSEMBLE_SEEDS),
        "member_epoch_losses": member_losses, "member_vs_sequential": member_err, **timed,
        **{f"{name}_{key}": row[key] for name, row in busy.items()
           for key in ("device_busy", "device_events_per_rep", "kernel_launches")}}
    say("ensemble", launches=launches["ensemble"], **figures["ensemble"], card=card)

    # (c) --remat: a flagship and an attentionmlp step at S=256, A=32
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    flagship = LSTM(pool=GridBasedPooling(type_="directional", hidden_dim=128,
                                          cell_side=CELL_SIDE, n=N, out_dim=256),
                    embedding_dim=64, hidden_dim=128)
    s, a = REMAT_SHAPE
    xy, mask, scene = train_inputs(rng, s, a, dev)
    batch = Batch(xy, mask, scene, torch.zeros_like(xy[0]), mask.any(dim=0))
    figures["remat"] = {}
    for name, model in (("directional", flagship), ("attentionmlp", pool_models()["attentionmlp"])):
        params = model.init_params(torch.Generator().manual_seed(5), device=dev)
        rows = {}
        for remat in (False, True):
            model.remat = remat
            # remat checkpoints the grid route's steps, so the run without it
            # takes that route too, not the fused train route
            with mock.patch.object(model, "takes_fused_train", lambda *args, **kw: False):
                tr = train_cli.Trainer(model, ensemble.tree_map(lambda x: x.clone(), params),
                                       step_lr(1e-3, 10))
                tr.loss_and_grads(*batch)  # warm
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                counters.zero()
                result = tr.loss_and_grads(*batch)
                grid = counters.read({"directional_grid": (38 if remat else 19)
                                      if name == "directional" else 0, **loss_launches(1)},
                                     add=False)
                peak = torch.cuda.max_memory_allocated() - base
                rows[remat] = {"result": result, "peak_bytes": peak,
                               "grid_launches": grid["directional_grid"],
                               "ms": time_ms(lambda: tr.loss_and_grads(*batch), reps=REMAT_REPS,
                                             warmup=1)}
        (loss0, grads0), (loss1, grads1) = rows[False]["result"], rows[True]["result"]
        err = max([abs(float(loss1) - float(loss0)) / abs(float(loss0))]
                  + [float((g1 - g0).abs().max()) / max(float(g0.abs().max()), 1e-30)
                     for g0, g1 in zip(grads0, grads1)])
        if err > REMAT_ATOL_SHARE:
            raise AssertionError(f"{name}: remat moved the step by {err} of a leaf's largest")
        model.remat = False
        figures["remat"][name] = {
            "max_err_share": err, **{f"{key}_{'remat' if r else 'plain'}": row[key]
                                     for r, row in rows.items()
                                     for key in ("peak_bytes", "grid_launches", "ms")}}
    say("remat", s=s, a=a, **figures["remat"], card=card)
    return {"launches": launches, "figures": figures}


def classical_scenes(rng, n_scenes, lo, hi):
    """Observed paths (9 frames, 10 apart, the port's ``TrackRow``) of
    ``n_scenes`` scenes of ``lo``..``hi`` agents: noisy straight walks, some
    agents first seen at frame 2 or 5, as ``write_split`` makes them."""
    from trajnetplusplusbaselines_torch.data.rows import TrackRow

    scenes, ped = [], 0
    for sid in range(n_scenes):
        n = int(rng.integers(lo, hi + 1))
        xy = (rng.uniform(-4, 4, size=(n, 2)) + rng.normal(scale=0.4, size=(n, 2))
              * np.arange(9)[:, None, None] + rng.normal(scale=0.02, size=(9, n, 2)).cumsum(0))
        firsts = [0] + [int(rng.choice([0, 0, 0, 2, 5])) for _ in range(n - 1)]
        scenes.append([[TrackRow(1000 * sid + 10 * f, ped + j + 1, float(xy[f, j, 0]),
                                 float(xy[f, j, 1])) for f in range(first, 9)]
                       for j, first in enumerate(firsts)])
        ped += n
    return scenes


def outputs_diff(got, want) -> float:
    """Largest absolute difference between two lists of predictor outputs."""
    return max(float(np.abs(np.asarray(g[0][k]) - np.asarray(w[0][k])).max(initial=0.0))
               for g, w in zip(got, want) for k in (0, 1))


def classical_phase(dev, rng, card, profile_dir=None) -> dict:
    """Phase 9: the classical predictors (no kernel of the port; f64).

    (a) at each of CLASSICAL_BUCKETS, the folded KF, SF and CV on the card
        against the port's own run of the same inputs on the CPU: the KF's
        fitted (Q, R, mu0, Sigma0) and smoothed last states within KF_RTOL
        of the largest of each, F F^T = Q of the card's own factors, and
        its samples given the CPU's factors and normals within
        KF_SAMPLE_ATOL_M; SF positions within SF_ATOL_M; CV bit-exact;
    (b) ``classical_cli.main([... "--cv", "--kf", "--sf", "--orca",
        "--device", "cuda"])`` on ``write_split``'s 300 scenes (one of 140
        agents): six prediction directories, every scene scored finite,
        the written CV primaries the numpy CV of the observations (0.01 m
        rounding), no launch of the port's kernels, each predictor's wall
        time;
    (c) the times (CUDA events after warm-up): each folded
        ``predict_dataset`` (the CLI's predictor objects) at the buckets in
        scenes/s, the per-scene ``__call__`` over CLASSICAL_PER_SCENE scenes
        for contrast, and ORCA's host time per scene; under ``--profile``
        the device events of one folded KF fit and one SF bucket.
    Every line carries the card's name and power limit."""
    from types import SimpleNamespace

    from trajnetplusplusbaselines_torch.evaluator import classical_cli
    from trajnetplusplusbaselines_torch.models.classical import (constant_velocity, kalman,
                                                                  orca, socialforce)

    start = time.perf_counter()
    cpu = torch.device("cpu")
    if profile_dir is not None:
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
    cli_args = SimpleNamespace(kf=True, sf=True, orca=True, cv=True, modes=1, pred_length=12,
                               obs_length=9, device=dev)
    predictors = classical_cli.build_predictors(cli_args)
    rows = {}
    for s, lo, hi in CLASSICAL_BUCKETS:
        scenes = classical_scenes(rng, s, lo, hi)
        # (a) KF: the fit, the factors, the sampler
        ys, mask = (np.concatenate(x) for x in zip(*(kalman.scene_tracks(p) for p in scenes)))
        ys_c, mask_c = torch.from_numpy(ys), torch.from_numpy(mask)
        params_c, last_c = kalman.kf_fit(ys_c, mask_c)
        params_d, last_d = kalman.kf_fit(ys_c.to(dev), mask_c.to(dev))
        kf_err = {}
        for name, d, c in zip((*kalman.KFParams._fields, "x_last"), (*params_d, last_d),
                              (*params_c, last_c)):
            kf_err[name] = float((d.cpu() - c).abs().max() / c.abs().max())
            if not kf_err[name] <= KF_RTOL:
                raise AssertionError(f"KF {name} on the card differs from the CPU's by "
                                     f"{kf_err[name]} relative at S={s}")
        q_factor = kalman.psd_factor(params_d.q)
        factor_err = float(((q_factor @ q_factor.mT - params_d.q).abs().max()
                            / params_d.q.abs().max()).cpu())
        if not factor_err <= 1e-12:
            raise AssertionError(f"the card's F F^T differs from Q by {factor_err} relative")
        factors = kalman.psd_factor(params_c.q), kalman.psd_factor(params_c.r)
        normals = torch.randn(len(ys), kalman.N_SAMPLES, 12, 6, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(s))
        sample_c = kalman.kf_sample(last_c, *factors, normals)
        sample_d = kalman.kf_sample(last_d, *(f.to(dev) for f in factors), normals.to(dev))
        sample_err = float((sample_d.cpu() - sample_c).abs().max())
        if not sample_err <= KF_SAMPLE_ATOL_M:
            raise AssertionError(f"KF samples differ from the CPU's by {sample_err} m at S={s}")
        # SF and CV, folded, card against CPU
        sf_err = outputs_diff(socialforce.predict_dataset(scenes, device=dev),
                              socialforce.predict_dataset(scenes, device=cpu))
        if not sf_err <= SF_ATOL_M:
            raise AssertionError(f"SF positions differ from the CPU's by {sf_err} m at S={s}")
        cv_d = constant_velocity.predict_dataset(scenes, device=dev)
        cv_c = constant_velocity.predict_dataset(scenes, device=cpu)
        if not all(np.array_equal(g[0][k], w[0][k]) for g, w in zip(cv_d, cv_c) for k in (0, 1)):
            raise AssertionError(f"CV on the card is not the CPU's, bit for bit, at S={s}")

        # (c) folded and per-scene times through the CLI's predictor objects
        times = {}
        for name in ("kf", "sf", "cv"):
            pred = predictors[name + "_modes1"]
            ms = time_ms(lambda: pred.predict_dataset(scenes, None, cli_args),
                         reps=CLASSICAL_FOLD_REPS, warmup=1)
            times[name] = {"fold_ms": ms, "fold_scenes_per_s": s / ms * 1e3}
        if (s, lo, hi) == CLASSICAL_BUCKETS[0]:
            few = scenes[:CLASSICAL_PER_SCENE]
            for name in ("kf", "sf", "cv"):
                pred = predictors[name + "_modes1"]
                for paths in few[:2]:  # warm-up
                    pred(paths, None)
                ms = time_ms(lambda: [pred(paths, None) for paths in few], reps=1, warmup=0)
                times[name]["per_scene_ms"] = ms / len(few)
                times[name]["per_scene_scenes_per_s"] = len(few) / ms * 1e3
            times["orca"] = {"host_ms_per_scene": host_ms(
                lambda: [predictors["orca_modes1"](paths, None) for paths in few],
                reps=1, warmup=1) / len(few)}
        rows[(s, lo, hi)] = times
        say("classical_fold", s=s, agents=[lo, hi], kf_tracks=len(ys), kf_rel_err=kf_err,
            kf_factor_rel_err=factor_err, kf_sample_err_m=sample_err, sf_max_err_m=sf_err,
            cv_bit_exact=True, times=times, card=card)

        if profile_dir is not None:
            ys_d, mask_d = ys_c.to(dev), mask_c.to(dev)
            say("profile_trace", what=f"classical KF fit {len(ys)} tracks", card=card,
                **profiled(lambda: kalman.kf_fit(ys_d, mask_d), 1,
                           Path(profile_dir) / f"classical_kf_fit_{s}.txt", kernel=""))
            state = torch.from_numpy(socialforce.pack_bucket(
                [socialforce.initial_state(p) for p in scenes], hi, 0.5)).to(dev)
            say("profile_trace", what=f"classical SF bucket S={s} A={hi}", card=card,
                **profiled(lambda: socialforce.simulate(state, 96, 1.0 / 20, 2.1, 0.3), 1,
                           Path(profile_dir) / f"classical_sf_bucket_{s}.txt", kernel=""))

    # (b) the CLI on the card: predict, write, evaluate all six
    cwd = os.getcwd()
    wall = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            observed = write_split("DATA_BLOCK/synth_classical", rng)
            build = classical_cli.build_predictors

            def timed_predictors(args):
                built = build(args)
                for name, pred in built.items():
                    def fold(scenes, goals, args, _fold=pred.predict_dataset, _name=name):
                        t0 = time.perf_counter()
                        out = _fold(scenes, goals, args)
                        torch.cuda.synchronize()
                        wall[_name] = time.perf_counter() - t0
                        return out
                    pred.predict_dataset = fold
                return built

            counters = Launches()
            counters.zero()
            t0 = time.perf_counter()
            with mock.patch.object(classical_cli, "build_predictors", timed_predictors):
                table = classical_cli.main(["--path", "synth_classical", "--cv", "--kf", "--sf",
                                            "--orca", "--device", DEVICE])
            cli_s = time.perf_counter() - t0
            launches = counters.read({"fused_dlstm_step": 0, "directional_grid": 0}, add=False)
            names = [m + "_modes1" for m in CLASSICAL_MODELS]
            written_dirs = sorted(os.listdir("DATA_BLOCK/synth_classical/test_pred"))
            if written_dirs != sorted(names) or sorted(wall) != sorted(names):
                raise AssertionError(f"classical_cli wrote {written_dirs}, timed {sorted(wall)}")
            scores = {}
            for name in names:
                overall = table.results[name][32:40]
                if overall[0] != len(observed) or not np.isfinite(overall[1:3]).all():
                    raise AssertionError(f"{name} scored {overall}")
                scores[name] = overall[1:3]
            written = {}
            with open("DATA_BLOCK/synth_classical/test_pred/cv_modes1/synth.ndjson") as f:
                for line in f:
                    track = json.loads(line).get("track")
                    if track is not None:
                        written.setdefault((track["scene_id"], track["p"]), []).append(
                            (track["x"], track["y"]))
            cv_err = 0.0
            for sid, (primary, xy) in enumerate(observed):
                want = xy[-1, 0] + np.arange(1, 13)[:, None] * (xy[-1, 0] - xy[-2, 0])
                cv_err = max(cv_err, float(np.abs(np.array(written[(sid, primary)]) - want).max()))
            if not cv_err <= 0.005 + 1e-9:  # the writer rounds to 0.01 m
                raise AssertionError(f"written CV primaries differ from numpy CV by {cv_err} m")
        finally:
            os.chdir(cwd)
    say("classical_cli", scenes=len(observed), biggest_scene=max(xy.shape[1] for _, xy in observed),
        cli_seconds=cli_s, predict_seconds=wall, launches=launches, ade_fde=scores,
        cv_written_err_m=cv_err, card=card)
    first = rows[CLASSICAL_BUCKETS[0]]
    seconds = time.perf_counter() - start
    print("Classical  " + "  ".join(
        f"{name} {first[name]['fold_scenes_per_s']:.0f} scenes/s folded, "
        f"{first[name]['per_scene_scenes_per_s']:.1f} per scene" for name in ("kf", "sf", "cv"))
        + f"  orca {first['orca']['host_ms_per_scene']:.2f} ms/scene"
        + f"  CLI {cli_s:.1f} s  phase {seconds:.1f} s  ({card})", flush=True)
    return {"rows": rows, "cli_seconds": cli_s, "seconds": seconds}


# ------------------------------------------------------------------ phase 11
def parallel_split(rng):
    """Phase 11's data, in the working directory: phase 6's split
    (``DATA_BLOCK/synth_par``) and a split of three test datasets of
    ``PARALLEL_SERVE``'s sizes (``DATA_BLOCK/synth_serve``).  Returns each
    serve dataset's observed scenes, by name."""
    import shutil

    n_train, n_val, n_test = PARALLEL_SPLIT
    root = "DATA_BLOCK/synth_par"
    write_split(root, rng, n_scenes=n_train, big=None, observed_only=(), full=("train",))
    write_split(root, rng, n_scenes=n_val, big=None, observed_only=(), full=("val",))
    write_split(root, rng, n_scenes=n_test, big=None)
    served = {}
    for name, n in PARALLEL_SERVE:
        served[name] = write_split("DATA_BLOCK/tmp_" + name, rng, n_scenes=n, big=None)
        for sub in ("test", "test_private"):
            os.makedirs(f"DATA_BLOCK/synth_serve/{sub}", exist_ok=True)
            os.replace(f"DATA_BLOCK/tmp_{name}/{sub}/synth.ndjson",
                       f"DATA_BLOCK/synth_serve/{sub}/{name}.ndjson")
        shutil.rmtree("DATA_BLOCK/tmp_" + name)
    return served


def logged_losses(losses, n_scenes) -> np.ndarray:
    """The losses a trainer's log records of an epoch's per-batch
    ``losses``: those of every tenth batch ("train") and the epoch's
    ("train-epoch", the sum over the scenes)."""
    return np.append(losses[9::10], losses.sum() / n_scenes)


def relative(got, want) -> float:
    """The largest relative difference of ``got`` from ``want``."""
    return float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))


def parallel_batch(dev):
    """The batch of phase 11's sharded train steps: S=8, A=8 at a fixed seed,
    every slot real, zero goals."""
    from trajnetplusplusbaselines_torch.trainers.common import Batch

    xy, mask, scene = train_inputs(np.random.default_rng(5), TRAIN_BATCH, 8, dev)
    return Batch(xy, mask, scene, torch.zeros_like(xy[0]),
                 torch.ones(xy.shape[1:3], dtype=torch.bool, device=dev))


def first_step_grads(mesh, dev):
    """The gradient of every leaf after one ``make_sharded_train_step`` step
    of the seed-0 flagship on ``parallel_batch`` (``mesh`` None: one
    process), full leaves, by path, as numpy; and the step's loss."""
    from trajnetplusplusbaselines_torch.parallel import make_sharded_train_step
    from trajnetplusplusbaselines_torch.parallel.mesh import param_shardings, tree_map_with_path
    from trajnetplusplusbaselines_torch.trainers.common import make_optimizer, param_items

    model = flagship_model()
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    step, place_batch, place_params = make_sharded_train_step(model, make_optimizer, mesh,
                                                              batch_size=TRAIN_BATCH)
    b = parallel_batch(dev)
    placed, _, loss = step(place_params(params), None,
                           *place_batch(b.xy, b.mask, b.goals, b.slot_mask, b.scene_mask))
    split = param_shardings(mesh, params) if mesh is not None else {}
    grads = {}
    tree_map_with_path(lambda path, leaf: grads.__setitem__(path, (
        mesh.gather_columns(leaf.grad, autograd=False) if path in split and split[path].split
        else leaf.grad).cpu().numpy()), placed)
    paths = sorted(p for p, _ in param_items(params))
    if sorted(grads) != paths:
        raise AssertionError(f"the sharded step's leaves {sorted(grads)} != {paths}")
    return grads, float(loss)


def flagship_model():
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    return LSTM(pool=GridBasedPooling(type_="directional", hidden_dim=128, cell_side=CELL_SIDE,
                                      n=N, out_dim=256), embedding_dim=64, hidden_dim=128)


def rank_main(outdir) -> int:
    """One rank of phase 11, started by ``torch.distributed.run`` on the
    card's machine (``--rank-run OUTDIR``): the runs of phase 11 (a)-(c) in
    this rank, each with the launch counters zeroed just before and read
    just after, pickled to ``OUTDIR/rank<r>.pkl``."""
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli
    from trajnetplusplusbaselines_torch.ops.cuda import build
    from trajnetplusplusbaselines_torch.parallel import make_mesh, make_sharded_rollout
    from trajnetplusplusbaselines_torch.parallel.multihost import (collective_route,
                                                                   init_from_env, process_info)
    from trajnetplusplusbaselines_torch.trainers import ensemble
    from trajnetplusplusbaselines_torch.trainers import lstm as train_cli

    dev = init_from_env(DEVICE)
    rank, world = process_info()
    build.load_library()  # built by the parent process
    os.chdir(outdir)
    counters = Launches()
    out = {"rank": rank, "world": world, "device": str(dev), "route": collective_route(dev)}

    def counted(fn):
        """(fn(), the launches it made, its seconds)."""
        counters.zero()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, counters.current(), time.perf_counter() - t0

    batch = parallel_batch(dev)
    for name, dp, tp in (("dp", 2, 1), ("tp", 1, 2)):
        trainer, launches, seconds = counted(lambda: train_cli.main(argv=flagship_argv(
            "synth_par", "--epochs", "1", "--seed", "0", "--dp", str(dp), "--tp", str(tp),
            "-o", name)))
        close_log()
        (_, train_res), (_, val_res) = trainer._resident.values()
        step_ms = time_ms(lambda: trainer.train_step(*batch), reps=PARALLEL_TIMED_REPS,
                          warmup=2)
        grads, loss = first_step_grads(make_mesh(world, dp, tp, dev), dev)
        out[name] = {"losses": trainer.epoch_losses, "launches": launches, "seconds": seconds,
                     "train_batches": batches_per_epoch(train_res),
                     "val_batches": batches_per_epoch(val_res), "step_ms": step_ms,
                     "grads": grads if rank == 0 else None, "step_loss": loss}

    ens, launches, seconds = counted(lambda: ensemble.main(argv=flagship_argv(
        "synth_par", "--epochs", "1", "--seeds", *PARALLEL_SEEDS, "--dp", "2")))
    close_log()
    (_, train_res), (_, val_res) = ens._resident.values()
    out["ensemble"] = {"losses": ens.epoch_losses, "launches": launches, "seconds": seconds,
                       "train_batches": batches_per_epoch(train_res),
                       "val_batches": batches_per_epoch(val_res)}

    s, a = PARALLEL_ROLLOUT
    xy, mask = rollout_inputs(np.random.default_rng(11), s, a, dev)
    model = flagship_model()
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    rollout, place_batch = make_sharded_rollout(model, make_mesh(world, world, 1, dev))
    placed = place_batch(xy.cpu().numpy(), mask.cpu().numpy(), np.zeros((s, a, 2), np.float32),
                         np.ones((s, a), bool))
    (_, pred, valid), launches, seconds = counted(lambda: rollout(params, *placed))
    out["rollout"] = {"pred": pred.cpu().numpy(), "valid": valid.cpu().numpy(),
                      "launches": launches, "local_scenes": int(placed[0].shape[1])}

    table, launches, seconds = counted(lambda: lstm_cli.main(
        ["--path", "synth_serve", "--output", "p6.pkl", "--device", DEVICE,
         "--batch_scenes", str(BATCH_SCENES)]))
    out["serve"] = {"launches": launches, "seconds": seconds,
                    "results": None if table is None else table.results}
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def launch_ranks(outdir, log_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2
    chip_smoke.py --rank-run OUTDIR``, waited on for ``PARALLEL_TIMEOUT_S``;
    the launcher and its ranks (one session) are killed after it.  Returns
    its seconds."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", str(REPO / "chip_smoke.py"), "--rank-run", str(outdir)]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=outdir, env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=PARALLEL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
            rc = None
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"the two ranks {'timed out' if rc is None else f'exited {rc}'}:"
                             f"\n{tail}")
    return time.perf_counter() - t0


def parallel_phase(dev, rng, card, p6_predictor) -> dict:
    """Phase 11 (see the module's docstring): two ranks on the card, against
    one process.  Returns the launch counts of rank 0's runs and this
    process's, by kernel, and the phase's seconds."""
    from trajnetplusplusbaselines_torch.evaluator import lstm_cli
    from trajnetplusplusbaselines_torch.evaluator.learned import bucket_plan
    from trajnetplusplusbaselines_torch.parallel.multihost import shard_items
    from trajnetplusplusbaselines_torch.tools import collision_gate, profile_train
    from trajnetplusplusbaselines_torch.trainers import ensemble
    from trajnetplusplusbaselines_torch.trainers import lstm as train_cli
    from trajnetplusplusbaselines_torch.trainers.common import step_lr
    from trajnetplusplusbaselines_torch.utils.checkpoint import save_predictor
    from torch.utils._pytree import tree_map

    t_phase = time.perf_counter()
    counters = Launches()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            served = parallel_split(rng)
            save_predictor(p6_predictor, "p6.pkl")
            ranks_s = launch_ranks(tmp, os.path.join(tmp, "ranks.log"))
            ranks = []
            for r in range(2):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))

            # (a) one process: the same runs, the reference
            batch = parallel_batch(dev)
            counters.zero()
            one = train_cli.main(argv=flagship_argv("synth_par", "--epochs", "1", "--seed", "0",
                                                    "-o", "one"))
            close_log()
            (train_ds, train_res), (_, val_res) = one._resident.values()
            train_batches, val_batches = map(batches_per_epoch, (train_res, val_res))
            n_train = len(train_ds)
            counters.read({"directional_grid": 19 * train_batches,
                           "fused_dlstm_step": 2 * 19 * val_batches,
                           **fused_train_launches(19 * train_batches, train_batches,
                                                  val_losses=2 * val_batches)})
            one_ms = time_ms(lambda: one.train_step(*batch), reps=PARALLEL_TIMED_REPS, warmup=2)
            want_grads, want_loss = first_step_grads(None, dev)
            figures = {}
            # the same epoch from params one ulp away: one process's own f32
            # sensitivity over the epoch, beside which a sharded run's drift
            # (its sums in another order) is read
            nudged = train_cli.Trainer(
                one.model, tree_map(lambda x: torch.nextafter(x, torch.full_like(x, math.inf)),
                                    one.model.init_params(torch.Generator().manual_seed(0),
                                                          device=dev)),
                step_lr(1e-3, 10), augment=False, seed=0)
            nudged.train(train_ds, 0)
            envelope = relative(nudged.epoch_losses, one.epoch_losses)
            for name in ("dp", "tp"):
                loss_rel = grad_share = drift = 0.0
                for r, run in enumerate(ranks):
                    got = run[name]
                    if (got["train_batches"], got["val_batches"]) != (train_batches, val_batches):
                        raise AssertionError(f"{name} rank {r} ran {got['train_batches']} + "
                                             f"{got['val_batches']} batches")
                    want = {"directional_grid": 19 * train_batches,
                            "fused_dlstm_step": 2 * 19 * val_batches,
                            **fused_train_launches(19 * train_batches, train_batches,
                                                   val_losses=2 * val_batches)}
                    if {k: got["launches"][k] for k in want} != want:
                        raise AssertionError(f"{name} rank {r} launched {got['launches']}, "
                                             f"expected {want} (19 grid a train step)")
                    if got["losses"].shape != one.epoch_losses.shape:
                        raise AssertionError(f"{name} rank {r} logged {got['losses'].shape} "
                                             f"losses")
                    rel = relative(logged_losses(got["losses"], n_train),
                                   logged_losses(one.epoch_losses, n_train))
                    if not rel <= PARALLEL_LOSS_RTOL:
                        raise AssertionError(f"{name} rank {r}: logged losses differ by {rel} "
                                             f"relative")
                    loss_rel = max(loss_rel, rel)
                    drift = max(drift, relative(got["losses"], one.epoch_losses))
                grads = ranks[0][name]["grads"]
                for path, w in want_grads.items():
                    scale = float(np.abs(w).max())
                    err = float(np.abs(grads[path] - w).max())
                    if err > PARALLEL_GRAD_ATOL_SHARE * max(scale, 1e-30):
                        raise AssertionError(f"{name}: the gradient of {path} differs by {err} "
                                             f"of {scale}")
                    grad_share = max(grad_share, err / max(scale, 1e-30))
                figures[name] = {
                    "logged_loss_max_rel_err": loss_rel, "batch_loss_max_rel_err": drift,
                    "one_ulp_batch_loss_max_rel_err": envelope, "grad_max_err_share": grad_share,
                    "step_loss": ranks[0][name]["step_loss"], "one_step_loss": want_loss,
                    "launches_per_rank": [run[name]["launches"] for run in ranks],
                    "train_batches": train_batches, "val_batches": val_batches,
                    "step_ms": [run[name]["step_ms"] for run in ranks], "one_step_ms": one_ms,
                    "cli_seconds": [run[name]["seconds"] for run in ranks]}
                say("parallel_train", mesh=name, route=ranks[0]["route"], **figures[name],
                    note=NOT_SCALING, card=card)
                print(f"Parallel --{name} 2: {min(figures[name]['step_ms']):.3f} ms/step "
                      f"against {one_ms:.3f} one process ({NOT_SCALING}; {card})", flush=True)

            # (b) the ensemble at --dp 2 against one process
            counters.zero()
            ens = ensemble.main(argv=flagship_argv("synth_par", "--epochs", "1", "--seeds",
                                                   *PARALLEL_SEEDS, "-o", "e"))
            close_log()
            steps = train_batches + val_batches
            counters.read({"directional_grid": 19 * steps})
            ens_rel = ens_drift = 0.0
            for r, run in enumerate(ranks):
                got = run["ensemble"]
                if got["launches"]["directional_grid"] != 19 * steps or \
                        got["launches"]["fused_dlstm_step"]:
                    raise AssertionError(f"ensemble rank {r} launched {got['launches']}, "
                                         f"expected 19 grid launches in each of {steps} steps")
                if got["losses"].shape != ens.epoch_losses.shape:
                    raise AssertionError(f"ensemble rank {r} logged {got['losses'].shape}")
                # the members' losses as the ensemble logs them: each one's epoch
                rel = relative(got["losses"].sum(axis=1), ens.epoch_losses.sum(axis=1))
                if not rel <= PARALLEL_LOSS_RTOL:
                    raise AssertionError(f"ensemble rank {r}: member losses differ by {rel} "
                                         f"relative")
                ens_rel = max(ens_rel, rel)
                ens_drift = max(ens_drift, relative(got["losses"], ens.epoch_losses))
            say("parallel_ensemble", members=len(PARALLEL_SEEDS), member_loss_max_rel_err=ens_rel,
                batch_loss_max_rel_err=ens_drift,
                launches_per_rank=[run["ensemble"]["launches"] for run in ranks],
                steps=steps, cli_seconds=[run["ensemble"]["seconds"] for run in ranks],
                note=NOT_SCALING, card=card)

            # (c) the sharded rollout, and lstm_cli over two ranks
            s, a = PARALLEL_ROLLOUT
            xy, mask = rollout_inputs(np.random.default_rng(11), s, a, dev)
            model = flagship_model()
            params = model.init_params(torch.Generator().manual_seed(0), device=dev)
            counters.zero()
            with torch.no_grad():
                _, pred, valid = model.forward(params, xy, mask, n_predict=12)
            counters.read({"fused_dlstm_step": 19})
            pos_err = 0.0
            for r, run in enumerate(ranks):
                got = run["rollout"]
                if got["launches"]["fused_dlstm_step"] != 19 or got["local_scenes"] != s // 2:
                    raise AssertionError(f"rank {r}'s rollout of {got['local_scenes']} scenes "
                                         f"launched {got['launches']}, not 19 fused steps")
                if not np.array_equal(got["valid"], valid.cpu().numpy()):
                    raise AssertionError(f"rank {r}'s sharded rollout validity differs")
                err = float(np.abs(got["pred"] - pred.cpu().numpy())[got["valid"]].max())
                if not err <= PARALLEL_POSITION_ATOL:
                    raise AssertionError(f"rank {r}'s sharded rollout differs by {err} m")
                pos_err = max(pos_err, err)
            names = sorted(served)
            for r, run in enumerate(ranks):
                want = 19 * sum(len(bucket_plan([xy.shape[1] for _, xy in served[d]],
                                                BATCH_SCENES))
                                for d in shard_items(names, r, 2))
                if run["serve"]["launches"]["fused_dlstm_step"] != want:
                    raise AssertionError(f"rank {r} served with {run['serve']['launches']}, "
                                         f"expected {want} fused launches")
            two_pred = "DATA_BLOCK/synth_serve/test_pred/p6_modes1"
            two_files = {}
            for name in names:
                with open(f"{two_pred}/{name}.ndjson") as f:
                    two_files[name] = f.read().splitlines()
            os.rename("DATA_BLOCK/synth_serve/test_pred", "two_ranks_pred")
            counters.zero()
            table = lstm_cli.main(["--path", "synth_serve", "--output", "p6.pkl", "--device",
                                   DEVICE, "--batch_scenes", str(BATCH_SCENES)])
            one_launches = counters.read({"fused_dlstm_step": 19 * sum(
                len(bucket_plan([xy.shape[1] for _, xy in served[d]], BATCH_SCENES))
                for d in names)})
            for name in names:
                with open(f"{two_pred}/{name}.ndjson") as f:
                    if f.read().splitlines() != two_files[name]:
                        raise AssertionError(f"two ranks wrote {name} unlike one process")
            if ranks[1]["serve"]["results"] is not None or \
                    ranks[0]["serve"]["results"] != table.results:
                raise AssertionError("the two ranks' scores are not rank 0's, once, as one "
                                     "process scores")
            say("parallel_serve", rollout_scenes=s, rollout_agents=a,
                rollout_max_position_err_m=pos_err,
                rollout_launches_per_rank=[run["rollout"]["launches"] for run in ranks],
                datasets={d: len(served[d]) for d in names},
                serve_launches_per_rank=[run["serve"]["launches"] for run in ranks],
                one_process_launches=one_launches, files_equal=True, scored_by=[0],
                serve_seconds=[run["serve"]["seconds"] for run in ranks], card=card)

            # (d) collision_gate on the card against the CPU, on phase 6's pickle
            frames = list(range(0, 210, 10))
            for sub in ("test", "test_private"):
                with open(f"DATA_BLOCK/synth_par/{sub}/collision_test.ndjson", "w") as f:
                    f.write(json.dumps({"scene": {"id": 0, "p": 1, "s": 0, "e": 200,
                                                  "fps": 2.5, "tag": [2, []]}}) + "\n")
                    for p, (x0, y0, vy) in ((1, (0.0, 0.0, 0.4)), (2, (0.05, 6.4, -0.4))):
                        for t, fr in enumerate(frames):
                            f.write(json.dumps({"track": {"f": fr, "p": p, "x": x0,
                                                          "y": round(y0 + vy * t, 2)}}) + "\n")
            counters.zero()
            gate_card = collision_gate.main(["--path", "synth_par", "--output", "p6.pkl",
                                             "--device", DEVICE])
            gate_launches = counters.read({"fused_dlstm_step": 19})
            os.rename("DATA_BLOCK/synth_par/gate_pred", "gate_pred_card")
            os.remove("DATA_BLOCK/synth_par/collision_gate.json")
            gate_cpu = collision_gate.main(["--path", "synth_par", "--output", "p6.pkl",
                                            "--device", "cpu"])
            if gate_card != gate_cpu:
                raise AssertionError(f"collision_gate on the card {gate_card}, on the CPU "
                                     f"{gate_cpu}")
            say("parallel_gate", gate=gate_card, launches=gate_launches, cpu=gate_cpu, card=card)

            # (e) profile_train on the card: the trace holds the grid stage
            counters.zero()
            trace = profile_train.main(["--device", DEVICE, "--steps", "2",
                                        "--trace_dir", "profile_trace"])
            profile_launches = counters.read({"directional_grid": 19 * 3,
                                              **fused_train_launches(19 * 3, 3, losses=0)})
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            kernel_events = sum(GRID_KERNEL in e.get("name", "") for e in events)
            if kernel_events == 0:
                raise AssertionError(f"the profile_train trace holds no {GRID_KERNEL}")
            say("parallel_profile", trace_events=len(events),
                directional_grid_kernel_events=kernel_events, launches=profile_launches,
                card=card)
        finally:
            os.chdir(cwd)
    seconds = time.perf_counter() - t_phase
    say("parallel", seconds=seconds, ranks_seconds=ranks_s, card=card)
    rank0 = {k: sum(ranks[0][run]["launches"][k] for run in ("dp", "tp", "ensemble", "rollout",
                                                               "serve"))
             for k in ("fused_dlstm_step", "directional_grid")}
    return {"launches": rank0, "totals": counters.totals, "seconds": seconds}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT_DIR", default=None,
                        help="also run the profile phase, writing its tables here")
    parser.add_argument("--rank-run", metavar="OUT_DIR", default=None,
                        help="run as one rank of phase 11 under torch.distributed.run")
    opts = parser.parse_args()
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 2
    if not (REPO / "trajnetplusplusbaselines_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    if opts.rank_run:
        return rank_main(opts.rank_run)
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
    install_graph_counting()  # what graph replays launch, read from the graphs

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
        along = along_reading(params, xy, mask, pred, valid, model)
        along_err = along["max_position_err_m"]
        if along_err > ALONG_ATOL:
            raise AssertionError(f"rollout positions along the fused rollout differ by "
                                 f"{along_err} m at S={s} A={a}")
        times[(s, a)] = rollout_times(s, a)
        say("rollout", s=s, a=a, launches=launches, max_position_err_m=pos_err,
            along_max_position_err_m=along_err, along_seconds=along["along_seconds"],
            **times[(s, a)])

    # ---- 4b: the fused step's device time, bound and library yardstick
    device = device_phase(dev, np.random.default_rng(2), model, params,
                          times[ROLLOUTS[0]]["rollout_ms"])

    # ---- 4c: where the fused rollout parts from the plain one, on the
    # bench's rollout cell's inputs at five seeds
    rollout_parting_phase(dev, card)

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

    # ---- 6b: the train step as CUDA graphs against eager steps
    graph = graph_phase(dev, np.random.default_rng(13), card)

    # ---- 6c: the fused train route: its kernels, its gradients against the
    # grid route's, its launches a step, its train step against the grid route's
    fused_train = fused_train_phase(dev, np.random.default_rng(14), card)

    # ---- 7: pools: every interaction module, rolled out, trained and served
    pools = pools_phase(dev, rng)

    # ---- 8: the SGAN and the VAE: folded rollouts, train steps, both trainers
    generative = generative_phase(dev, rng, card)

    # ---- 9: the classical predictors: folded on the card, and classical_cli
    classical = classical_phase(dev, np.random.default_rng(9), card, opts.profile)

    # ---- 10: the rest of training: the bf16 grid stage, --bf16, --obs_dropout,
    # the seed ensemble and --remat
    t10 = time.perf_counter()
    bf16_grid = bf16_grid_phase(dev, np.random.default_rng(10), card)
    options = training_options_phase(dev, np.random.default_rng(11), card)
    phase10_s = time.perf_counter() - t10

    # ---- 11: two ranks on the card: --dp / --tp training, the ensemble at
    # --dp 2, the sharded rollout and lstm_cli over two ranks; collision_gate
    # and profile_train
    parallel = parallel_phase(dev, np.random.default_rng(12), card, train["predictor"])

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

        # phase 8's models: folded rollouts and train steps at batch 8
        from trajnetplusplusbaselines_torch.trainers import sgan as sgan_trainer
        from trajnetplusplusbaselines_torch.trainers import vae as vae_trainer

        b_xy, b_mask, b_scene = train_inputs(rng, TRAIN_BATCH, 8, dev)
        batch = Batch(b_xy, b_mask, b_scene, torch.zeros_like(b_xy[0]), b_mask.any(dim=0))
        for kind, gen_model in generative_models().items():
            gen_params = gen_model.init_params(torch.Generator().manual_seed(11), device=dev)
            for s, a in GEN_ROLLOUTS:
                xy, mask = rollout_inputs(rng, s, a, dev)
                draws = (torch.randn(GEN_MODES, GEN_NOISE_DIM) if kind == "sgan"
                         else torch.randn(GEN_MODES, s, a, GEN_LATENT)).to(dev)
                say("profile_trace", what=f"{kind} rollout k={GEN_MODES} S={s} A={a}", card=card,
                    **profiled(lambda: generative_rollout(kind, gen_model, gen_params, xy, mask,
                                                          draws), 5,
                               out / f"generative_{kind}_{s}x{a}.txt"))
            if kind == "sgan":
                trainer = sgan_trainer.Trainer(gen_model, gen_params, step_lr(1e-3, 10),
                                               step_lr(1e-3, 10), criterion="pred")
                steps = {f"{kind}_{t}": (lambda t=t: trainer.train_step(*batch, step_type=t))
                         for t in ("g", "d")}
            else:
                trainer = vae_trainer.Trainer(gen_model, gen_params, step_lr(1e-3, 10))
                steps = {kind: lambda: trainer.train_step(*batch)}
            for name, step in steps.items():
                say("profile_trace", what=f"{name} train_step S={TRAIN_BATCH} A=8", card=card,
                    **profiled(step, 5, out / f"generative_{name}_train_step.txt",
                               kernel="directional_grid_kernel"))

    say("seconds", script=time.perf_counter() - started, graphs=graph["figures"]["seconds"],
        fused_train=fused_train["figures"]["seconds"],
        classical=classical["seconds"],
        training_options=phase10_s, parallel=parallel["seconds"], card=card)
    main_s, main_a = ROLLOUTS[0]
    main_device = device["shapes"][(main_s, main_a)]
    train_grid = device["grid"][(TRAIN_BATCH, 8)]
    csrc = "trajnetplusplusbaselines_torch/csrc/"
    runs = {"serve": main_launches, "train": train["launches"], "graphs": graph["launches"],
            "fused_train": fused_train["launches"], "pools": pools["launches"],
            "generative": generative["launches"], **options["launches"],
            "parallel_rank0": parallel["launches"], "parallel": parallel["totals"]}
    by_path = {name: {run: counts.get(name, 0) for run, counts in runs.items()}
               for name in COUNTER_NAMES}
    bf16_row = bf16_grid["rows"][(TRAIN_BATCH, 8)]
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
    }, {
        # the grid stage's bf16 instantiation, launched by a --bf16 train step
        "name": "directional_grid_bf16",
        "route": "cuda",
        "source": csrc + "directional_grid.cu",
        "replaces": "trajnetplusplusbaselines_tpu/ops/pallas/fused_step.py:76",
        "launches": sum(by_path["directional_grid_bf16"].values()),
        "launches_by_path": by_path["directional_grid_bf16"],
        "max_abs_err": 0.0,  # bit-exact against the plain bf16 grid, or the phase raised
        "ms": bf16_row["bf16_device_ms"],
        "device_ms": bf16_row["bf16_device_ms"],
        "plain_ms": bf16_grid["plain_ms"],
        "bound_ms": bf16_row["bf16_bound_ms"],
        "bound_by": "bytes",
        "bound_share": bf16_row["bf16_bound_share"],
        "per_call_ms": bf16_grid["per_call_ms"],
        "library_ms": None,
        "shapes": {f"{s}x{a}": row for (s, a), row in bf16_grid["rows"].items()},
    }, *({
        # the fused train route's kernels: the elementwise work of the
        # flagship's rollout under autograd, times at the train step's 64 rows
        "name": name,
        "route": "cuda",
        "source": csrc + "fused_train.cu",
        "replaces": "none: no pallas_call; the step's elementwise ops of "
                    "trajnetplusplusbaselines_tpu/models/lstm.py:114 under jax.grad, which XLA "
                    "fuses",
        "launches": sum(by_path[name].values()),
        "launches_by_path": by_path[name],
        **{key: row[key] for key in ("max_abs_err", "max_rel_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by", "bound_share",
                                     "library_ms", "rows", "bytes")},
    } for name, row in fused_train["figures"]["kernels"].items())]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
