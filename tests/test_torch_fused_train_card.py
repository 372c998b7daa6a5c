"""The fused train route's kernels on the card (``ops/cuda/fused_train.py``).

Each test needs an NVIDIA card and skips without one; this file imports no
jax, so that it runs on the card's machine without the suite's conftest:

    python -m pytest tests/test_torch_fused_train_card.py -m cuda --noconftest -p no:cacheprovider

- each of the six kernels against its plain version, at the train step's
  64 rows, within 1e-6 of each output's largest magnitude (masks equal), on
  the inputs ``chip_smoke.py`` phase 6c draws; ``fused_train_in`` also at
  each of phase 6c's rows and grids (0 to all entries of a row not zero);
  the two cell kernels, which form the step's products themselves, against
  their plain versions run in f64 (the f32 product's own rounding reaches
  the tolerance), also at 8,192 rows, at a row count that is not a multiple
  of a tile and at a narrower and a wider hidden width than the
  flagship's, at every tile they take, each run twice to the same bits;
- each of the six kernels run twice on the same inputs to the same bits;
  ``fused_train_in_backward`` bit-equal to its plain version (NaN, -0.0
  and +0.0 in ``xh``) at phase 6c's further widths and rows;
  ``fused_train_loss`` within 1e-6 of its plain version with
  every scene masked (all zero), one scene, 35 entries and P = 1, at every
  block size phase 6c times; ``fused_train_loss_backward`` bit-equal to its
  plain version, run twice to the same bits, at
  ``chip_smoke.TRAIN_LOSS_BACKWARD_CASES`` and ``TRAIN_KERNEL_SHAPES``, with
  dvals drawn and with every scene masked (all zero), on a ``d_rel`` on 16
  bytes (the float4 path where A % 4 == 0) and 4 bytes past (the scalar
  path);
- a small directional LSTM's loss and gradients on the route against the
  grid route and the plain loss, within 1e-5 of each leaf's largest, with
  the launches a step counted.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from trajnetplusplusbaselines_torch.models.lstm import LSTM
from trajnetplusplusbaselines_torch.ops.cuda import fused_step, fused_train
from trajnetplusplusbaselines_torch.ops.pooling.grid import GridBasedPooling
from trajnetplusplusbaselines_torch.trainers import common
from trajnetplusplusbaselines_torch.trainers.lstm import Trainer


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from trajnetplusplusbaselines_torch.ops.cuda import build

    build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.TRAIN_KERNELS)
def test_kernel_matches_its_plain_version(name):
    dev = _card()
    params = chip_smoke.flagship_model().init_params(torch.Generator().manual_seed(0),
                                                     device=dev)
    args, writes, _ = chip_smoke.train_kernel_case(name, np.random.default_rng(0), 8, 8, dev,
                                                   params)
    before = getattr(fused_train, name).launches
    got = chip_smoke.run_train_kernel(getattr(fused_train, name), args, writes)
    want = chip_smoke.run_train_kernel(getattr(fused_train, name + "_plain"),
                                       chip_smoke.plain_args(name, args), writes)
    torch.cuda.synchronize()
    assert getattr(fused_train, name).launches == before + 1
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            assert err <= chip_smoke.TRAIN_KERNEL_RTOL


CELL_CASES = ([(s, a, 128) for s, a in chip_smoke.TRAIN_KERNEL_SHAPES]
              + list(chip_smoke.TRAIN_CELL_EDGES))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", fused_train.CELL_TILE_ROWS)
@pytest.mark.parametrize("scenes,agents,hidden", CELL_CASES)
@pytest.mark.parametrize("name", ["fused_train_cell", "fused_train_cell_backward"])
def test_cell_kernels_match_their_plain_versions(name, scenes, agents, hidden, tile):
    dev = _card()
    if hidden > 128 and tile != 8:
        pytest.skip("above 128 units a block takes 32 units and 8 rows only")
    params = chip_smoke.flagship_model(hidden).init_params(torch.Generator().manual_seed(0),
                                                           device=dev)
    args, writes, _, _ = chip_smoke.train_cell_case(name, np.random.default_rng(2), scenes,
                                                    agents, dev, params)
    with mock.patch.object(fused_train, "cell_tile_rows", lambda rows, hidden, kernel="": tile):
        runs = [chip_smoke.run_train_kernel(getattr(fused_train, name), args, writes)
                for _ in range(2)]
    wide = [tuple(x.double() if x.is_floating_point() else x for x in v)
            if isinstance(v, tuple) else v.double() if v.is_floating_point() else v
            for v in chip_smoke.plain_args(name, args)]
    want = chip_smoke.run_train_kernel(getattr(fused_train, name + "_plain"), wide, writes)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(*runs))
    row = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    chip_smoke.held_to_plain(name, runs[0], want, row)
    assert row["max_rel_err"] <= chip_smoke.TRAIN_KERNEL_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("steps,rows", chip_smoke.TRAIN_IN_SHAPES)
@pytest.mark.parametrize("agents,nonzeros", chip_smoke.TRAIN_IN_GRIDS)
def test_fused_train_in_matches_its_plain_version_on_every_grid(steps, rows, agents, nonzeros):
    dev = _card()
    params = chip_smoke.flagship_model().init_params(torch.Generator().manual_seed(0),
                                                     device=dev)
    args, writes, _, _ = chip_smoke.train_in_case(np.random.default_rng(1), steps,
                                                  rows // (steps * agents), agents, nonzeros,
                                                  dev, params)
    got = chip_smoke.run_train_kernel(fused_train.fused_train_in, args, writes)
    want = chip_smoke.run_train_kernel(fused_train.fused_train_in_plain, args, writes)
    torch.cuda.synchronize()
    row = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    chip_smoke.held_to_plain("fused_train_in", got, want, row)
    assert row["max_rel_err"] <= chip_smoke.TRAIN_KERNEL_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.TRAIN_KERNELS)
def test_two_runs_give_the_same_bits(name):
    dev = _card()
    params = chip_smoke.flagship_model().init_params(torch.Generator().manual_seed(0),
                                                     device=dev)
    args, writes, _ = chip_smoke.train_kernel_case(name, np.random.default_rng(3), 8, 8, dev,
                                                   params)
    runs = [chip_smoke.run_train_kernel(getattr(fused_train, name), args, writes)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert chip_smoke.bits_equal(*runs)


IN_BACKWARD_CASES = [(19 * 64, 320, 449), *chip_smoke.TRAIN_IN_BACKWARD_EDGES]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,ld", IN_BACKWARD_CASES)
def test_in_backward_gives_the_plain_versions_bits(rows, width, ld):
    dev = _card()
    args, writes, _ = chip_smoke.in_backward_case(np.random.default_rng(4), rows, width, ld, dev)
    got = chip_smoke.run_train_kernel(fused_train.fused_train_in_backward, args, writes)
    want = chip_smoke.run_train_kernel(fused_train.fused_train_in_backward_plain, args, writes)
    torch.cuda.synchronize()
    assert chip_smoke.bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", chip_smoke.LOSS_TIMED_THREADS)
@pytest.mark.parametrize("scenes,agents,steps,masked",
                         [(8, 8, 12, "eighth"), *chip_smoke.TRAIN_LOSS_EDGES])
def test_loss_matches_its_plain_version_at_its_edges(scenes, agents, steps, masked, threads):
    dev = _card()
    args, writes, _ = chip_smoke.loss_case(np.random.default_rng(5), scenes, agents, steps,
                                           masked, dev)
    with mock.patch.object(fused_train, "loss_threads", lambda e: threads):
        runs = [chip_smoke.run_train_kernel(fused_train.fused_train_loss, args, writes)
                for _ in range(2)]
    want = chip_smoke.run_train_kernel(fused_train.fused_train_loss_plain, args, writes)
    torch.cuda.synchronize()
    assert chip_smoke.bits_equal(*runs)
    row = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    chip_smoke.held_to_plain("fused_train_loss", runs[0], want, row)
    assert row["max_rel_err"] <= chip_smoke.TRAIN_KERNEL_RTOL
    if masked == "all":
        assert not any(bool(x.any()) for x in runs[0])


LOSS_BACKWARD_CASES = list(dict.fromkeys(
    [(19, 12, s, a) for s, a in chip_smoke.TRAIN_KERNEL_SHAPES]
    + list(chip_smoke.TRAIN_LOSS_BACKWARD_CASES)))


@pytest.mark.cuda
@pytest.mark.parametrize("scalar", [False, True], ids=["on_16_bytes", "4_bytes_past_16"])
@pytest.mark.parametrize("masked", [False, True], ids=["dvals", "every_scene_masked"])
@pytest.mark.parametrize("t_all,p,s,a", LOSS_BACKWARD_CASES)
def test_loss_backward_gives_the_plain_versions_bits(t_all, p, s, a, masked, scalar):
    dev = _card()
    args, _, _ = chip_smoke.loss_backward_case(np.random.default_rng(6), t_all, p, s, a, dev,
                                               masked)
    wrapper = fused_train.fused_train_loss_backward
    before = wrapper.launches
    runs = []
    for fn in (wrapper, wrapper, fused_train.fused_train_loss_backward_plain):
        buffers = chip_smoke.loss_backward_buffers(args, scalar)
        fn(*buffers)
        runs.append(buffers[3])
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert chip_smoke.bits_equal(runs[:1], runs[1:2])
    assert chip_smoke.bits_equal(runs[:1], runs[2:])
    if masked:
        assert not runs[0].any()


@pytest.mark.cuda
def test_route_matches_the_grid_route_on_the_card():
    dev = _card()
    model = LSTM(pool=GridBasedPooling(type_="directional", hidden_dim=32, cell_side=0.6, n=6,
                                       out_dim=32), embedding_dim=16, hidden_dim=32)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(model, params, common.step_lr(1e-3, 10), batch_size=4, col_wt=2.0,
                      col_distance=3.0)
    xy, mask, scenes = chip_smoke.train_inputs(np.random.default_rng(1), 4, 5, dev)
    kernels = (fused_step.directional_grid, *fused_train.KERNELS)
    before = [k.launches for k in kernels]
    loss, grads = trainer.loss_and_grads(xy, mask, scenes)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [19, 12, 19, 19, 1, 1, 1]
    with mock.patch.object(model, "takes_fused_train", lambda *a, **k: False), \
            mock.patch.object(fused_train, "prediction_loss", chip_smoke.plain_prediction_loss):
        loss_g, grads_g = trainer.loss_and_grads(xy, mask, scenes)
    assert abs(float(loss) - float(loss_g)) <= 1e-5 * max(abs(float(loss_g)), 4.0)
    for g, w in zip(grads, grads_g):
        assert float((g - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)
