"""The fused train route's kernels on the card (``ops/cuda/fused_train.py``).

Each test needs an NVIDIA card and skips without one; this file imports no
jax, so that it runs on the card's machine without the suite's conftest:

    python -m pytest tests/test_torch_fused_train_card.py -m cuda --noconftest -p no:cacheprovider

- each of the six kernels against its plain version, at the train step's
  64 rows, within 1e-6 of each output's largest magnitude (masks equal), on
  the inputs ``chip_smoke.py`` phase 6c draws;
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
    want = chip_smoke.run_train_kernel(getattr(fused_train, name + "_plain"), args, writes)
    torch.cuda.synchronize()
    assert getattr(fused_train, name).launches == before + 1
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
        else:
            err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            assert err <= chip_smoke.TRAIN_KERNEL_RTOL


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
    assert [k.launches - b for k, b in zip(kernels, before)] == [19, 19, 19, 19, 1, 1, 1]
    with mock.patch.object(model, "takes_fused_train", lambda *a, **k: False), \
            mock.patch.object(fused_train, "prediction_loss", chip_smoke.plain_prediction_loss):
        loss_g, grads_g = trainer.loss_and_grads(xy, mask, scenes)
    assert abs(float(loss) - float(loss_g)) <= 1e-5 * max(abs(float(loss_g)), 4.0)
    for g, w in zip(grads, grads_g):
        assert float((g - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)
