"""Profiler hook: a Chrome trace of flagship-model train steps.

Port of ``trajnetplusplusbaselines_tpu/tools/profile_train.py`` on
``torch.profiler``: the model of ``--type`` at the trainer's default widths
(``make_pool(args.type)``; the directional default is the flagship D-LSTM,
whose train step runs the grid stage 19 times), ``--scenes`` x ``--agents``
random-walk scenes, one warm-up step outside the trace, then ``--steps``
train steps (teacher-forced loss, gradients, Adam) traced.  The trace is
written with ``export_chrome_trace`` to ``<trace_dir>/train_steps.json``
(open it in Perfetto or ``chrome://tracing``).  ``--device`` defaults to
``cuda`` and raises where no card is present.

Usage:
    python -m trajnetplusplusbaselines_torch.tools.profile_train \\
        [--type directional] [--trace_dir profile_trace] [--steps 3] [--device cuda]
"""

import argparse
import os

import numpy as np
import torch

TRACE_FILE = "train_steps.json"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--type", default="directional")
    parser.add_argument("--trace_dir", default="profile_trace")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--scenes", type=int, default=64)
    parser.add_argument("--agents", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the train steps (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from ..losses import prediction_loss
    from ..models.lstm import LSTM
    from ..ops.pooling import make_pool
    from ..trainers.common import make_optimizer, param_items

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asked for, but CUDA is not available")

    model = LSTM(pool=make_pool(args.type, None))
    params = model.init_params(torch.Generator().manual_seed(0), device=device)
    leaves = [leaf.requires_grad_() for _, leaf in param_items(params)]
    optimizer = make_optimizer(leaves)

    t, s, a = 21, args.scenes, args.agents
    rng = np.random.default_rng(0)
    xy = torch.from_numpy((rng.normal(size=(t, s, a, 2)).cumsum(axis=0) * 0.3)
                          .astype(np.float32)).to(device)
    mask = torch.ones((t, s, a), dtype=torch.bool, device=device)
    scene_mask = torch.ones((s,), dtype=torch.bool, device=device)

    def train_step():
        rel, _, _ = model.forward(params, xy[:9], mask[:9], prediction_truth=xy[9:20],
                                  prediction_truth_mask=mask[9:20])
        targets = xy[9:21, :, 0] - xy[8:20, :, 0]
        loss = prediction_loss(rel[-12:, :, 0], targets, scene_mask)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    float(train_step())  # warm-up (the kernels' first launch) outside the trace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        for _ in range(args.steps):
            loss = train_step()
        float(loss)
    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(args.trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"trace written to {path} (open with Perfetto or chrome://tracing)")
    return path


if __name__ == "__main__":
    main()
