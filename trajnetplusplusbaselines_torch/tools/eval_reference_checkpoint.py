"""Evaluate a torch checkpoint of the reference implementation with the
port's evaluator.

Port of ``trajnetplusplusbaselines_tpu/tools/eval_reference_checkpoint.py``.
It loads checkpoints of the reference's own ``trajnetbaselines`` LSTM or
SGAN predictor (``--module``), imported from ``--reference_root`` on the
port's ``trajnetplusplustools`` stub (``tools/reference_stub.py``), and
scores their predictions with the port's ``evaluator/driver.run_evaluation``,
so that a reference checkpoint and the port's models are measured with one
metric stack on one split.  The reference's predictor builds its tensors on
the CPU and is called scene by scene, and no kernel of the port lies on this
path, so the tool takes no ``--device``.

Usage:
    python -m trajnetplusplusbaselines_torch.tools.eval_reference_checkpoint \
        --reference_root <directory holding trajnetbaselines/> \
        --path trajdata_split \
        --output OUTPUT_BLOCK/trajdata_split/lstm_vanilla_refctl_seed42.pkl
"""

import argparse
import contextlib
import functools
import os

import torch

from ..evaluator.driver import ensure_data_block, run_evaluation
from .reference_stub import load_reference


class _ReferencePredictor:
    """Adapter: reference torch predictor -> the driver's fn(paths, goal)."""

    def __init__(self, predictor, args):
        self.predictor = predictor
        self.args = args
        self.goal_flag = False  # the checkpoints scored here are not goal-conditioned

    def __call__(self, paths, scene_goal):
        return self.predictor(
            paths,
            scene_goal,
            n_predict=self.args.pred_length,
            obs_length=self.args.obs_length,
            modes=self.args.modes,
            args=self.args,
        )


def load_checkpoint(predictor_cls, safe_cls, model_path: str):
    """``predictor_cls.load(model_path)`` with ``safe_cls`` admitted to
    torch's weights-only unpickler.  A full-object pickle that it refuses is
    loaded again with ``weights_only=False`` (the checkpoints are the user's
    own training runs); ``torch.load`` is restored whatever happens."""
    safe = (torch.serialization.safe_globals([safe_cls])
            if hasattr(torch.serialization, "safe_globals") else contextlib.nullcontext())
    with safe:
        try:
            return predictor_cls.load(model_path)
        except Exception:
            orig = torch.load
            torch.load = functools.partial(orig, weights_only=False)
            try:
                return predictor_cls.load(model_path)
            finally:
                torch.load = orig


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--reference_root", required=True,
                        help="directory holding the reference's trajnetbaselines/ package")
    parser.add_argument("--path", default="trajdata_split")
    parser.add_argument("--output", nargs="+", required=True,
                        help="reference torch .pkl checkpoint paths")
    parser.add_argument("--obs_length", default=9, type=int)
    parser.add_argument("--pred_length", default=12, type=int)
    parser.add_argument("--write_only", action="store_true")
    parser.add_argument("--disable-collision", dest="disable_collision",
                        action="store_true")
    parser.add_argument("--labels", required=False, nargs="+")
    parser.add_argument("--normalize_scene", action="store_true")
    parser.add_argument("--modes", default=1, type=int)
    parser.add_argument("--module", default="lstm", choices=("lstm", "sgan"),
                        help="which reference engine produced the checkpoint")
    parser.add_argument("--data_root", default=None)
    args = parser.parse_args(argv)

    trajnetbaselines = load_reference(args.reference_root)

    dataset = args.path
    args.path = "DATA_BLOCK/" + args.path + "/test_pred/"
    if args.data_root:
        ensure_data_block(args.data_root, "DATA_BLOCK", [dataset])
    os.makedirs(args.path, exist_ok=True)

    if args.module == "sgan":
        predictor_cls = trajnetbaselines.sgan.SGANPredictor
        safe_cls = trajnetbaselines.sgan.sgan.SGANPredictor
    else:
        predictor_cls = trajnetbaselines.lstm.LSTMPredictor
        safe_cls = trajnetbaselines.lstm.lstm.LSTMPredictor

    predictors = {}
    for model_path in args.output:
        name = model_path.split("/")[-1].replace(".pkl", "") + "_modes" + str(args.modes)
        predictors[name] = _ReferencePredictor(
            load_checkpoint(predictor_cls, safe_cls, model_path), args)

    return run_evaluation(predictors, args)


if __name__ == "__main__":
    main()
