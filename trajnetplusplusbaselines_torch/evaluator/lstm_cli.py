"""CLI: evaluate trained LSTM, SGAN and VAE models with the port.

Port of ``trajnetplusplusbaselines_tpu/evaluator/lstm_cli.py`` with the same
flags, less ``--cpu``, plus ``--device`` (default ``cuda``).  Predictor
pickles of either package load without jax.  The CLI never runs on another
device than the one asked for: with ``--device cuda`` and no card it raises.
Under ``torch.distributed.run`` each rank serves its share of the test
datasets on its own card (``parallel.multihost.init_from_env``) and rank 0
scores (``evaluator/driver.py``).

Usage:
    python -m trajnetplusplusbaselines_torch.evaluator.lstm_cli \
        --path trajdata_split --output OUTPUT_BLOCK/trajdata_split/lstm_directional.pkl
    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m trajnetplusplusbaselines_torch.evaluator.lstm_cli --path trajdata_split \
        --output OUTPUT_BLOCK/trajdata_split/lstm_directional.pkl
"""

import argparse
import os

import torch

from ..parallel.multihost import barrier, init_from_env, process_info
from ..utils.checkpoint import load_predictor
from .driver import ensure_data_block, run_evaluation
from .learned import BatchedPredictor


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default="trajdata", help="directory of data to test")
    parser.add_argument("--output", nargs="+", required=True, help="model .pkl paths")
    parser.add_argument("--obs_length", default=9, type=int)
    parser.add_argument("--pred_length", default=12, type=int)
    parser.add_argument("--write_only", action="store_true")
    parser.add_argument("--disable-collision", dest="disable_collision", action="store_true")
    parser.add_argument("--labels", required=False, nargs="+")
    parser.add_argument("--normalize_scene", action="store_true")
    parser.add_argument("--modes", default=1, type=int)
    parser.add_argument("--batch_scenes", default=64, type=int,
                        help="device batch size for rollout")
    parser.add_argument("--data_root", default=None,
                        help="read-only source DATA_BLOCK to link test/test_private from")
    parser.add_argument("--fill_missing", action="store_true",
                        help="backfill mode: keep existing prediction dirs and "
                             "predict only test datasets they lack")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the rollout (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asked for, but CUDA is not available")
    device = init_from_env(device)

    dataset = args.path
    args.path = "DATA_BLOCK/" + args.path + "/test_pred/"
    if args.data_root and process_info()[0] == 0:
        ensure_data_block(args.data_root, "DATA_BLOCK", [dataset])
    barrier()
    os.makedirs(args.path, exist_ok=True)

    predictors = {}
    for model_path in args.output:
        name = model_path.split("/")[-1].replace(".pkl", "") + "_modes" + str(args.modes)
        predictors[name] = BatchedPredictor(
            load_predictor(model_path), modes=args.modes,
            batch_scenes=args.batch_scenes, device=device,
        )
    return run_evaluation(predictors, args)


if __name__ == "__main__":
    main()
