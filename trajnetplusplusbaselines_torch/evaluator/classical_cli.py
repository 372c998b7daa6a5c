"""CLI: evaluate the classical (non-learned) predictors with the port.

Port of ``trajnetplusplusbaselines_tpu/evaluator/classical_cli.py`` with the
same flags, less ``--cpu``, plus ``--device`` (default ``cuda``).  Constant
velocity, the Kalman filter and social force predict each test dataset in
one ``predict_dataset`` on that device; ORCA runs on the host, scene by
scene.  With ``--device cuda`` and no card the CLI raises: nothing runs on
the CPU instead.  Under ``torch.distributed.run`` each rank predicts its
share of the test datasets on its own device and rank 0 scores
(``evaluator/driver.py``).

Usage:
    python -m trajnetplusplusbaselines_torch.evaluator.classical_cli \
        --path trajdata --cv --kf --sf --orca [--data_root DATA_ROOT] [--device cpu]
"""

import argparse
import os

from ..models.classical import constant_velocity, device_of, kalman, orca, socialforce
from ..parallel.multihost import barrier, init_from_env, process_info
from .driver import ensure_data_block, run_evaluation


class ClassicalPredictor:
    """A classical predictor for ``run_evaluation``: ``__call__(paths, goal)`` for one
    scene and ``predict_dataset`` for a whole dataset, with ``options``
    (parameters, and the device where the predictor has one) passed to the
    module's ``predict`` / ``predict_dataset``."""

    goal_flag = False

    def __init__(self, module, args, **options):
        self.module = module
        self.lengths = dict(n_predict=args.pred_length, obs_length=args.obs_length)
        self.options = options

    def __call__(self, paths, scene_goal):
        return self.module.predict(paths, **self.lengths, **self.options)

    def predict_dataset(self, scenes, scene_goals, args):
        return self.module.predict_dataset(scenes, **self.lengths, **self.options)


def build_predictors(args):
    predictors = {}

    def add(name, module, **options):
        predictors[name + "_modes" + str(args.modes)] = ClassicalPredictor(module, args,
                                                                           **options)

    device = device_of(args.device)
    if args.kf:
        add("kf", kalman, device=device)
    if args.sf:
        add("sf", socialforce, device=device)
        add("sf_opt", socialforce, sf_params=[0.5, 5.0, 0.3], device=device)
    if args.orca:
        add("orca", orca)
        add("orca_opt", orca, orca_params=[0.4, 1.0, 0.3])
    if args.cv:
        add("cv", constant_velocity, device=device)
    return predictors


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default="trajdata", help="directory of data to test")
    parser.add_argument("--output", nargs="+", default=[], help="relative paths of saved models")
    parser.add_argument("--obs_length", default=9, type=int)
    parser.add_argument("--pred_length", default=12, type=int)
    parser.add_argument("--write_only", action="store_true")
    parser.add_argument("--disable-collision", dest="disable_collision", action="store_true")
    parser.add_argument("--labels", required=False, nargs="+")
    parser.add_argument("--normalize_scene", action="store_true")
    parser.add_argument("--modes", default=1, type=int)
    parser.add_argument("--sf", action="store_true", help="evaluate social force")
    parser.add_argument("--orca", action="store_true", help="evaluate ORCA")
    parser.add_argument("--kf", action="store_true", help="evaluate Kalman filter")
    parser.add_argument("--cv", action="store_true", help="evaluate constant velocity")
    parser.add_argument(
        "--data_root",
        default=None,
        help="read-only source DATA_BLOCK to link test/test_private from",
    )
    parser.add_argument("--fill_missing", action="store_true",
                        help="backfill mode: keep existing prediction dirs and "
                             "predict only test datasets they lack")
    parser.add_argument("--device", default="cuda",
                        help="torch device of CV, KF and SF (cuda, cuda:N or cpu); "
                             "ORCA runs on the host")
    args = parser.parse_args(argv)
    args.device = init_from_env(device_of(args.device))

    predictors = build_predictors(args)
    if not predictors:
        raise SystemExit("No handcrafted baseline mentioned (use --cv/--kf/--sf/--orca)")

    dataset = args.path
    args.path = "DATA_BLOCK/" + args.path + "/test_pred/"
    if args.data_root and process_info()[0] == 0:
        ensure_data_block(args.data_root, "DATA_BLOCK", [dataset])
    barrier()

    # the evaluator derives folder names from args.output
    args.output = ["/" + name.replace("_modes" + str(args.modes), "") + ".pkl"
                   for name in predictors]
    os.makedirs(args.path, exist_ok=True)
    return run_evaluation(predictors, args)


if __name__ == "__main__":
    main()
