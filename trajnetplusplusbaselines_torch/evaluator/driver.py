"""Prediction + evaluation driver, single process.

Port of ``get_predictions`` / ``run_evaluation`` of
``trajnetplusplusbaselines_tpu/evaluator/driver.py`` without its multi-host
branch (that one imports jax).  Writing and scoring are the JAX package's
numpy-only ``write_utils`` and ``trajnet_evaluate``, used as they are.
Skip-if-exists caching, ``--fill_missing`` and ``--write_only`` behave as
there.
"""

import os
import shutil
from typing import Callable, Dict

from trajnetplusplusbaselines_tpu.evaluator.driver import list_test_datasets
from trajnetplusplusbaselines_tpu.evaluator.trajnet_evaluator import trajnet_evaluate
from trajnetplusplusbaselines_tpu.evaluator.write_utils import (
    load_test_datasets,
    preprocess_test,
    write_predictions,
)


def test_scenes(dataset: str, args):
    """(dataset file name, scenes, per-scene paths cut at the last observed
    frame, scene goals) of one test dataset under ``args.path``."""
    # no goal-conditioned model is ported yet: no goal files to load
    dataset_name, scenes, scene_goals = load_test_datasets(dataset, False, args)
    processed = [preprocess_test(s, args.obs_length) for _, _, s in scenes]
    return dataset_name, scenes, processed, scene_goals


def get_predictions(predictors: Dict[str, Callable], args) -> None:
    """Write test_pred ndjson files for every (model, dataset) pair.

    predictors: {model_name: fn(paths, scene_goal) -> {mode: (primary,
    neighs)}}, or objects with ``predict_dataset`` for batched prediction.
    """
    datasets = list_test_datasets(args.path)
    fill_missing = getattr(args, "fill_missing", False)

    for model_name, predictor in predictors.items():
        model_dir = os.path.join(args.path, model_name)
        todo = datasets
        if fill_missing and os.path.exists(model_dir):
            # backfill: keep the existing dir, predict only what it lacks
            todo = [d for d in datasets
                    if not os.path.exists(os.path.join(model_dir, d + ".ndjson"))]
            if not todo:
                print(f"Predictions corresponding to {model_name} already exist.")
                continue
        elif os.path.exists(model_dir):
            print(f"Predictions corresponding to {model_name} already exist.")
            print("Loading the saved predictions")
            continue
        # write into a temp dir and rename at the end: an interrupted run must
        # not leave a partial dir that the skip-if-exists cache would trust
        tmp_dir = model_dir + ".tmp"
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)

        for dataset in todo:
            dataset_name, scenes, processed, scene_goals = test_scenes(dataset, args)
            if hasattr(predictor, "predict_dataset"):
                pred_list = predictor.predict_dataset(processed, scene_goals, args)
            else:
                pred_list = [predictor(paths, goal) for paths, goal in zip(processed, scene_goals)]
            pred_list = [[p[m] for m in range(len(p))] for p in pred_list]
            write_predictions(pred_list, scenes, model_name + ".tmp", dataset_name, args)

        if fill_missing and os.path.exists(model_dir):
            for f in os.listdir(tmp_dir):
                os.replace(os.path.join(tmp_dir, f), os.path.join(model_dir, f))
            os.rmdir(tmp_dir)
        else:
            os.rename(tmp_dir, model_dir)


def run_evaluation(predictors: Dict[str, Callable], args):
    get_predictions(predictors, args)
    if getattr(args, "write_only", False):
        return None
    return trajnet_evaluate(args)
