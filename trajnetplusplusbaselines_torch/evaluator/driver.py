"""Prediction + evaluation driver.

Port of ``trajnetplusplusbaselines_tpu/evaluator/driver.py``:
``ensure_data_block``, ``list_test_datasets``, ``get_predictions`` and
``run_evaluation``.  Writing and scoring are the port's copies of the JAX
package's numpy-only ``write_utils`` and ``trajnet_evaluate``.
Skip-if-exists caching, ``--fill_missing`` and ``--write_only`` behave as
there, and a predictor whose ``goal_flag`` is set gets the goals of
``goal_files/test_private/<dataset>.pkl``.  Unlike the JAX loader, a
missing goal file raises, except for the synthetic ``collision_test`` gate,
which ships none and takes zero goals.

Under ``torch.distributed.run`` (a process group of more than one rank,
``parallel.multihost``) each rank predicts its ``shard_items`` of the test
datasets into ``<model>.tmp`` (a shared filesystem): rank 0 decides the
skip and broadcasts it, cleans the temporary directory before a barrier,
renames it after a second one, and a third holds every rank until the
rename is published; scoring runs on rank 0 only.  ``--fill_missing`` is a
single-process mode and raises under several ranks.
"""

import os
import pickle
import shutil
from typing import Callable, Dict, List

import numpy as np

from ..parallel.multihost import barrier, broadcast_from_zero, process_info, shard_items
from .trajnet_evaluator import trajnet_evaluate
from .write_utils import load_test_datasets, preprocess_test, write_predictions

GOALS_OPTIONAL = ("collision_test",)  # synthetic gate datasets without goal files


def ensure_data_block(data_root: str, local_root: str, datasets: List[str]) -> None:
    """Symlink read-only source datasets into the writable DATA_BLOCK tree."""
    for name in datasets:
        src = os.path.join(data_root, name)
        dst = os.path.join(local_root, name)
        os.makedirs(dst, exist_ok=True)
        for subset in ("test", "test_private"):
            src_sub = os.path.join(src, subset)
            dst_sub = os.path.join(dst, subset)
            if os.path.isdir(src_sub) and not os.path.exists(dst_sub):
                os.symlink(os.path.abspath(src_sub), dst_sub)


def list_test_datasets(path: str) -> List[str]:
    """Dataset stems in the test dir (args.path is .../test_pred/)."""
    # replace only the trailing test_pred component — a blanket
    # str.replace("_pred", "") would corrupt any other "_pred" in the path
    head, sep, _ = path.rstrip("/").rpartition("/")
    test_dir = (head + sep if sep else "") + "test"
    return sorted(
        f.replace(".ndjson", "")
        for f in os.listdir(test_dir)
        if f.endswith(".ndjson")
    )


def load_goals(dataset: str, scenes, goal_dir: str = "goal_files/test_private"):
    """Per-scene goals ``[n, 2]`` from ``goal_dir/<dataset>.pkl`` (a dict
    from pedestrian id to goal), in each scene's path order.  Zero goals for
    a dataset of ``GOALS_OPTIONAL`` without a file; any other missing file
    raises."""
    goal_file = os.path.join(goal_dir, dataset + ".pkl")
    if not os.path.exists(goal_file) and dataset in GOALS_OPTIONAL:
        print(f"no goal file for {dataset}; using zero goals")
        return [np.zeros((len(paths), 2)) for _, _, paths in scenes]
    with open(goal_file, "rb") as f:
        goal_dict = pickle.load(f)
    return [np.array([goal_dict[path[0].pedestrian] for path in paths], dtype=np.float64)
            for _, _, paths in scenes]


def test_scenes(dataset: str, args, goal_flag: bool = False):
    """(dataset file name, scenes, per-scene paths cut at the last observed
    frame, scene goals) of one test dataset under ``args.path``; the goals
    are zeros unless ``goal_flag``."""
    dataset_name, scenes, scene_goals = load_test_datasets(dataset, False, args)
    if goal_flag:
        scene_goals = load_goals(dataset, scenes)
    processed = [preprocess_test(s, args.obs_length) for _, _, s in scenes]
    return dataset_name, scenes, processed, scene_goals


def get_predictions(predictors: Dict[str, Callable], args) -> None:
    """Write test_pred ndjson files for every (model, dataset) pair.

    predictors: {model_name: fn(paths, scene_goal) -> {mode: (primary,
    neighs)}}, or objects with ``predict_dataset`` for batched prediction.
    Several ranks: each predicts its share of the datasets (see the module).
    """
    rank, world = process_info()
    datasets = list_test_datasets(args.path)
    fill_missing = getattr(args, "fill_missing", False)
    if fill_missing and world > 1:
        raise ValueError("--fill_missing is a single-process backfill mode")

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
        # rank 0 decides and broadcasts: the others' view of the shared
        # filesystem may lag its rename, and a rank that skipped would leave
        # the rest waiting in the barriers below
        elif broadcast_from_zero(os.path.exists(model_dir)):
            print(f"Predictions corresponding to {model_name} already exist.")
            print("Loading the saved predictions")
            continue
        # write into a temp dir and rename at the end: an interrupted run must
        # not leave a partial dir that the skip-if-exists cache would trust
        tmp_dir = model_dir + ".tmp"
        if rank == 0:
            if os.path.exists(tmp_dir):
                shutil.rmtree(tmp_dir)
            os.makedirs(tmp_dir)
        barrier()  # rank 0's clean-up before anyone writes

        # per predictor, as the JAX driver resolves it: only a goal model
        # makes the driver read goal files
        goal_flag = getattr(predictor, "goal_flag", getattr(args, "goal_flag", False))
        for dataset in shard_items(todo):
            dataset_name, scenes, processed, scene_goals = test_scenes(dataset, args, goal_flag)
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
            continue
        barrier()  # every rank's predictions are written
        if rank == 0:
            os.rename(tmp_dir, model_dir)
        barrier()  # no rank goes on (into scoring) before the rename


def run_evaluation(predictors: Dict[str, Callable], args):
    """Predict (``get_predictions``) and score; with several ranks rank 0
    scores the whole prediction tree and the others return None."""
    get_predictions(predictors, args)
    if getattr(args, "write_only", False) or process_info()[0] != 0:
        return None
    return trajnet_evaluate(args)
