"""Prediction writing: scenes -> test_pred ndjson files.

Copy of ``trajnetplusplusbaselines_tpu/evaluator/write_utils.py``.
"""

import os
import pickle
from typing import List

import numpy as np

from ..data import Reader, SceneRow, TrackRow, writers


def _test_root(path: str) -> str:
    """.../test_pred/ -> .../test/ — only the trailing component changes (a
    blanket replace("_pred", "") would corrupt other "_pred" in the path)."""
    head, sep, _ = path.rstrip("/").rpartition("/")
    return (head + sep if sep else "") + "test/"


def load_test_datasets(dataset: str, goal_flag: bool, args):
    """Load the scenes of one test dataset (and optional goal files)."""
    test_root = _test_root(args.path)
    dataset_name = dataset + ".ndjson"  # dataset is always a bare stem here
    reader = Reader(test_root + dataset + ".ndjson", scene_type="paths")
    scenes = [(dataset, s_id, s) for s_id, s in reader.scenes()]

    if goal_flag:
        goal_file = os.path.join("goal_files", "test_private", dataset + ".pkl")
        try:
            with open(goal_file, "rb") as f:
                goal_dict = pickle.load(f)
        except FileNotFoundError:
            # synthetic gate datasets (collision_test) ship no goal files;
            # fall back to zero goals rather than failing the whole eval
            print(f"no goal file for {dataset}; using zero goals")
            goal_dict = None
        if goal_dict is None:
            scene_goals = [np.zeros((len(paths), 2)) for _, _, paths in scenes]
        else:
            all_goals = {
                s_id: [goal_dict[path[0].pedestrian] for path in s]
                for _, s_id, s in scenes
            }
            scene_goals = [np.array(all_goals[scene_id]) for _, scene_id, _ in scenes]
    else:
        scene_goals = [np.zeros((len(paths), 2)) for _, _, paths in scenes]

    return dataset_name, scenes, scene_goals


def preprocess_test(scene: List[list], obs_len: int) -> List[list]:
    """Truncate at the last observation frame and drop late-appearing tracks
    (overlapping test scenes can contain them)."""
    obs_frames = [row.frame for row in scene[0]][:obs_len]
    last_obs_frame = obs_frames[-1]
    return [
        [row for row in ped if row.frame <= last_obs_frame]
        for ped in scene
        if ped[0].frame <= last_obs_frame
    ]


def write_predictions(pred_list, scenes, model_name: str, dataset_name: str, args) -> None:
    """Append SceneRow + per-mode primary/neighbour TrackRows per scene."""
    seq_length = args.obs_length + args.pred_length
    path = os.path.join(args.path, model_name, dataset_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)

    with open(path, "a") as f:
        for predictions, (_, scene_id, paths) in zip(pred_list, scenes):
            observed_path = paths[0]
            frame_diff = observed_path[1].frame - observed_path[0].frame
            first_frame = observed_path[args.obs_length - 1].frame + frame_diff
            ped_id = observed_path[0].pedestrian
            neigh_ids = [p[0].pedestrian for p in paths[1:]]

            scene_row = SceneRow(
                scene_id,
                ped_id,
                observed_path[0].frame,
                observed_path[0].frame + (seq_length - 1) * frame_diff,
                2.5,
                0,
            )
            f.write(writers.trajnet(scene_row) + "\n")

            for m in range(len(predictions)):
                prediction, neigh_predictions = predictions[m]
                for i in range(len(prediction)):
                    row = TrackRow(
                        first_frame + i * frame_diff,
                        ped_id,
                        float(prediction[i, 0]),
                        float(prediction[i, 1]),
                        m,
                        scene_id,
                    )
                    f.write(writers.trajnet(row) + "\n")

                if len(neigh_predictions):
                    for n in range(neigh_predictions.shape[1]):
                        # NaN rows are written too: the evaluator counts
                        # predicted neighbour *tracks* for the Col-I gate
                        neigh = neigh_predictions[:, n]
                        for j in range(len(neigh)):
                            row = TrackRow(
                                first_frame + j * frame_diff,
                                neigh_ids[n],
                                float(neigh[j, 0]),
                                float(neigh[j, 1]),
                                m,
                                scene_id,
                            )
                            f.write(writers.trajnet(row) + "\n")
