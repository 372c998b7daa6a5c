"""Dataset enumeration and goal-file loading.

Copy of ``trajnetplusplusbaselines_tpu/data/load.py``.
"""

import os
import pickle
from typing import Optional, Tuple

from .reader import Reader


def prepare_data(
    path: str,
    subset: str = "/train/",
    sample: float = 1.0,
    goals: bool = True,
    goal_files_dir: str = "goal_files",
) -> Tuple[Optional[list], Optional[dict], bool]:
    """Enumerate the ndjson files of a data subset.

    Returns (scenes, goals_dict, flag); each scene is (filename, scene_id, paths).
    """
    if not os.path.isdir(path + subset):
        if "train" in subset:
            raise FileNotFoundError(f"Train folder does NOT exist: {path + subset}")
        if "val" in subset:
            return None, None, False

    all_goals = {}
    all_scenes = []

    files = [
        f.split(".")[-2]
        for f in sorted(os.listdir(path + subset))
        if f.endswith(".ndjson")
    ]
    for file in files:
        reader = Reader(path + subset + file + ".ndjson", scene_type="paths")
        scene = [(file, s_id, s) for s_id, s in reader.scenes(sample=sample)]
        if goals:
            with open(os.path.join(goal_files_dir, subset.strip("/"), file + ".pkl"), "rb") as f:
                goal_dict = pickle.load(f)
            all_goals[file] = {
                s_id: [goal_dict[path[0].pedestrian] for path in s] for _, s_id, s in scene
            }
        all_scenes += scene

    if goals:
        return all_scenes, all_goals, True
    return all_scenes, None, True
