"""Goal-file generator: per-pedestrian final positions as pickles.

Copy of ``trajnetplusplusbaselines_tpu/tools/get_dest.py`` (no pysparkling):
for every ndjson file, the goal of each pedestrian is its last observed
position across the whole file; saved as ``goal_files/<subset>/<dataset>.pkl``
mapping ped_id -> [x, y].  ``socialforce_eval --dest_files`` and
``dest_type="true"`` read them.

Usage:
    python -m trajnetplusplusbaselines_torch.tools.get_dest \
        --data DATA_BLOCK/trajdata_split/train/*.ndjson
"""

import argparse
import glob
import json
import os
import pickle
from collections import defaultdict


def get_dest(input_file: str) -> dict:
    last_seen = {}
    last_frame = defaultdict(lambda: -1)
    with open(input_file, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            track = obj.get("track")
            if track is None:
                continue
            if track["f"] >= last_frame[track["p"]]:
                last_frame[track["p"]] = track["f"]
                last_seen[track["p"]] = [track["x"], track["y"]]
    return last_seen


def generate_dest(input_file: str, goal_dir: str = "goal_files") -> str:
    dataset_type = input_file.split("/")[-2]
    dataset = input_file.split("/")[-1].replace(".ndjson", "")
    dict_dest = get_dest(input_file)

    out_dir = os.path.join(goal_dir, dataset_type)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, dataset + ".pkl")
    with open(out_path, "wb") as f:
        pickle.dump(dict_dest, f)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", nargs="+", required=True,
                        help="ndjson files (globs accepted)")
    parser.add_argument("--goal_dir", default="goal_files")
    args = parser.parse_args(argv)

    files = []
    for pattern in args.data:
        files.extend(sorted(glob.glob(pattern)))
    for input_file in files:
        out = generate_dest(input_file, args.goal_dir)
        print("wrote", out)


if __name__ == "__main__":
    main()
