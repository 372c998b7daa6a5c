"""Classical-baseline parameter-evaluation tool: an ADE/FDE table for ORCA,
social force and the Kalman filter on train datasets, for tuning their
parameters, with true-goal dictionaries where given.

Port of ``trajnetplusplusbaselines_tpu/models/classical/socialforce_eval.py``
with ``--device`` (default ``cuda``).  ``Evaluator.aggregate`` runs each
simulator's ``predict_dataset`` over the whole scene list (social force and
the Kalman filter folded on the device, ORCA scene by scene on the host).

Usage:
    python -m trajnetplusplusbaselines_torch.models.classical.socialforce_eval \
        --data DATA_BLOCK/trajdata/train/biwi_hotel.ndjson --simulator kf --device cuda
"""

import argparse
import pickle
from itertools import compress

from ...data import Reader, TrackRow, interactions
from ...metrics import trajectory as tmetrics
from . import device_of, kalman, orca, socialforce


def filter_interacting_neighbours(paths, obs_length=9, pred_length=12):
    """Keep only the collision-avoidance neighbours of the primary (the
    reference's commented-out filter, here the opt-in ``--interactions``)."""
    xy = Reader.paths_to_xy(paths)[: obs_length + pred_length]
    keep = interactions.collision_avoidance(xy, obs_length=obs_length)
    return [paths[0]] + list(compress(paths[1:], keep))


class Evaluator:
    def __init__(self, scenes, dest_dict=None, params=None, args=None):
        self.scenes = scenes
        self.dest = dest_dict
        self.params = params or {}
        self.args = args
        self.average_l2 = {"N": len(scenes)}
        self.final_l2 = {"N": len(scenes)}

    def aggregate(self, name, dest_type="true"):
        """Score simulator ``name`` (``kf``, ``sf_*`` or ``orca_*``) over the
        scenes, all of them in one ``predict_dataset``."""
        print("evaluating", name)
        args = self.args
        scenes = self.scenes
        if getattr(args, "interactions", False):
            scenes = [filter_interacting_neighbours(paths, args.obs_length, args.pred_length)
                      for paths in scenes]
        lengths = dict(n_predict=args.pred_length, obs_length=args.obs_length)
        device = getattr(args, "device", "cuda")
        if "kf" in name:
            outputs = kalman.predict_dataset(scenes, device=device, **lengths)
        elif "sf" in name:
            outputs = socialforce.predict_dataset(scenes, self.dest, dest_type, self.params["sf"],
                                                  device=device, **lengths)
        elif "orca" in name:
            outputs = orca.predict_dataset(scenes, self.dest, dest_type, self.params["orca"],
                                           **lengths)
        else:
            raise ValueError(name)

        average = final = 0.0
        for paths, output in zip(scenes, outputs):
            prediction, _ = output[0]
            observed = paths[0]
            frame_diff = observed[1].frame - observed[0].frame
            first_frame = observed[args.obs_length - 1].frame + frame_diff
            ped_id = observed[0].pedestrian
            rows = [
                TrackRow(first_frame + i * frame_diff, ped_id,
                         float(prediction[i, 0]), float(prediction[i, 1]), 0)
                for i in range(len(prediction))
            ]
            average += tmetrics.average_l2(paths[0], rows)
            final += tmetrics.final_l2(paths[0], rows)

        self.average_l2[name] = average / max(len(scenes), 1)
        self.final_l2[name] = final / max(len(scenes), 1)
        return self

    def result(self):
        return self.average_l2, self.final_l2


def eval_dataset(input_file, dest_file, simulator, params, args):
    print("dataset", input_file)
    reader = Reader(input_file, scene_type="paths")
    scenes = [s for _, s in reader.scenes(sample=getattr(args, "sample", None))]

    dest_dict = None
    dest_type = "interp"
    if dest_file is not None:
        with open(dest_file, "rb") as f:
            dest_dict = pickle.load(f)
        dest_type = "true"

    evaluator = Evaluator(scenes, dest_dict, params, args)
    if simulator in ("all", "orca"):
        evaluator.aggregate("orca_" + dest_type, dest_type)
    if simulator in ("all", "sf"):
        evaluator.aggregate("sf_" + dest_type, dest_type)
    if simulator in ("all", "kf", "kalman"):
        evaluator.aggregate("kf")
    return evaluator.result()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--obs_length", default=9, type=int)
    parser.add_argument("--pred_length", default=12, type=int)
    parser.add_argument("--simulator", default="all", choices=("all", "orca", "sf", "kalman", "kf"))
    parser.add_argument("--sample", default=None, type=float,
                        help="scene sample ratio for quick sweeps")
    parser.add_argument("--interactions", action="store_true",
                        help="keep only collision-avoidance neighbours "
                             "(data/interactions.py; the reference's "
                             "commented-out filter)")
    # social force params
    parser.add_argument("--tau", default=0.5, type=float)
    parser.add_argument("--vo", default=2.1, type=float)
    parser.add_argument("--sigma", default=0.3, type=float)
    # ORCA params
    parser.add_argument("--min_dist", default=4, type=float)
    parser.add_argument("--react_time", default=4, type=float)
    parser.add_argument("--radius", default=0.6, type=float)
    parser.add_argument("--data", nargs="+",
                        default=["DATA_BLOCK/trajdata/train/biwi_hotel.ndjson"],
                        help="ndjson files to evaluate on")
    parser.add_argument("--dest_files", nargs="*", default=None,
                        help="true-goal pickles matching --data")
    parser.add_argument("--device", default="cuda",
                        help="torch device of social force and the Kalman filter "
                             "(cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)
    device_of(args.device)

    params = {
        "sf": [args.tau, args.vo, args.sigma],
        "orca": [args.min_dist, args.react_time, args.radius],
    }
    print(params)

    results = {}
    for i, dataset in enumerate(args.data):
        dest_file = args.dest_files[i] if args.dest_files else None
        name = dataset.split("/")[-1].replace(".ndjson", "")
        results[name] = eval_dataset(dataset, dest_file, args.simulator, params, args)

    for title, index in (("## Average L2 [m]", 0), ("## Final L2 [m]", 1)):
        print(title)
        for dataset, rs in results.items():
            r = rs[index]
            cells = "  ".join(f"{k}={v:.2f}" for k, v in r.items() if k != "N")
            print(f"{dataset:>30s} | N={r['N']:>4} | {cells}")
        print("")
    return results


if __name__ == "__main__":
    main()
