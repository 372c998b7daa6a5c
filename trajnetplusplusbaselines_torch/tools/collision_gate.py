"""Drive the collision_test Pass/Fail gate for trained checkpoints.

Port of ``trajnetplusplusbaselines_tpu/tools/collision_gate.py`` on the
port's ``BatchedPredictor`` and ``utils.checkpoint``, with ``--device``
(default ``cuda``; it raises where no card is present) in place of
``--cpu``.  The TrajNet++ evaluator renders a Col_test column per model: the
model predicts one synthetic head-on scene (``DATA_BLOCK/<path>/test/
collision_test.ndjson``) and passes iff the predicted primary and
neighbour tracks never collide.  Protocol evaluations whose test directory
holds that scene populate the gate themselves; this tool backfills it for
checkpoints whose prediction directories predate the gate scene, without
predicting their whole test split:

- if ``test_pred/<model>_modes<k>/`` exists, the gate prediction is written
  there (the file the evaluator's own gate reads);
- otherwise it goes to ``gate_pred/<model>_modes<k>/``, so a stub directory
  never poisons the evaluator's skip-if-exists prediction cache.

The prediction is written to a temporary file and moved into place with
``os.replace``: an interrupted run leaves no partial
``collision_test.ndjson`` for a later run to trust (the JAX tool appends to
the live file).  Results go to ``DATA_BLOCK/<path>/collision_gate.json``,
which ``tools/collect_results`` reads.

Usage:
    python -m trajnetplusplusbaselines_torch.tools.collision_gate \\
        --path trajdata_split --device cuda \\
        --output OUTPUT_BLOCK/trajdata_split/lstm_vanilla_seed42.pkl [...]
"""

import argparse
import json
import os
import types

import torch

GATE = "collision_test"


def model_name(model_path: str, modes: int) -> str:
    return model_path.split("/")[-1].replace(".pkl", "") + "_modes" + str(modes)


def gate_one(model_path: str, args) -> str:
    """Predict the collision_test scene for one checkpoint; return Pass/Fail."""
    from ..evaluator.driver import list_test_datasets, test_scenes
    from ..evaluator.learned import BatchedPredictor
    from ..evaluator.trajnet_evaluator import collision_test
    from ..evaluator.write_utils import write_predictions
    from ..utils.checkpoint import load_predictor

    name = model_name(model_path, args.modes)
    root = args.test_pred if os.path.isdir(os.path.join(args.test_pred, name)) else args.gate_pred
    out_file = os.path.join(root, name, GATE + ".ndjson")

    if not os.path.exists(out_file):
        if GATE not in list_test_datasets(args.test_pred):
            raise SystemExit(f"{GATE}.ndjson is not in this split's test dir; copy it from "
                             "the TrajNet++ data first")
        predictor = BatchedPredictor(load_predictor(model_path), modes=args.modes,
                                     batch_scenes=args.batch_scenes, device=args.device)
        # write_utils and test_scenes read .path (<split>/test_pred/ or
        # gate_pred/, the test dir beside it) and the lengths
        lengths = dict(obs_length=args.obs_length, pred_length=args.pred_length)
        source = types.SimpleNamespace(path=args.test_pred, **lengths)
        dataset_name, scenes, processed, scene_goals = test_scenes(GATE, source,
                                                                   predictor.goal_flag)
        pred_list = predictor.predict_dataset(processed, scene_goals, source)
        pred_list = [[p[m] for m in range(len(p))] for p in pred_list]
        # written under a temporary model name beside the final one, then
        # moved into place in one step
        partial = name + ".gate.tmp"
        partial_file = os.path.join(root, partial, dataset_name)
        if os.path.exists(partial_file):
            os.remove(partial_file)
        write_predictions(pred_list, scenes, partial, dataset_name,
                          types.SimpleNamespace(path=root, **lengths))
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        os.replace(partial_file, out_file)
        os.rmdir(os.path.join(root, partial))

    gate_args = types.SimpleNamespace(path=root if root.endswith("/") else root + "/",
                                      pred_length=args.pred_length)
    return collision_test([GATE + ".ndjson"], name, gate_args)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default="trajdata_split")
    parser.add_argument("--output", nargs="+", required=True, help="model .pkl paths")
    parser.add_argument("--modes", default=1, type=int)
    parser.add_argument("--obs_length", default=9, type=int)
    parser.add_argument("--pred_length", default=12, type=int)
    parser.add_argument("--batch_scenes", default=4, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the rollout (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)

    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asked for, but CUDA is not available")

    block = os.path.join("DATA_BLOCK", args.path)
    args.test_pred = os.path.join(block, "test_pred") + "/"
    args.gate_pred = os.path.join(block, "gate_pred") + "/"

    gate_file = os.path.join(block, "collision_gate.json")
    results = {}
    if os.path.exists(gate_file):
        with open(gate_file) as f:
            results = json.load(f)

    for model_path in args.output:
        name = model_name(model_path, args.modes)
        results[name] = gate_one(model_path, args)
        print(f"{name:60s} Col_test: {results[name]}", flush=True)
        with open(gate_file, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)

    return results


if __name__ == "__main__":
    main()
