"""Aggregate per-seed evaluation results into mean +- std tables.

Port of ``trajnetplusplusbaselines_tpu/tools/collect_results.py`` on the
port's ``trajnet_evaluator`` and ``metrics.records``.  The published
protocol reports mean (std) over seeds 42/10/20/30/40.  This tool
re-aggregates the already-written ``test_pred/<model>_seed<k>_modes<m>/``
prediction files against ``test_private`` (metric math only, no model or
device work), groups models by name with the ``seed<k>`` token stripped, and
prints one row per group plus a machine-readable JSON file.

Under ``--merge`` a row whose prediction directory is gone keeps the
``col_test`` Pass/Fail it was recorded with (the JAX tool resets it to
``"NA"``).

Usage:
    python -m trajnetplusplusbaselines_torch.tools.collect_results \
        --path trajdata_split [--out results_seeds.json]
"""

import argparse
import json
import os
import re

import numpy as np


def overall_metrics(model_name: str, args):
    """Overall Metrics row for one prediction dir (same math as the table)."""
    from ..evaluator.trajnet_evaluator import eval as eval_one
    from ..metrics.records import Metrics

    model_dir = os.path.join(args.path, model_name)
    preds = sorted(
        f for f in os.listdir(model_dir)
        if f.endswith(".ndjson") and "collision_test" not in f
    )
    total = Metrics(0)
    for f in preds:
        metrics, _, _ = eval_one(
            os.path.join(args.path.replace("/test_pred/", "/test_private/"), f),
            os.path.join(model_dir, f),
            args,
        )
        total += metrics
    total.avg_vals()
    return {
        "N": total.N,
        "ade": total.average_l2,
        "fde": total.final_l2,
        "col_i": total.pred_col,
        "col_ii": total.gt_col,
        "topk_ade": total.topk_ade,
        "topk_fde": total.topk_fde,
        "nll": total.nll,
    }


def _fingerprint(model_dir):
    """[file, mtime, size] of every prediction file — invalidates the cache
    whenever an in-progress eval adds or rewrites files."""
    out = []
    for f in sorted(os.listdir(model_dir)):
        p = os.path.join(model_dir, f)
        if f.endswith(".ndjson") and os.path.isfile(p):
            out.append([f, os.path.getmtime(p), os.path.getsize(p)])
    return out


def cached_metrics(name, args):
    """overall_metrics with a per-model JSON cache (metric math is ~2 min per
    model, so incremental collection runs re-evaluate only new/changed dirs)."""
    model_dir = os.path.join(args.path, name)
    fp = _fingerprint(model_dir)
    cache_file = os.path.join(args.cache, name + ".json") if args.cache else None
    if cache_file and os.path.exists(cache_file):
        with open(cache_file) as f:
            entry = json.load(f)
        if entry.get("fingerprint") == fp:
            return entry["metrics"]
    metrics = overall_metrics(name, args)
    if cache_file:
        os.makedirs(args.cache, exist_ok=True)
        with open(cache_file, "w") as f:
            json.dump({"fingerprint": fp, "metrics": metrics}, f)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default="trajdata_split")
    parser.add_argument("--obs_length", default=9, type=int)
    parser.add_argument("--pred_length", default=12, type=int)
    parser.add_argument("--disable-collision", dest="disable_collision",
                        action="store_true")
    parser.add_argument("--out", default=None, help="JSON output file")
    parser.add_argument("--models", nargs="*", default=None,
                        help="prediction dir names (default: all in test_pred)")
    parser.add_argument("--cache", default=None,
                        help="per-model metrics cache dir ('' disables; "
                             "default <path>/.metrics_cache)")
    parser.add_argument("--merge", action="store_true",
                        help="overlay this run's per-model rows onto an "
                             "existing --out file instead of replacing it "
                             "(rows whose prediction dirs are gone from disk "
                             "survive; groups are recomputed from the union)")
    args = parser.parse_args(argv)
    args.path = "DATA_BLOCK/" + args.path + "/test_pred/"
    if args.cache is None:
        args.cache = os.path.join(os.path.dirname(args.path.rstrip("/")),
                                  ".metrics_cache")

    models = args.models or sorted(
        d for d in os.listdir(args.path)
        if os.path.isdir(os.path.join(args.path, d)) and not d.endswith(".tmp")
    )

    per_model = {}
    if args.merge and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            per_model.update(json.load(f).get("per_model", {}))
    for name in models:
        per_model[name] = cached_metrics(name, args)

    # annotate the collision_test Pass/Fail gate (the reference evaluator
    # renders it per model): from the model's own prediction dir, the
    # gate_pred backfill tree (tools/collision_gate.py), the gate JSON those
    # runs record, or the verdict a merged row was recorded with
    from ..evaluator.trajnet_evaluator import collision_test

    block = os.path.dirname(args.path.rstrip("/"))
    gate_json = os.path.join(block, "collision_gate.json")
    gates = {}
    if os.path.exists(gate_json):
        with open(gate_json) as f:
            gates = json.load(f)
    for name, m in per_model.items():
        for root in (args.path, os.path.join(block, "gate_pred") + "/"):
            if os.path.exists(os.path.join(root, name, "collision_test.ndjson")):
                a = argparse.Namespace(path=root, pred_length=args.pred_length)
                m["col_test"] = collision_test(["collision_test.ndjson"], name, a)
                break
        else:
            m["col_test"] = gates.get(name, m.get("col_test", "NA"))
        m = per_model[name]
        print(f"{name:55s} ade {m['ade']:.3f} fde {m['fde']:.3f} "
              f"col-I {m['col_i']:.2f} col-II {m['col_ii']:.2f}", flush=True)

    # group by name with the seed token stripped
    groups = {}
    for name, m in per_model.items():
        group = re.sub(r"seed\d+", "seed*", name)
        groups.setdefault(group, []).append(m)

    print()
    summary = {}
    for group, rows in sorted(groups.items()):
        agg = {}
        for key in ("ade", "fde", "col_i", "col_ii", "topk_ade", "topk_fde", "nll"):
            vals = np.array([r[key] for r in rows], dtype=float)
            if key == "col_i" and (vals == -1).any():
                agg[key] = {"mean": -1.0, "std": 0.0, "n": len(vals)}
                continue
            agg[key] = {
                "mean": float(vals.mean()),
                "std": float(vals.std(ddof=0)),
                "n": len(vals),
            }
        gate_vals = [r.get("col_test", "NA") for r in rows]
        agg["col_test"] = {
            "pass": gate_vals.count("Pass"),
            "fail": gate_vals.count("Fail"),
            "na": gate_vals.count("NA"),
        }
        summary[group] = agg
        a, f_, ci, cii = agg["ade"], agg["fde"], agg["col_i"], agg["col_ii"]
        ct = agg["col_test"]
        gate = ("NA" if ct["na"] == len(rows)
                else f"{ct['pass']}/{ct['pass'] + ct['fail']}P")
        print(
            f"{group:55s} ade {a['mean']:.2f}+-{a['std']:.2f} "
            f"fde {f_['mean']:.2f}+-{f_['std']:.2f} "
            f"col-I {ci['mean']:.1f}+-{ci['std']:.1f} "
            f"col-II {cii['mean']:.1f}+-{cii['std']:.1f} ({a['n']} seeds) "
            f"col_test {gate}"
        )

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"per_model": per_model, "groups": summary}, f, indent=2)
        print(f"\nwrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
