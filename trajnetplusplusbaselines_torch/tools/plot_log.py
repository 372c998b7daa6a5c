"""Training-curve plots from the trainers' JSON logs.

Port of ``trajnetplusplusbaselines_tpu/tools/plot_log.py``: reads the
single-line JSON records the trainers emit and renders epoch-loss /
val-loss / lr / epoch-time curves.  A host tool on numpy and matplotlib,
imported inside ``plots`` with the ``Agg`` backend; without matplotlib it
raises, naming it.

Usage:
    python -m trajnetplusplusbaselines_torch.tools.plot_log \
        --log_file OUTPUT_BLOCK/.../model.pkl.log
"""

import argparse
import json
from collections import defaultdict


def import_matplotlib():
    """matplotlib, set to its ``Agg`` backend; raises naming it where it is
    not installed (a machine without it cannot draw these plots)."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plot_log and visualize_predictions need matplotlib, which is not "
                          "installed here") from exc
    return matplotlib


def read_log(path: str):
    records = defaultdict(list)
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            rtype = obj.get("type")
            if rtype:
                records[rtype].append(obj)
    return records


def plots(log_file: str, output_prefix: str = None):
    matplotlib = import_matplotlib()

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    records = read_log(log_file)
    prefix = output_prefix or log_file

    # epoch loss curves (train + val)
    fig, ax = plt.subplots()
    if records["train-epoch"]:
        ax.plot(
            [r["epoch"] for r in records["train-epoch"]],
            [r["loss"] for r in records["train-epoch"]],
            label="train",
        )
    if records["val-epoch"]:
        ax.plot(
            [r["epoch"] for r in records["val-epoch"]],
            [r["loss"] for r in records["val-epoch"]],
            label="val",
        )
        if any("test_loss" in r for r in records["val-epoch"]):
            ax.plot(
                [r["epoch"] for r in records["val-epoch"]],
                [r.get("test_loss", float("nan")) for r in records["val-epoch"]],
                label="val (rollout)",
            )
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(prefix + ".loss.png", dpi=120, bbox_inches="tight")
    plt.close(fig)

    # learning rate over batches
    if records["train"]:
        fig, ax = plt.subplots()
        ax.plot([r["lr"] for r in records["train"]])
        ax.set_xlabel("log interval")
        ax.set_ylabel("lr")
        ax.set_yscale("log")
        fig.savefig(prefix + ".lr.png", dpi=120, bbox_inches="tight")
        plt.close(fig)

    # per-interval batch time + host data time (reference plot_log.py:20-84)
    if records["train"]:
        fig, ax = plt.subplots()
        ax.plot([r["time"] for r in records["train"]], label="batch time")
        if any("data_time" in r for r in records["train"]):
            ax.plot(
                [r.get("data_time", float("nan")) for r in records["train"]],
                label="data time",
            )
        ax.set_xlabel("log interval")
        ax.set_ylabel("time [s]")
        ax.set_yscale("log")
        ax.legend()
        fig.savefig(prefix + ".time.png", dpi=120, bbox_inches="tight")
        plt.close(fig)

    # epoch wall time
    if records["train-epoch"]:
        fig, ax = plt.subplots()
        ax.plot(
            [r["epoch"] for r in records["train-epoch"]],
            [r["time"] for r in records["train-epoch"]],
        )
        ax.set_xlabel("epoch")
        ax.set_ylabel("epoch time [s]")
        fig.savefig(prefix + ".epoch-time.png", dpi=120, bbox_inches="tight")
        plt.close(fig)

    return records


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--log_file", required=True, help="trainer .log file")
    parser.add_argument("--output", default=None, help="output file prefix")
    args = parser.parse_args(argv)
    plots(args.log_file, args.output)


if __name__ == "__main__":
    main()
