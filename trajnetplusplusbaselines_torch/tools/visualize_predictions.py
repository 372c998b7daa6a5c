"""Qualitative visualization: GT vs model predictions (+ optional GIF).

Port of ``trajnetplusplusbaselines_tpu/tools/visualize_predictions.py`` on
the port's ``data.Reader``: overlays ground-truth and per-model predicted
primary paths (and the neighbours) per scene.  A host tool on numpy and
matplotlib, imported inside ``visualize`` with the ``Agg`` backend; without
matplotlib it raises, naming it.

Usage:
    python -m trajnetplusplusbaselines_torch.tools.visualize_predictions \
        DATA_BLOCK/trajdata_split/test_private/synth.ndjson \
        DATA_BLOCK/trajdata_split/test_pred/cv_modes1/synth.ndjson \
        --n 3 -o viz
"""

import argparse
import os

import numpy as np

from ..data import Reader
from .plot_log import import_matplotlib


def plot_scene(ax, gt_paths, pred_paths_by_model, obs_length=9):
    gt_xy = Reader.paths_to_xy(gt_paths)
    # neighbours, light grey
    for n in range(1, gt_xy.shape[1]):
        ax.plot(gt_xy[:, n, 0], gt_xy[:, n, 1], color="0.8", lw=1)
    # primary observation (solid) and ground-truth future (dashed black)
    ax.plot(gt_xy[:obs_length, 0, 0], gt_xy[:obs_length, 0, 1], "k-", lw=2, label="obs")
    ax.plot(gt_xy[obs_length - 1 :, 0, 0], gt_xy[obs_length - 1 :, 0, 1],
            "k--", lw=2, label="gt")

    for model, pred_xy in pred_paths_by_model.items():
        ax.plot(pred_xy[:, 0], pred_xy[:, 1], lw=2, label=model)

    ax.set_aspect("equal")
    ax.legend(fontsize=7)


def scene_predictions(pred_reader, scene_id, pred_length=12):
    """Primary mode-0 prediction of one scene as [pred_length, 2]."""
    _, paths = pred_reader.scene(scene_id)
    primary = [
        r for r in paths[0] if (r.prediction_number or 0) == 0 and r.scene_id == scene_id
    ]
    return np.array([[r.x, r.y] for r in primary[-pred_length:]])


def visualize(gt_file, pred_files, labels=None, n_scenes=5, obs_length=9,
              pred_length=12, output_prefix="visualize", as_gif=False):
    matplotlib = import_matplotlib()

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or [os.path.basename(os.path.dirname(p)) for p in pred_files]
    gt_reader = Reader(gt_file, scene_type="paths")
    pred_readers = [Reader(p, scene_type="paths") for p in pred_files]

    outputs = []
    for i, (scene_id, gt_paths) in enumerate(gt_reader.scenes()):
        if i >= n_scenes:
            break
        preds = {}
        for label, pr in zip(labels, pred_readers):
            try:
                preds[label] = scene_predictions(pr, scene_id, pred_length)
            except Exception:
                continue

        if as_gif:
            outputs.append(_scene_gif(gt_paths, preds, scene_id, obs_length,
                                      output_prefix, plt))
        else:
            fig, ax = plt.subplots(figsize=(6, 6))
            plot_scene(ax, gt_paths, preds, obs_length)
            ax.set_title(f"scene {scene_id}")
            out = f"{output_prefix}.scene{scene_id}.png"
            fig.savefig(out, dpi=120, bbox_inches="tight")
            plt.close(fig)
            outputs.append(out)
    return outputs


def _scene_gif(gt_paths, preds, scene_id, obs_length, output_prefix, plt):
    from matplotlib import animation

    gt_xy = Reader.paths_to_xy(gt_paths)
    fig, ax = plt.subplots(figsize=(6, 6))

    def frame(t):
        ax.clear()
        for n in range(1, gt_xy.shape[1]):
            ax.plot(gt_xy[: t + 1, n, 0], gt_xy[: t + 1, n, 1], color="0.8", lw=1)
        ax.plot(gt_xy[: min(t + 1, obs_length), 0, 0],
                gt_xy[: min(t + 1, obs_length), 0, 1], "k-", lw=2)
        if t >= obs_length:
            for label, p in preds.items():
                k = t - obs_length + 1
                ax.plot(p[:k, 0], p[:k, 1], lw=2, label=label)
            ax.legend(fontsize=7)
        ax.set_xlim(np.nanmin(gt_xy[..., 0]) - 1, np.nanmax(gt_xy[..., 0]) + 1)
        ax.set_ylim(np.nanmin(gt_xy[..., 1]) - 1, np.nanmax(gt_xy[..., 1]) + 1)
        ax.set_title(f"scene {scene_id} t={t}")

    anim = animation.FuncAnimation(fig, frame, frames=gt_xy.shape[0], interval=200)
    out = f"{output_prefix}.scene{scene_id}.gif"
    anim.save(out, writer="pillow")
    plt.close(fig)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("gt_file", help="ground-truth (test_private) ndjson")
    parser.add_argument("pred_files", nargs="+", help="test_pred ndjson files")
    parser.add_argument("--labels", nargs="+", default=None)
    parser.add_argument("--n", type=int, default=5, help="number of scenes")
    parser.add_argument("--obs_length", type=int, default=9)
    parser.add_argument("--pred_length", type=int, default=12)
    parser.add_argument("-o", "--output", default="visualize")
    parser.add_argument("--gif", action="store_true", help="animated GIFs")
    args = parser.parse_args(argv)
    outs = visualize(args.gt_file, args.pred_files, args.labels, args.n,
                     args.obs_length, args.pred_length, args.output, args.gif)
    for o in outs:
        print("wrote", o)


if __name__ == "__main__":
    main()
