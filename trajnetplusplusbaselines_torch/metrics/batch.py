"""Dense array metrics over ``[agent, time, 2]`` scenes: ADE, FDE and the
segment-interpolated collision checks.

Copy of ``trajnetplusplusbaselines_tpu/metrics/batch.py`` (numpy only); the
classical predictors' tests use it as their oracle.
"""

import numpy as np


def ade(pred, gt):
    """Primary-agent ADE. pred/gt: [A, T, 2] (agent 0 is primary)."""
    return np.mean(np.linalg.norm(pred[0] - gt[0], axis=-1))


def fde(pred, gt):
    """Primary-agent FDE. pred/gt: [A, T, 2]."""
    return np.linalg.norm(gt[0, -1] - pred[0, -1])


def _segment_min_distances(path1, path2, inter_parts=2):
    """Min distance between interpolated segments of two [T, 2] paths.

    Returns [T-1, inter_parts+1] distances between same-index inside points.
    """
    p1a, p1b = path1[:-1], path1[1:]  # [T-1, 2]
    p2a, p2b = path2[:-1], path2[1:]
    alphas = np.linspace(0.0, 1.0, inter_parts + 1)  # [P]
    pts1 = p1a[:, None, :] + alphas[None, :, None] * (p1b - p1a)[:, None, :]  # [T-1, P, 2]
    pts2 = p2a[:, None, :] + alphas[None, :, None] * (p2b - p2a)[:, None, :]
    return np.linalg.norm(pts1 - pts2, axis=-1)


def collision_free(path1, path2, person_radius=0.1, inter_parts=2):
    """True if no collision between two dense [T, 2] paths."""
    d = _segment_min_distances(path1, path2, inter_parts)
    return not bool(np.any(d <= 2 * person_radius))


def pred_col(pred, gt=None, person_radius=0.1, inter_parts=2):
    """1.0 if the primary prediction collides with any predicted neighbour.

    pred: [A, T, 2]; NaN neighbour rows never collide.
    """
    primary = pred[0]
    for neigh in pred[1:]:
        valid = ~np.isnan(neigh).any(axis=-1)
        if not valid.any():
            continue
        d = _segment_min_distances(primary, np.nan_to_num(neigh, nan=1e6))
        seg_valid = valid[:-1] & valid[1:]
        if np.any((d <= 2 * person_radius) & seg_valid[:, None]):
            return 1.0
    return 0.0


def gt_col(pred, gt, person_radius=0.1, inter_parts=2):
    """1.0 if the primary prediction collides with any ground-truth neighbour."""
    primary = pred[0]
    for neigh in gt[1:]:
        valid = ~np.isnan(neigh).any(axis=-1)
        if not valid.any():
            continue
        d = _segment_min_distances(primary, np.nan_to_num(neigh, nan=1e6))
        seg_valid = valid[:-1] & valid[1:]
        if np.any((d <= 2 * person_radius) & seg_valid[:, None]):
            return 1.0
    return 0.0


def topk_ade(preds, gt):
    """Best-of-k ADE. preds: [K, A, T, 2]; gt: [A, T, 2]."""
    return min(ade(p, gt) for p in preds)


def topk_fde(preds, gt):
    """Best-of-k FDE. preds: [K, A, T, 2]; gt: [A, T, 2]."""
    return min(fde(p, gt) for p in preds)


def trajnet_sample_eval(pred, gt):
    return ade(pred, gt), fde(pred, gt), pred_col(pred, gt), gt_col(pred, gt)


def trajnet_batch_eval(pred, gt, seq_start_end):
    """Sum of per-scene (ADE, FDE, pred_col, gt_col) over a packed batch.

    pred/gt: [num_tracks, T, 2]; seq_start_end: iterable of (start, end).
    """
    s = np.zeros(4)
    for start, end in seq_start_end:
        s += np.array(trajnet_sample_eval(pred[start:end], gt[start:end]))
    return tuple(s)


def trajnet_batch_multi_eval(preds, gt, seq_start_end):
    s_ade, s_fde = 0.0, 0.0
    for start, end in seq_start_end:
        scene_preds = [p[start:end] for p in preds]
        s_ade += topk_ade(scene_preds, gt[start:end])
        s_fde += topk_fde(scene_preds, gt[start:end])
    return s_ade, s_fde


def scene_metrics(pred, gt, person_radius=0.1):
    """All four unimodal metrics for one scene: (ade, fde, pred_col, gt_col)."""
    return trajnet_sample_eval(pred, gt)
