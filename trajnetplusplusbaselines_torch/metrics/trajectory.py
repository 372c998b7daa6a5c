"""Row-level TrajNet++ metrics: ADE, FDE, collisions, top-k and KDE NLL.

Copy of ``trajnetplusplusbaselines_tpu/metrics/trajectory.py``; these
operate on lists of TrackRow.
"""

import math
from typing import List, Optional

import numpy as np

from ..data.rows import TrackRow


def average_l2(path1: List[TrackRow], path2: List[TrackRow], n_predictions: int = 12) -> float:
    """ADE over the last n_predictions rows of both paths."""
    assert len(path1) >= n_predictions
    assert len(path2) >= n_predictions
    p1 = path1[-n_predictions:]
    p2 = path2[-n_predictions:]
    return sum(
        math.sqrt((r1.x - r2.x) ** 2 + (r1.y - r2.y) ** 2) for r1, r2 in zip(p1, p2)
    ) / n_predictions


def final_l2(path1: List[TrackRow], path2: List[TrackRow]) -> float:
    """FDE between the last rows of both paths."""
    r1, r2 = path1[-1], path2[-1]
    return math.sqrt((r1.x - r2.x) ** 2 + (r1.y - r2.y) ** 2)


def collision(
    path1: List[TrackRow],
    path2: List[TrackRow],
    n_predictions: int = 12,
    person_radius: float = 0.1,
    inter_parts: int = 2,
) -> bool:
    """Segment-interpolated collision check (threshold 2 * person_radius).

    Each consecutive segment of both paths is subdivided into inter_parts + 1
    equally spaced points; a collision occurs if any pair of same-index points
    comes within 2 * person_radius.  Only frames common to both paths count.
    """
    assert len(path1) >= n_predictions
    p1 = path1[-n_predictions:]

    frames1 = set(r.frame for r in p1)
    frames2 = set(r.frame for r in path2)
    common = frames1 & frames2
    if not common:
        return False

    p1 = [r for r in p1 if r.frame in common]
    p2 = [r for r in path2 if r.frame in common]

    def inside_points(a, b, parts):
        return np.array(
            (np.linspace(a[0], b[0], parts + 1), np.linspace(a[1], b[1], parts + 1))
        )

    for i in range(len(p1) - 1):
        seg1 = inside_points((p1[i].x, p1[i].y), (p1[i + 1].x, p1[i + 1].y), inter_parts)
        seg2 = inside_points((p2[i].x, p2[i].y), (p2[i + 1].x, p2[i + 1].y), inter_parts)
        if np.min(np.linalg.norm(seg1 - seg2, axis=0)) <= 2 * person_radius:
            return True
    return False


def _split_by_prediction_number(multi_path: List[TrackRow]):
    by_num = {}
    for row in multi_path:
        num = row.prediction_number or 0
        by_num.setdefault(num, []).append(row)
    return [by_num[k] for k in sorted(by_num)]


def topk(multi_path1: List[TrackRow], path2: List[TrackRow], n_predictions: int = 12):
    """Best-of-k (ADE, FDE) over the prediction_number modes of multi_path1."""
    best_ade, best_fde = math.inf, math.inf
    for path1 in _split_by_prediction_number(multi_path1):
        if len(path1) < n_predictions:
            continue
        best_ade = min(best_ade, average_l2(path1, path2, n_predictions=n_predictions))
        best_fde = min(best_fde, final_l2(path1, path2))
    return best_ade, best_fde


def nll(
    multi_path1: List[TrackRow],
    path2: List[TrackRow],
    n_predictions: int = 12,
    n_samples: int = 50,
    log_pdf_lower_bound: float = -20.0,
) -> float:
    """Average negative log-likelihood of the ground truth under a Gaussian
    KDE fit to the first n_samples predicted modes, per prediction timestep.
    """
    import scipy.stats

    modes = _split_by_prediction_number(multi_path1)[:n_samples]
    modes = [m[-n_predictions:] for m in modes if len(m) >= n_predictions]
    if len(modes) < 2:
        return 0.0
    gt = path2[-n_predictions:]

    log_pdfs = []
    for t in range(n_predictions):
        samples = np.array([[m[t].x, m[t].y] for m in modes]).T  # [2, n_modes]
        try:
            kde = scipy.stats.gaussian_kde(samples)
            lp = np.clip(kde.logpdf(np.array([[gt[t].x], [gt[t].y]])), log_pdf_lower_bound, None)
            log_pdfs.append(float(lp[0]))
        except np.linalg.LinAlgError:
            log_pdfs.append(log_pdf_lower_bound)
    return -float(np.mean(log_pdfs))
