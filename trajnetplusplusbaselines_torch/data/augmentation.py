"""Host-side scene normalization.

Copy of what the port uses of ``trajnetplusplusbaselines_tpu/data/
augmentation.py``: centring and rotating a scene and its inverse, and
dropping distant tracks, on the ``[T, num_tracks, 2]`` NaN-padded arrays
of ``Reader.paths_to_xy``.
"""

import math
from typing import Optional, Tuple

import numpy as np


def theta_rotation(xy: np.ndarray, theta: float) -> np.ndarray:
    """Rotate ``[..., 2]`` coordinates by theta (radians)."""
    ct, st = math.cos(theta), math.sin(theta)
    r = np.array([[ct, st], [-st, ct]])
    return xy @ r


def shift(xy: np.ndarray, center: np.ndarray) -> np.ndarray:
    return xy - center


def center_scene(
    xy: np.ndarray, obs_length: int = 9, ped_id: int = 0, goals: Optional[np.ndarray] = None
):
    """Translate so the primary's last observation is the origin, then rotate
    so the primary's last observed velocity points "north" (+y).

    Returns (xy, rotation, center[, goals]); ``inverse_scene`` undoes it.
    """
    center = xy[obs_length - 1, ped_id].copy()
    xy = shift(xy, center)
    if goals is not None:
        goals = shift(goals, center)

    last = xy[obs_length - 1, ped_id]
    second_last = xy[obs_length - 2, ped_id]
    diff = last - second_last
    rotation = -math.atan2(diff[1], diff[0]) + math.pi / 2
    xy = theta_rotation(xy, rotation)
    if goals is not None:
        goals = theta_rotation(goals, rotation)
        return xy, rotation, center, goals
    return xy, rotation, center


def inverse_scene(xy: np.ndarray, rotation: float, center: np.ndarray) -> np.ndarray:
    xy = theta_rotation(xy, -rotation)
    return shift(xy, -center)


def drop_distant(xy: np.ndarray, r: float = 6.0) -> Tuple[np.ndarray, np.ndarray]:
    """Drop tracks that never come within r meters of the primary."""
    distance_2 = np.sum(np.square(xy - xy[:, 0:1]), axis=2)  # NaN where either absent
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        mask = np.nanmin(distance_2, axis=0) < r ** 2  # all-NaN track -> False
    return xy[:, mask], mask
