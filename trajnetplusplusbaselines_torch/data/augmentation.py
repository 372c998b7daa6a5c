"""Host-side scene normalization.

Copy of what the port uses of ``trajnetplusplusbaselines_tpu/data/
augmentation.py``: centring and rotating a scene and its inverse, dropping
distant or unobserved tracks, and the trainers' host-side augmentation (a random rotation
and observation noise, drawn from a numpy generator in the JAX package's
order), on the ``[T, num_tracks, 2]`` NaN-padded arrays of
``Reader.paths_to_xy``.
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


def drop_unobserved(xy: np.ndarray, obs_length: int = 9) -> Tuple[np.ndarray, np.ndarray]:
    """Drop tracks absent at the last observation frame."""
    absent = np.isnan(xy[obs_length - 1]).any(axis=1)
    mask = ~absent
    return xy[:, mask], mask


def random_rotation(xy: np.ndarray, goals: Optional[np.ndarray] = None,
                    rng: Optional[np.random.Generator] = None):
    """Rotate the whole scene (and its goals) by a uniform random angle."""
    theta = (rng.uniform if rng is not None else np.random.uniform)(0.0, 2.0 * math.pi)
    if goals is None:
        return theta_rotation(xy, theta)
    return theta_rotation(xy, theta), theta_rotation(goals, theta)


def add_noise(observation: np.ndarray, thresh: float = 0.005, obs_length: int = 9,
              ped: str = "primary", rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Uniform noise in +-``thresh`` on the observed frames of the primary or
    of the neighbours (``ped="neigh"``), in place."""
    sample = rng.uniform if rng is not None else np.random.uniform
    if ped == "primary":
        observation[:obs_length, 0] += sample(-thresh, thresh, observation[:obs_length, 0].shape)
    elif ped == "neigh":
        observation[:obs_length, 1:] += sample(-thresh, thresh, observation[:obs_length, 1:].shape)
    else:
        raise ValueError(f"unknown ped type {ped!r}")
    return observation
