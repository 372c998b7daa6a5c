"""Interaction-type categorization of scenes.

Copy of ``trajnetplusplusbaselines_tpu/data/interactions.py`` (numpy only):
the TrajNet++ interaction heuristics.  A neighbour interacts with the
primary when it enters the primary's frontal cone within a distance
threshold during the prediction window; the interaction subtype follows
from the relative heading (leader-follower: same direction;
collision-avoidance: opposing; group: side-by-side with matched velocity;
others: any remaining interaction).
"""

import numpy as np


def _angle_deg(v):
    return np.degrees(np.arctan2(v[..., 1], v[..., 0]))


def _wrap(deg):
    return (deg + 180.0) % 360.0 - 180.0


def interaction_features(xy: np.ndarray, obs_length: int = 9):
    """Per (pred step, neighbour): distance, frontal angle, heading difference.

    xy: [T, num_tracks, 2] NaN-padded; primary is track 0.
    Returns (dist [P, N], pos_angle [P, N], vel_angle [P, N]) where P is the
    number of prediction steps and angles are degrees relative to the
    primary's heading.
    """
    prim = xy[:, 0]
    neigh = xy[:, 1:]
    pred = slice(obs_length, xy.shape[0])

    prim_vel = prim[pred] - xy[obs_length - 1 : -1, 0]
    heading = _angle_deg(prim_vel)  # [P]

    rel = neigh[pred] - prim[pred][:, None]  # [P, N, 2]
    dist = np.linalg.norm(rel, axis=-1)
    pos_angle = _wrap(_angle_deg(rel) - heading[:, None])

    neigh_vel = neigh[pred] - xy[obs_length - 1 : -1, 1:]
    vel_angle = _wrap(_angle_deg(neigh_vel) - heading[:, None])
    return dist, pos_angle, vel_angle


def check_interaction(xy, pos_range=15.0, dist_thresh=5.0, obs_length=9):
    """Per-neighbour: ever inside the primary's frontal cone within dist."""
    dist, pos_angle, _ = interaction_features(xy, obs_length)
    inside = (dist < dist_thresh) & (np.abs(pos_angle) < pos_range)
    return np.any(np.nan_to_num(inside, nan=False), axis=0)


def leader_follower(xy, pos_range=15.0, dist_thresh=5.0, obs_length=9):
    """Neighbour ahead, moving the same way."""
    dist, pos_angle, vel_angle = interaction_features(xy, obs_length)
    cond = (
        (dist < dist_thresh)
        & (np.abs(pos_angle) < pos_range)
        & (np.abs(vel_angle) < pos_range)
    )
    return np.any(np.nan_to_num(cond, nan=False), axis=0)


def collision_avoidance(xy, pos_range=15.0, dist_thresh=5.0, obs_length=9):
    """Neighbour ahead, moving toward the primary."""
    dist, pos_angle, vel_angle = interaction_features(xy, obs_length)
    cond = (
        (dist < dist_thresh)
        & (np.abs(pos_angle) < pos_range)
        & (np.abs(np.abs(vel_angle) - 180.0) < pos_range)
    )
    return np.any(np.nan_to_num(cond, nan=False), axis=0)


def group(xy, dist_thresh=0.8, std_thresh=0.2, obs_length=9):
    """Side-by-side neighbour at stable short distance."""
    dist, _, _ = interaction_features(xy, obs_length)
    with np.errstate(invalid="ignore"):
        mean_ok = np.nanmean(dist, axis=0) < dist_thresh
        std_ok = np.nanstd(dist, axis=0) < std_thresh
    return np.nan_to_num(mean_ok & std_ok, nan=False)


def others(xy, pos_range=15.0, dist_thresh=5.0, obs_length=9):
    """Interacting neighbours not captured by LF / CA / group."""
    inter = check_interaction(xy, pos_range, dist_thresh, obs_length)
    lf = leader_follower(xy, pos_range, dist_thresh, obs_length)
    ca = collision_avoidance(xy, pos_range, dist_thresh, obs_length)
    grp = group(xy, obs_length=obs_length)
    return inter & ~(lf | ca | grp)


def interaction_type(xy, obs_length: int = 9):
    """Subtype codes present in the scene: 1 LF, 2 CA, 3 group, 4 others."""
    types = []
    if leader_follower(xy, obs_length=obs_length).any():
        types.append(1)
    if collision_avoidance(xy, obs_length=obs_length).any():
        types.append(2)
    if group(xy, obs_length=obs_length).any():
        types.append(3)
    if others(xy, obs_length=obs_length).any():
        types.append(4)
    return types
