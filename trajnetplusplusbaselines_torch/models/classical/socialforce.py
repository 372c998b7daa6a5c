"""Social-force predictor (Helbing & Molnar 1995), batched over scenes.

Port of ``trajnetplusplusbaselines_tpu/models/classical/socialforce.py``:
20 fps simulation with a ped-ped interaction potential V(b) = v0 exp(-b /
sigma) (b the ellipse semi-minor axis), its gradient a forward difference
at delta = 1e-3, field-of-view weighting (200 degrees, 0.5 out-of-view
factor), relaxation to the desired velocity with time constant tau, a 1.3x
speed cap, subsampled back to 2.5 fps.

The state is ``[S, A, 7]`` (x, y, vx, vy, dx, dy, tau) and the pairs
``[S, A, A, 2]``: ``predict_dataset`` groups a dataset's scenes by agent
bucket and simulates each bucket as one batch of 96 steps, at most
``PAIRS_PER_CALL`` agent pairs at a time.  The host prepares each scene's
initial state (velocity from the stride-3 difference, destination per
``dest_type``) in numpy, as in JAX.

Compute in f64 (the prepared states are f64): the forward difference at
delta = 1e-3 loses about three digits, which f32 cannot spare.
"""

import math
from typing import List

import numpy as np
import torch

from ...data.batching import agent_bucket
from . import device_of

MAX_SPEED_MULTIPLIER = 1.3
OUT_OF_VIEW_FACTOR = 0.5
TWO_PHI_DEG = 200.0
FPS = 20
SAMPLING_RATE = int(FPS / 2.5)  # simulation steps per predicted frame
FAR = 1e6  # where pad agents are parked, metres
PAIRS_PER_CALL = 1 << 20  # S * A^2 of one simulation; ~10 [3, S, A, A, 2] f64 temporaries


def desired_directions(state):
    """Unit vectors ``[..., A, 2]`` from each agent to its destination
    (zero where it stands on it)."""
    diff = state[..., 4:6] - state[..., 0:2]
    norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    return torch.where(norm > 0, diff / torch.where(norm > 0, norm, 1.0), 0.0)


def _pedped_value(r_ab, speeds, dirs, delta_t, v0, sigma, off_diagonal):
    """V(b) ``[..., S, A, A]`` over pairwise displacements
    ``r_ab[..., s, a, b] = r_a - r_b`` (any leading axes), the speeds
    ``[S, A]`` and directions ``[S, A, 2]`` of the agents b."""
    speeds_b = speeds[..., None, :, None]  # [S, 1, A, 1]
    e_b = dirs[..., None, :, :]  # [S, 1, A, 2]
    moved = r_ab - delta_t * speeds_b * e_b
    norm_r = torch.linalg.vector_norm(r_ab, dim=-1)
    norm_m = torch.linalg.vector_norm(moved, dim=-1)
    in_sqrt = (norm_r + norm_m) ** 2 - (delta_t * speeds[..., None, :]) ** 2
    b = 0.5 * torch.sqrt(torch.clamp(in_sqrt, min=1e-12))
    value = v0 * torch.exp(-b / sigma)
    return value * off_diagonal  # no self-interaction


def pedped_grad(r_ab, speeds, dirs, delta_t, v0, sigma, delta=1e-3):
    """Forward-difference gradient ``[S, A, A, 2]`` of V with respect to
    ``r_ab`` (the external package's scheme).  V at r, r + (delta, 0) and
    r + (0, delta) is one evaluation over a leading axis of 3."""
    a = r_ab.shape[-2]
    off_diagonal = 1.0 - torch.eye(a, dtype=r_ab.dtype, device=r_ab.device)
    shifted = r_ab.unsqueeze(0).repeat(3, *([1] * r_ab.dim()))
    shifted[1, ..., 0] += delta
    shifted[2, ..., 1] += delta
    v = _pedped_value(shifted, speeds, dirs, delta_t, v0, sigma, off_diagonal)
    return torch.stack([(v[1] - v[0]) / delta, (v[2] - v[0]) / delta], dim=-1)


def field_of_view_weights(e, f, twophi_deg=TWO_PHI_DEG, out_factor=OUT_OF_VIEW_FACTOR):
    """Weights ``[S, A, A]``: 1 for a force ``f[s, a, b]`` inside agent a's
    2 phi field of view around its direction ``e[s, a]``, else out_factor."""
    cos_phi = math.cos(math.radians(0.5 * twophi_deg))
    in_sight = (e[..., :, None, :] * f).sum(dim=-1) > cos_phi * torch.linalg.vector_norm(f, dim=-1)
    return torch.where(in_sight, 1.0, out_factor)


def simulate(initial_state, n_steps: int, delta_t: float, v0: float, sigma: float):
    """Run the social-force model on ``[S, A, 7]`` states; returns the
    states after each step, ``[n_steps, S, A, 7]``."""
    initial_speeds = torch.linalg.vector_norm(initial_state[..., 2:4], dim=-1)
    max_speeds = MAX_SPEED_MULTIPLIER * initial_speeds

    def step(state):
        e = desired_directions(state)
        vel = state[..., 2:4]
        tau = state[..., 6:7]
        f0 = (initial_speeds[..., None] * e - vel) / tau

        r_ab = state[..., :, None, 0:2] - state[..., None, :, 0:2]
        f_ab = -pedped_grad(r_ab, initial_speeds, e, delta_t, v0, sigma)
        w = field_of_view_weights(e, -f_ab)
        f_ped = (w[..., None] * f_ab).sum(dim=-2)

        force = f0 + f_ped
        desired_velocity = vel + delta_t * force
        speed = torch.linalg.vector_norm(desired_velocity, dim=-1)
        factor = torch.clamp(max_speeds / torch.clamp(speed, min=1e-12), max=1.0)
        new_vel = desired_velocity * factor[..., None]
        return torch.cat([state[..., 0:2] + new_vel * delta_t, new_vel, state[..., 4:]], dim=-1)

    states = [initial_state]
    for _ in range(n_steps):
        states.append(step(states[-1]))
    return torch.stack(states[1:])


def _dest_by_interpolation(xs, ys, pred_length):
    """Linear extrapolation from the last two points (scipy interp1d style)."""
    if len(xs) == 1:
        return [xs[-1], ys[-1]]
    dx = xs[-1] - xs[-2]
    dy = ys[-1] - ys[-2]
    return [xs[-1] + dx * pred_length, ys[-1] + dy * pred_length]


def initial_state(input_paths, dest_dict=None, dest_type="interp", n_predict=12,
                  obs_length=9) -> np.ndarray:
    """Rows (x, y, vx, vy, dx, dy, speed) ``[n, 7]`` f64 of the agents present
    at the last observed frame, the primary first: the position there, the
    velocity of the stride-3 difference (shorter for a shorter past), and
    the destination by ``dest_type`` (``interp``: extrapolated from the last
    two points; ``true``: ``dest_dict`` by pedestrian; ``vel``: the velocity
    times ``n_predict``; ``pred_end``: the path's last future row)."""
    start_frame = input_paths[0][obs_length - 1].frame
    rows = []
    for path in input_paths:
        ped_id = path[0].pedestrian
        past = [t for t in path if t.frame <= start_frame]
        future = [t for t in path if t.frame > start_frame]
        if start_frame not in [t.frame for t in past]:
            continue
        curr = past[-1]

        if len(past) >= 4:
            stride, prev = 3, past[-4]
        else:
            stride, prev = len(past) - 1, past[-len(past)]
        if stride == 0:
            v_x = v_y = speed = 0.0
        else:
            diff = np.array([curr.x - prev.x, curr.y - prev.y])
            theta = np.arctan2(diff[1], diff[0])
            speed = float(np.linalg.norm(diff) / (stride * 0.4))
            v_x, v_y = speed * np.cos(theta), speed * np.sin(theta)

        if dest_type == "true":
            if dest_dict is None:
                raise ValueError("dest_dict required for dest_type='true'")
            d_x, d_y = dest_dict[ped_id]
        elif dest_type == "interp":
            d_x, d_y = _dest_by_interpolation(
                [t.x for t in past], [t.y for t in past], n_predict
            )
        elif dest_type == "vel":
            d_x, d_y = n_predict * v_x, n_predict * v_y
        elif dest_type == "pred_end":
            d_x, d_y = future[-1].x, future[-1].y
        else:
            raise NotImplementedError(dest_type)
        rows.append([curr.x, curr.y, v_x, v_y, d_x, d_y, speed])
    return np.asarray(rows, dtype=np.float64)


def pack_bucket(states, agents: int, tau: float) -> np.ndarray:
    """Simulation states ``[S, agents, 7]`` of scenes' ``[n, 6+]`` initial
    states (x, y, vx, vy, dx, dy), time constant ``tau``.

    Pad agents park at FAR, at rest, with their destination there: the
    potential between one and a real agent, v0 exp(-~FAR / sigma),
    underflows to exactly 0 in f64, and so does its forward difference, so
    a pad exerts no force on a real agent and the padding changes no real
    agent's result."""
    packed = np.zeros((len(states), agents, 7))
    packed[:, :, [0, 1, 4, 5]] = FAR
    packed[..., 6] = tau
    for j, state in enumerate(states):
        packed[j, : len(state), :6] = state[:, :6]
    return packed


def predict_dataset(scenes: List[list], dest_dict=None, dest_type="interp",
                    sf_params=(0.5, 2.1, 0.3), predict_all=True, n_predict=12, obs_length=9,
                    device="cuda") -> List[dict]:
    """``predict`` of every scene: the scenes grouped by agent bucket (a
    scene above the largest bucket alone at its own size), each bucket
    simulated as one batch of at most ``PAIRS_PER_CALL`` agent pairs."""
    dev = device_of(device)
    tau, v0, sigma = sf_params
    states = [initial_state(paths, dest_dict, dest_type, n_predict, obs_length)
              for paths in scenes]
    buckets = {}
    for i, state in enumerate(states):
        buckets.setdefault(max(agent_bucket(len(state)), len(state)), []).append(i)

    out = [None] * len(scenes)
    for a, members in buckets.items():
        chunk = max(1, PAIRS_PER_CALL // (a * a))
        for start in range(0, len(members), chunk):
            idx = members[start:start + chunk]
            packed = pack_bucket([states[i] for i in idx], a, tau)
            sim = simulate(torch.from_numpy(packed).to(dev), n_predict * SAMPLING_RATE,
                           1.0 / FPS, v0, sigma)
            # the states after steps 1, 9, ..., 89: JAX's and the reference's
            # subsampling, kept as it is
            xy = sim[::SAMPLING_RATE, ..., 0:2].cpu().numpy()
            for j, i in enumerate(idx):
                scene = xy[:, j, : len(states[i])]
                out[i] = {0: (scene[:, 0], scene[:, 1:] if predict_all else [])}
    return out


def predict(input_paths, dest_dict=None, dest_type="interp", sf_params=(0.5, 2.1, 0.3),
            predict_all=True, n_predict=12, obs_length=9, device="cuda"):
    """Path-level API mirroring the JAX package's ``socialforce.predict``."""
    return predict_dataset([input_paths], dest_dict, dest_type, sf_params, predict_all,
                           n_predict, obs_length, device)[0]
