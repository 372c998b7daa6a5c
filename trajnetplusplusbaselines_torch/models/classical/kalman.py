"""Kalman-filter predictor: a constant-velocity Kalman filter fitted by EM,
batched over tracks.

Port of ``trajnetplusplusbaselines_tpu/models/classical/kalman.py``.  Per
track: EM-fit the transition and observation covariances and the initial
state (10 iterations) on the observed past, RTS-smooth, then average 5
sampled futures.  State [x, vx, y, vy]; transition and observation models
fixed.

The tracks are one batch axis, ``ys [N, T, 2]`` with a trailing mask
``[N, T]``: where JAX vmaps over the tracks of one scene, ``predict_dataset``
folds every qualifying track of every scene of a dataset into one fit,
whose ~190 serial filter and smoother steps are then paid once per dataset
(per ``TRACKS_PER_FIT`` tracks) instead of once per scene.  A fit makes no
device-to-host sync: inverses come from ``torch.linalg.inv_ex`` (an LU
inverse, as JAX's), each track's last valid state is gathered on the
device, and ``eigh`` runs once per fit.

Compute in f64 (the callers' numpy inputs are f64): the EM floors of
``1e-6 I`` sit next to ``x x^T ~ 1e2`` for positions in metres, where f32
sufficient statistics cancel below the floor.

The sampler's factors are ``V sqrt(clip(W))`` of ``eigh``, as in JAX.  Where
EM drives Q to its floor (a straight track) the eigenvalues are degenerate
and ``V`` is any basis of the eigenspace, which LAPACK and cuSOLVER choose
differently; so samples on two devices agree only given the same factors.
``kf_forecast`` takes the factors and the normals as arguments for that.
Draws come from a ``torch.Generator`` seeded by ``seed``, one stream per
fit (JAX splits ``PRNGKey(seed)`` per scene): sampling parity with JAX is
statistical, or exact given JAX's normals.
"""

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import device_of

N_ITER = 10
N_SAMPLES = 5
TRACKS_PER_FIT = 1 << 16  # a fit's memory: ~20 KB of f64 temporaries a track


class KFParams(NamedTuple):
    q: torch.Tensor  # [N, 4, 4] transition covariance
    r: torch.Tensor  # [N, 2, 2] observation covariance
    mu0: torch.Tensor  # [N, 4]
    sigma0: torch.Tensor  # [N, 4, 4]


def _models(like: torch.Tensor):
    """(A [4, 4], C [2, 4], I4) on ``like``'s device and dtype, made by
    device ops (no host-to-device copy)."""
    eye4 = torch.eye(4, dtype=like.dtype, device=like.device)
    a = eye4.clone()
    a[0, 1] = 1.0
    a[2, 3] = 1.0
    return a, eye4[::2], eye4


def _symmetrize(m):
    return 0.5 * (m + m.mT)


def _inv(m):
    return torch.linalg.inv_ex(m)[0]


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


def kf_filter(params: KFParams, ys: torch.Tensor, mask: torch.Tensor):
    """Masked Kalman filter over ``ys [N, T, 2]``, ``mask [N, T]``.

    Returns filtered means/covs and one-step predicted means/covs, each
    ``[N, T, 4]`` / ``[N, T, 4, 4]``."""
    a, c, eye4 = _models(ys)
    xf, pf, xp, pp = [], [], [], []
    for t in range(ys.shape[1]):
        if t == 0:
            x_pred, p_pred = params.mu0, params.sigma0
        else:
            x_pred = _matvec(a, x)
            p_pred = _symmetrize(a @ p @ a.T + params.q)
        s = c @ p_pred @ c.T + params.r
        k = p_pred @ c.T @ _inv(s)
        innov = ys[:, t] - _matvec(c, x_pred)
        x_upd = x_pred + _matvec(k, innov)
        p_upd = _symmetrize((eye4 - k @ c) @ p_pred)
        m = mask[:, t]
        x = torch.where(m[:, None], x_upd, x_pred)
        p = torch.where(m[:, None, None], p_upd, p_pred)
        xf.append(x)
        pf.append(p)
        xp.append(x_pred)
        pp.append(p_pred)
    return tuple(torch.stack(v, dim=1) for v in (xf, pf, xp, pp))


def kf_smooth(params: KFParams, xf, pf, xp, pp):
    """RTS smoother.  Returns smoothed means/covs ``[N, T, ...]`` and the
    smoother gains ``[N, T-1, 4, 4]`` (gain t pairs step t with t+1).

    The gains depend on the filter alone, so they are one batched product
    over all steps; only the means and covariances recur."""
    a, _, _ = _models(xf)
    js = pf[:, :-1] @ a.T @ _inv(pp[:, 1:])
    x_s, p_s = xf[:, -1], pf[:, -1]
    xs, ps = [x_s], [p_s]
    for t in range(xf.shape[1] - 2, -1, -1):
        j = js[:, t]
        x_s = xf[:, t] + _matvec(j, x_s - xp[:, t + 1])
        p_s = _symmetrize(pf[:, t] + j @ (p_s - pp[:, t + 1]) @ j.mT)
        xs.append(x_s)
        ps.append(p_s)
    return torch.stack(xs[::-1], dim=1), torch.stack(ps[::-1], dim=1), js


def kf_em_step(params: KFParams, ys, mask) -> KFParams:
    """One EM update of (Q, R, mu0, Sigma0) with trailing-masked sequences."""
    a, c, eye4 = _models(ys)
    xf, pf, xp, pp = kf_filter(params, ys, mask)
    xs, ps, js = kf_smooth(params, xf, pf, xp, pp)

    # cross covariance Cov(x_t, x_{t+1} | data) = J_t P^s_{t+1}
    cross = js @ ps[:, 1:]

    # transitions fully inside the valid prefix
    trans_mask = (mask[:, :-1] & mask[:, 1:]).to(ys.dtype)  # [N, T-1]
    n_trans = torch.clamp(trans_mask.sum(dim=1), min=1.0)

    x0, x1 = xs[:, :-1], xs[:, 1:]
    s00 = ps[:, :-1] + _outer(x0, x0)
    s11 = ps[:, 1:] + _outer(x1, x1)
    s10 = cross.mT + _outer(x1, x0)

    q_terms = s11 - s10 @ a.T - a @ s10.mT + a @ s00 @ a.T
    q_new = (q_terms * trans_mask[..., None, None]).sum(dim=1) / n_trans[:, None, None]

    obs_mask = mask.to(ys.dtype)
    n_obs = torch.clamp(obs_mask.sum(dim=1), min=1.0)
    resid = ys - _matvec(c, xs)
    r_terms = _outer(resid, resid) + c @ ps @ c.T
    r_new = (r_terms * obs_mask[..., None, None]).sum(dim=1) / n_obs[:, None, None]

    # the floors keep the inversions well-conditioned where a straight track
    # drives the EM covariances toward zero (JAX's regularization, kept)
    eye2 = eye4[:2, :2]
    return KFParams(_symmetrize(q_new) + 1e-6 * eye4, _symmetrize(r_new) + 1e-6 * eye2,
                    xs[:, 0], _symmetrize(ps[:, 0]) + 1e-6 * eye4)


def kf_init(ys: torch.Tensor) -> KFParams:
    """EM's starting point for every track: Q = 1e-5 I, R = 0.05^2 I, the
    state at the first observation at rest, Sigma0 = I."""
    n = ys.shape[0]
    _, _, eye4 = _models(ys)
    mu0 = torch.zeros(n, 4, dtype=ys.dtype, device=ys.device)
    mu0[:, 0::2] = ys[:, 0]
    return KFParams((1e-5 * eye4).expand(n, 4, 4), (0.05 ** 2 * eye4[:2, :2]).expand(n, 2, 2),
                    mu0, eye4.expand(n, 4, 4))


def kf_fit(ys: torch.Tensor, mask: torch.Tensor, n_iter: int = N_ITER):
    """(fitted KFParams, smoothed state at each track's last valid step
    ``[N, 4]``) after ``n_iter`` EM iterations."""
    params = kf_init(ys)
    for _ in range(n_iter):
        params = kf_em_step(params, ys, mask)
    xs, _, _ = kf_smooth(params, *kf_filter(params, ys, mask))
    last = torch.clamp(mask.sum(dim=1) - 1, min=0)
    x_last = xs.gather(1, last[:, None, None].expand(-1, 1, 4))[:, 0]
    return params, x_last


def psd_factor(m: torch.Tensor) -> torch.Tensor:
    """F with F F^T = m for a symmetric m that may be numerically indefinite:
    ``V sqrt(clip(W, 0))`` from ``eigh`` (a Cholesky would NaN)."""
    w, v = torch.linalg.eigh(m)
    return v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]


def kf_sample(x_last, q_factor, r_factor, normals) -> torch.Tensor:
    """Mean of sampled futures ``[N, P, 2]`` from the smoothed last states
    ``[N, 4]``, given the factors ``[N, 4, 4]`` / ``[N, 2, 2]`` and the
    normals ``[N, n_samples, P, 6]`` (4 for the state, 2 for the
    observation, per step)."""
    a, c, _ = _models(x_last)
    x = x_last[:, None].expand(-1, normals.shape[1], -1)
    q_factor, r_factor = q_factor[:, None], r_factor[:, None]
    samples = []
    for t in range(normals.shape[2]):
        z = normals[:, :, t]
        x = _matvec(a, x) + _matvec(q_factor, z[..., :4])
        samples.append(_matvec(c, x) + _matvec(r_factor, z[..., 4:]))
    return torch.stack(samples, dim=2).mean(dim=1)


def kf_forecast(ys, mask, n_predict: int = 12, n_samples: int = N_SAMPLES,
                normals: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Fit, smooth and sample every track: ``[N, n_predict, 2]``.  The
    normals are drawn from ``generator`` unless given; the factors are
    ``psd_factor`` of the fitted Q and R unless given."""
    params, x_last = kf_fit(ys, mask)
    if factors is None:
        factors = psd_factor(params.q), psd_factor(params.r)
    if normals is None:
        normals = torch.randn((ys.shape[0], n_samples, n_predict, 6), generator=generator,
                              dtype=ys.dtype, device=ys.device)
    return kf_sample(x_last, *factors, normals)


def scene_tracks(paths, obs_length: int = 9):
    """The observed past of each agent the KF predicts, compacted: ``ys
    [n, obs_length, 2]`` and its valid prefix ``mask [n, obs_length]``.
    An agent qualifies when it is present at the last observed frame and has
    at least 2 past points (frame gaps squashed, as the reference's pykalman
    sees consecutive steps); a primary that does not qualify raises."""
    start_frame = paths[0][obs_length - 1].frame
    seqs, masks = [], []
    for i, path in enumerate(paths):
        past = [(r.x, r.y) for r in path if r.frame <= start_frame][:obs_length]
        if start_frame not in [r.frame for r in path] or len(past) < 2:
            if i == 0:
                raise ValueError("primary pedestrian has insufficient past for KF")
            continue
        seq = np.zeros((obs_length, 2))
        seq[: len(past)] = past
        mask = np.zeros(obs_length, bool)
        mask[: len(past)] = True
        seqs.append(seq)
        masks.append(mask)
    return np.stack(seqs), np.stack(masks)


def _output(preds: np.ndarray, predict_all: bool):
    """{0: (primary [n, 2], neighbours [n, k, 2])} of one scene's tracks."""
    neighbours = preds[1:].transpose(1, 0, 2) if len(preds) > 1 else preds[1:]
    return {0: (preds[0], neighbours if predict_all else [])}


def _forecast(ys, mask, n_predict, device, seed, normals=None, factors=None) -> np.ndarray:
    """``kf_forecast`` of numpy tracks on ``device``, one fit per
    ``TRACKS_PER_FIT`` tracks, the draws from one generator seeded by
    ``seed`` unless ``normals`` pins them."""
    dev = device_of(device)
    generator = torch.Generator(dev).manual_seed(seed) if normals is None else None
    pinned = [None if x is None else torch.as_tensor(x).to(dev, torch.float64)
              for x in (normals, *(factors or (None, None)))]
    ys, mask = torch.from_numpy(ys).to(dev), torch.from_numpy(mask).to(dev)
    out = []
    for i in range(0, len(ys), TRACKS_PER_FIT):
        normals, q_factor, r_factor = (None if x is None else x[i:i + TRACKS_PER_FIT]
                                       for x in pinned)
        out.append(kf_forecast(ys[i:i + TRACKS_PER_FIT], mask[i:i + TRACKS_PER_FIT], n_predict,
                               normals=normals, generator=generator,
                               factors=None if factors is None else (q_factor, r_factor)))
    return torch.cat(out).cpu().numpy()


def predict(paths, predict_all: bool = True, n_predict: int = 12, obs_length: int = 9,
            seed: int = 0, normals=None, factors=None, device="cuda"):
    """Path-level API mirroring the JAX package's ``kalman.predict``.

    ``normals [n, 5, n_predict, 6]`` and ``factors`` (``[n, 4, 4]``,
    ``[n, 2, 2]``) pin the draws and the sampler's factors of the scene's
    ``n`` qualifying tracks; by default the normals come from a generator
    seeded by ``seed`` and the factors from the fit."""
    ys, mask = scene_tracks(paths, obs_length)
    return _output(_forecast(ys, mask, n_predict, device, seed, normals, factors), predict_all)


def predict_dataset(scenes: List[list], predict_all: bool = True, n_predict: int = 12,
                    obs_length: int = 9, seed: int = 0, normals=None,
                    device="cuda") -> List[dict]:
    """``predict`` of every scene, with all their qualifying tracks folded
    into one fit per ``TRACKS_PER_FIT`` tracks and one stream of draws.
    ``normals`` (``[sum n, 5, n_predict, 6]``, the scenes' tracks in order)
    pins the draws."""
    if not scenes:
        return []
    tracks = [scene_tracks(paths, obs_length) for paths in scenes]
    counts = np.cumsum([len(ys) for ys, _ in tracks])[:-1]
    preds = _forecast(np.concatenate([ys for ys, _ in tracks]),
                      np.concatenate([m for _, m in tracks]), n_predict, device, seed, normals)
    return [_output(p, predict_all) for p in np.split(preds, counts)]
