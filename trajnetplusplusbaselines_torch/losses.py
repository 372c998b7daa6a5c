"""Training losses on dense ``[time, scene, ...]`` batches.

Port of ``trajnetplusplusbaselines_tpu/losses.py`` (``gaussian_2d``,
``prediction_loss``, ``l2_loss``, ``collision_loss``, and the generative
models' ``bce_loss``, ``gan_g_loss``, ``gan_d_loss``, ``kld_loss``).  The primary is agent
0 of every scene, so callers slice ``[:, :, 0]``; every loss takes a
``scene_mask [S]`` so padded scenes contribute nothing, to the value or to
the gradient.

Kept from the JAX code:
- the mixture with a flat floor: -log(0.01 + 0.2 N(mu, 3) + 0.79 N(mu, sigma));
- masked scenes get a safe unit Gaussian *before* the division, so no
  gradient is NaN (a ``where`` after a 0/0 still back-propagates NaN);
- the L2 multiplier x100;
- the collision hinge below ``col_distance`` with detached neighbours and a
  detached hinge mask.

- the GAN's label smoothing: real labels y ~ U(0.7, 1.2), one draw per
  loss, given as ``label`` or drawn from a ``torch.Generator`` (the JAX
  package draws it from a key);
- the KL divergence against the standard normal, or the stable two-term
  form against a target distribution.

One difference: at a pair distance of exactly zero the JAX collision loss
has a NaN gradient (its norm's derivative is 0/0); the port's distance has
a zero gradient there, so its gradient stays finite (ROADMAP Queue 3).
"""

import math
from typing import Optional

import torch


def gaussian_2d(params5: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Density of a correlated 2D Gaussian. params5 [..., 5], xy [..., 2]."""
    mu1, mu2 = params5[..., 0], params5[..., 1]
    s1, s2, rho = params5[..., 2], params5[..., 3], params5[..., 4]
    norm1 = xy[..., 0] - mu1
    norm2 = xy[..., 1] - mu2
    s1s2 = s1 * s2
    z = (norm1 / s1) ** 2 + (norm2 / s2) ** 2 - 2 * rho * norm1 * norm2 / s1s2
    numerator = torch.exp(-z / (2 * (1 - rho ** 2)))
    denominator = 2 * math.pi * s1s2 * torch.sqrt(1 - rho ** 2)
    return numerator / denominator


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1)


def _all_scenes(s: int, device) -> torch.Tensor:
    return torch.ones((s,), dtype=torch.bool, device=device)


def prediction_loss(
    inputs: torch.Tensor,
    targets: torch.Tensor,
    scene_mask: Optional[torch.Tensor] = None,
    background_rate: float = 0.2,
    keep_batch_dim: bool = False,
) -> torch.Tensor:
    """Gaussian-mixture NLL on primary tracks.

    inputs:  [T, S, 5] predicted normals of the primaries
    targets: [T, S, 2] ground-truth primary velocities
    """
    t, s = targets.shape[0], targets.shape[1]
    if scene_mask is None:
        scene_mask = _all_scenes(s, targets.device)

    # padded scenes carry zeroed normals (sigma = 0): a safe unit Gaussian
    # goes in before the division, so neither value nor gradient is NaN
    safe = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0], dtype=inputs.dtype, device=inputs.device)
    m = scene_mask[None, :, None]
    inputs = torch.where(m, inputs, safe)
    targets = torch.where(m, targets, torch.zeros((), dtype=targets.dtype,
                                                  device=targets.device))

    inputs_bg = torch.cat(
        [inputs[..., 0:2], torch.full_like(inputs[..., 2:4], 3.0),
         torch.zeros_like(inputs[..., 4:5])],
        dim=-1,
    )
    values = -torch.log(
        0.01
        + background_rate * gaussian_2d(inputs_bg, targets)
        + (0.99 - background_rate) * gaussian_2d(inputs, targets)
    )  # [T, S]

    if keep_batch_dim:
        return torch.mean(values, dim=0) * scene_mask  # [S]
    return _masked_mean(values, scene_mask[None, :].expand(t, s))


def l2_loss(
    inputs: torch.Tensor,
    targets: torch.Tensor,
    scene_mask: Optional[torch.Tensor] = None,
    keep_batch_dim: bool = False,
    loss_multiplier: float = 100.0,
) -> torch.Tensor:
    """Primary-only squared error (x100)."""
    s = targets.shape[1]
    if scene_mask is None:
        scene_mask = _all_scenes(s, targets.device)
    sq = (inputs[..., 0:2] - targets) ** 2  # [T, S, 2]
    if keep_batch_dim:
        return torch.mean(sq, dim=(0, 2)) * scene_mask * loss_multiplier
    return _masked_mean(sq, scene_mask[None, :, None].expand(sq.shape)) * loss_multiplier


def collision_loss(
    positions: torch.Tensor,
    position_mask: torch.Tensor,
    scene_mask: Optional[torch.Tensor] = None,
    col_wt: float = 10.0,
    col_distance: float = 0.2,
) -> torch.Tensor:
    """Hinge penalty when the primary prediction approaches neighbour tracks.

    positions: [T, S, A, 2] (primary = agent 0, neighbours detached here)
    position_mask: [T, S, A] validity of each position
    """
    if scene_mask is None:
        scene_mask = _all_scenes(positions.shape[1], positions.device)
    primary = positions[:, :, 0:1, :]
    neighs = positions[:, :, 1:, :].detach()
    sq = torch.sum((primary - neighs) ** 2, dim=-1)  # [T, S, A-1]
    # sqrt(sum(x^2)) as JAX's norm computes it, with a zero gradient at 0
    positive = sq > 0
    d = torch.where(positive, torch.sqrt(torch.where(positive, sq, 1.0)), 0.0)
    valid = position_mask[:, :, 0:1] & position_mask[:, :, 1:]
    valid = valid & scene_mask[None, :, None]
    colliding = ((d <= col_distance) & valid).detach()
    col_val = (1.0 - d / col_distance) * colliding
    return col_wt * torch.sum(col_val)


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE, mean-reduced."""
    neg_abs = -torch.abs(logits)
    loss = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(neg_abs))
    return torch.mean(loss)


def smoothed_label(generator: Optional[torch.Generator] = None, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """One real label y ~ U(0.7, 1.2), drawn from ``generator`` on its device
    and moved to ``device``."""
    gen_device = generator.device if generator is not None else None
    y = torch.rand((), generator=generator, device=gen_device, dtype=dtype)
    return (0.7 + 0.5 * y).to(device)


def gan_g_loss(scores_fake: torch.Tensor, label=None, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generator loss: the fake scores against the smoothed real label
    ``label``, or one drawn from ``generator`` (``smoothed_label``)."""
    if label is None:
        label = smoothed_label(generator, scores_fake.device, scores_fake.dtype)
    return bce_loss(scores_fake, torch.ones_like(scores_fake) * label)


def gan_d_loss(scores_real: torch.Tensor, scores_fake: torch.Tensor, label=None, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Discriminator loss: real scores against the smoothed real label
    (``label`` or drawn from ``generator``), fake scores against zero."""
    if label is None:
        label = smoothed_label(generator, scores_real.device, scores_real.dtype)
    return (bce_loss(scores_real, torch.ones_like(scores_real) * label)
            + bce_loss(scores_fake, torch.zeros_like(scores_fake)))


def kld_loss(inputs: torch.Tensor, targets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL divergence of diagonal Gaussians given ``[S, 2 * latent]`` (mu ++
    log variance); callers pass the primary rows only.  With no target, the
    prior is the standard normal; otherwise the stable two-term form of the
    reference VAE's loss."""
    half = inputs.shape[-1] // 2
    z_mu, z_log_var = inputs[..., :half], inputs[..., half:]
    if targets is None:
        latent = -0.5 * torch.sum(1.0 + z_log_var - z_mu ** 2 - torch.exp(z_log_var), dim=-1)
    else:
        t_mu, t_log_var = targets[..., :half], targets[..., half:]
        z_var, t_var = torch.exp(z_log_var), torch.exp(t_log_var)
        latent = 0.5 * (torch.sum(z_var / t_var, dim=-1)
                        + torch.sum((t_mu - z_mu) ** 2 / t_var, dim=-1))
    return torch.mean(latent)
