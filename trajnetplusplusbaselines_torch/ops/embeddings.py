"""Input embedding and Gaussian output head.

Port of ``trajnetplusplusbaselines_tpu/ops/embeddings.py``:
- ``input_embedding``: linear+ReLU on velocities scaled by 4, with two
  trailing zero "tag" channels;
- ``hidden2normal``: hidden state -> (mu_x, mu_y, sigma_1, sigma_2, rho) with
  sigma = 0.01 + 0.2 * sigmoid and rho = 0.7 * sigmoid.
"""

from typing import Dict

import torch

from .core import init_linear, linear


def init_input_embedding(generator: torch.Generator, input_dim: int, embedding_dim: int,
                         use_tags: bool = True, device=None, dtype=torch.float32) -> Dict:
    linear_dim = embedding_dim - 2 if use_tags else embedding_dim
    return {"linear": init_linear(generator, input_dim, linear_dim, device=device, dtype=dtype)}


def input_embedding(params: Dict, vel: torch.Tensor, scale: float = 4.0,
                    use_tags: bool = True) -> torch.Tensor:
    emb = torch.relu(linear(params["linear"], vel * scale))
    if not use_tags:
        return emb
    tags = emb.new_zeros(vel.shape[:-1] + (2,))
    return torch.cat([emb, tags], dim=-1)


def init_hidden2normal(generator: torch.Generator, hidden_dim: int, device=None,
                       dtype=torch.float32) -> Dict:
    return {"linear": init_linear(generator, hidden_dim, 5, device=device, dtype=dtype)}


def hidden2normal(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    raw = linear(params["linear"], hidden)
    mu = raw[..., 0:2]
    sigma = 0.01 + 0.2 * torch.sigmoid(raw[..., 2:4])
    rho = 0.7 * torch.sigmoid(raw[..., 4:5])
    return torch.cat([mu, sigma, rho], dim=-1)
