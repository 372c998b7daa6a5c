"""Parameter trees between the JAX package's layout and torch tensors.

Both packages keep parameters as nested dicts (and lists, for MLP stacks) in
the same layout: ``w`` stored ``[in, out]``, LSTM gates in the order i, f, g,
o with separate ``b_ih`` / ``b_hh``.  So a conversion is leaf by leaf.
"""

import numpy as np
import torch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_jax(tree, device=None, dtype=None):
    """Numpy (or any array-like) leaves -> torch tensors, copied."""
    return _map(tree, lambda leaf: torch.tensor(np.asarray(leaf), device=device, dtype=dtype))


def params_to_numpy(tree):
    """Torch tensors -> numpy leaves on the host (the pickle format)."""
    return _map(tree, lambda leaf: leaf.detach().cpu().numpy())


def params_to(tree, device=None, dtype=None):
    """Move every tensor of a parameter tree to a device (and dtype)."""
    return _map(tree, lambda leaf: leaf.to(device=device, dtype=dtype).contiguous())
