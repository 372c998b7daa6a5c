"""Shared inputs for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both sides; parameters
are made by the JAX package and converted with ``params_from_jax``.  jax is
imported only inside the functions that need it, so the card tests can import
this module where jax is not installed.
"""

import copy

import numpy as np
import torch

from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

# the tests run beside five other pytest workers
torch.set_num_threads(2)

CELL_SIDE = 0.6
N = 12


def step_inputs(seed, s, a, n_pad=1, dtype=np.float64, boundary=True):
    """(obs1, obs2, present1, present2) for one step at [S, A]: absent agents,
    ``n_pad`` padded slots at the highest j, a crowd dense enough for cell
    collisions and, with ``boundary``, neighbours placed on exact multiples
    of the cell side."""
    rng = np.random.default_rng(seed)
    obs1 = rng.normal(scale=1.5, size=(s, a, 2))
    obs2 = obs1 + rng.normal(scale=0.3, size=(s, a, 2))
    if boundary:
        # agents 1..3 whole numbers of cells from agent 0, which sits at the
        # origin in even scenes and at a multiple of the cell side in odd
        # ones, so that many offsets divide exactly
        m = min(a, 4)
        k = rng.integers(-7, 8, size=(s, m, 2))
        k[:, 0] = 0
        base = CELL_SIDE * rng.integers(-3, 4, size=(s, 1, 2))
        base[::2] = 0.0
        obs2[:, :m] = base + CELL_SIDE * k
    p1 = rng.random((s, a)) > 0.2
    p2 = rng.random((s, a)) > 0.2
    p1[:, 0] = p2[:, 0] = True
    if a > 1:
        p1[:, a - n_pad:] = p2[:, a - n_pad:] = False
    obs1 = np.where(p1[..., None], obs1, 0.0).astype(dtype)
    obs2 = np.where(p2[..., None], obs2, 0.0).astype(dtype)
    return obs1, obs2, p1, p2


def example_batch(s, a, t=21, seed=0):
    """``__graft_entry__._example_batch``'s scenes (one late-appearing agent
    per scene) plus an agent absent in the middle and a padded slot."""
    rng = np.random.default_rng(seed)
    xy = rng.normal(size=(t, s, a, 2)).cumsum(axis=0) * 0.1
    mask = np.ones((t, s, a), bool)
    mask[: t // 3, :, -1] = False
    if a > 2:
        mask[4:6, :, 1] = False
        mask[:, -1, -2] = False  # padded slot in the last scene
    xy = np.where(mask[..., None], xy, 0.0)
    return xy, mask


def flagship_params(seed=0, dtype=np.float64):
    """A JAX D-LSTM (the flagship configuration) with its params, and the
    same params as torch tensors."""
    import jax
    import jax.numpy as jnp

    from trajnetplusplusbaselines_tpu.models.lstm import LSTM
    from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling

    pool = GridBasedPooling(type_="directional", hidden_dim=128, cell_side=CELL_SIDE,
                            n=N, out_dim=256)
    model = LSTM(pool=pool, embedding_dim=64, hidden_dim=128)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                          model.init_params(jax.random.PRNGKey(seed)))
    return model, params, params_from_jax(jax.tree.map(np.asarray, params))


def with_traced_cell_side(fn, model):
    """``jax.jit(fn)(model, *args)`` with the pool's cell side traced, so the
    compiled program divides by it as the eager JAX code does (XLA rewrites a
    division by a constant into a multiply by its reciprocal)."""
    import jax
    import jax.numpy as jnp

    def run(*args):
        def inner(cell_side, *a):
            traced = copy.copy(model)
            traced.pool = copy.copy(model.pool)
            traced.pool.cell_side = cell_side
            return fn(traced, *a)

        dtype = jax.tree.leaves(args[0])[0].dtype
        return jax.jit(inner)(jnp.asarray(model.pool.cell_side, dtype), *args)

    return run


def port_model(jax_model):
    """The port's counterpart of a JAX LSTM configuration."""
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    pool = None
    if jax_model.pool is not None:
        jp = jax_model.pool
        pool = GridBasedPooling(type_=jp.type_, hidden_dim=jp.hidden_dim,
                                cell_side=jp.cell_side, n=jp.n, out_dim=jp.out_dim)
    return LSTM(embedding_dim=jax_model.embedding_dim, hidden_dim=jax_model.hidden_dim,
                pool=pool)
