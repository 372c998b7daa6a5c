"""The six non-grid pools of the port against the JAX package's ``apply``.

Tiny widths (hidden 16, pool 16, A <= 8) in float64, inputs from a numpy
seed: absent agents, an agent that appears at t, padded slots (``slot_mask``
off), neighbours at the same distance from an agent (top-k ties) and on the
same spot, scenes of fewer agents than ``neigh`` + 1, and a single-track
scene.  Values within 1e-12 and gradients (hidden state and params) within
1e-10; the stateful pools' states too.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.ops.pooling import make_pool as jax_make_pool
from trajnetplusplusbaselines_tpu.ops.pooling.nongrid import _nearest_grid as jax_nearest
from trajnetplusplusbaselines_torch.ops.pooling.nongrid import _nearest_grid
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .torch_parity import TINY_POOL_ARGS, port_pool

ATOL = 1e-12
GRAD_ATOL = 1e-10
H = TINY_POOL_ARGS["hidden_dim"]
TYPES = ["hiddenstatemlp", "attentionmlp", "nn", "nn_lstm", "traj_pool", "nmmp"]


def _inputs(seed, s=4, a=6):
    """One step at [S, A]: scene 0 puts agents 1 and 2 at the same distance
    from agent 0 on opposite sides, and agents 3 and 4 on one spot; scene 1
    holds a single track; scene 2 has two padded slots; the last agent of
    every scene appears at t."""
    rng = np.random.default_rng(seed)
    obs1 = rng.normal(scale=1.5, size=(s, a, 2))
    obs2 = obs1 + rng.normal(scale=0.3, size=(s, a, 2))
    if a > 2:
        obs2[0, 1] = obs2[0, 0] + [0.7, 0.2]
        obs2[0, 2] = obs2[0, 0] - [0.7, 0.2]
    if a > 4:
        obs2[0, 4] = obs2[0, 3]
    p1 = rng.random((s, a)) > 0.15
    p2 = rng.random((s, a)) > 0.1
    p1[:, 0] = p2[:, 0] = True
    p1[0, :5] = p2[0, :5] = True
    p1[:, -1], p2[:, -1] = False, True
    num_agents = np.full(s, a)
    num_agents[1], num_agents[2] = 1, a - 2
    slot = np.arange(a)[None] < num_agents[:, None]
    p1 &= slot
    p2 &= slot
    obs1 = np.where(p1[..., None], obs1, 0.0)
    obs2 = np.where(p2[..., None], obs2, 0.0)
    hidden = rng.normal(size=(s, a, H)) * slot[..., None]
    return obs1, obs2, p1, p2, hidden, slot


def _pools(type_, seed=0, **kw):
    args = types.SimpleNamespace(**{**TINY_POOL_ARGS, **kw})
    jpool = jax_make_pool(type_, args)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jpool.init_params(jax.random.PRNGKey(seed)))
    return jpool, jparams, port_pool(jpool), params_from_jax(jax.tree.map(np.asarray, jparams))


def _state(pool, s, a, seed):
    if not pool.stateful:
        return None
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(scale=0.5, size=(s, a, pool.hidden_dim)) for _ in range(2))


@pytest.mark.parametrize("type_,options", [
    *((t, {}) for t in TYPES),
    ("attentionmlp", {"attn_logit_cap": 0.5}),
    ("nn", {"no_vel": True}),
    ("nn", {"neigh": 2, "pool_dim": 8}),
    ("nn_lstm", {"neigh": 2, "pool_dim": 8}),
])
def test_pools_match_jax(type_, options):
    jpool, jparams, pool, params = _pools(type_, **options)
    for a in (6, 3):  # A=3 is below neigh + 1
        obs1, obs2, p1, p2, hidden, slot = _inputs(a, a=a)
        state = _state(pool, 4, a, a + 1)
        weight = np.random.default_rng(a + 2).normal(size=(4, a, pool.out_dim))

        def jax_loss(params, hidden, state):
            out, new = jpool.apply(params, state, hidden,
                                   *map(jnp.asarray, (obs1, obs2, p1, p2, slot)))
            return jnp.sum(out * weight), (out, new)

        (_, (want, want_state)), want_grads = jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True)(
                jparams, jnp.asarray(hidden),
                None if state is None else tuple(map(jnp.asarray, state)))

        leaves = jax.tree.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_()
        h = torch.from_numpy(hidden).requires_grad_()
        got, got_state = pool.apply(
            params, None if state is None else tuple(map(torch.from_numpy, state)), h,
            *map(torch.from_numpy, (obs1, obs2, p1, p2, slot)))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
        assert (got_state is None) == (want_state is None) == (not pool.stateful)
        for g, w in zip(got_state or (), want_state or ()):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=0)

        grads = torch.autograd.grad((got * torch.from_numpy(weight)).sum(), [h, *leaves],
                                    allow_unused=True, materialize_grads=True)
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_grads[1]),
                                   atol=GRAD_ATOL, rtol=0)
        for g, w in zip(grads[1:], jax.tree.leaves(want_grads[0])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)
        if type_ == "nmmp":  # the single-track scene takes no part
            assert not got[1].any()


def test_nearest_order_with_ties_matches_top_k():
    """The n slots in JAX's ``top_k`` order: nearest first, ties to the
    lower index, coincident neighbours included; zero rows for the agent
    itself and for unobserved neighbours, zero padding when A < n."""
    # agent 0 of the last scene at the origin, every other agent exactly
    # 1.25 m from it, agents 4 and 5 on one spot
    ring = np.array([[0.0, 0.0], [1.25, 0.0], [-1.25, 0.0], [0.75, 1.0], [0.0, -1.25],
                     [0.0, -1.25]])
    for a, n in ((6, 4), (6, 5), (3, 4), (1, 2)):
        obs1, obs2, p1, p2, _, _ = _inputs(20 + a, a=a)
        obs2[3], p1[3], p2[3] = ring[:a], True, True
        want = np.asarray(jax_nearest(*map(jnp.asarray, (obs1, obs2, p1, p2)), n))
        got = _nearest_grid(*map(torch.from_numpy, (obs1, obs2, p1, p2)), n).numpy()
        assert got.shape == want.shape == (4, a, n, 4)
        np.testing.assert_array_equal(got, want)
