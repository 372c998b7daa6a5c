"""Every grid pool option of the port against JAX's ``GridBasedPooling``.

Tiny widths (n 4-6, hidden 16, pool 16, A <= 8) in float64, inputs from a
numpy seed with absent agents, an agent that appears at t, padded slots and
neighbours on exact cell boundaries; JAX runs eagerly, so both sides divide
by the cell side:

- the last-write grid bit-exact for every type, ``front`` and the
  ``pool_size`` sub-division; after the blur and the ``pool_size`` sum
  (``reduce_window`` sums in its own order) within 1e-12;
- ``apply`` through every embedding at 1e-12;
- the social grids' gradients with respect to the hidden state and the
  params within 1e-10 of ``jax.grad``;
- ``lstm_layer``'s state over a few steps, a single-track scene included;
- an even blur through ``make_grid`` only: its map is (n+1)^2, which JAX's
  ``apply`` cannot embed either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .torch_parity import CELL_SIDE, step_inputs

ATOL = 1e-12
GRAD_ATOL = 1e-10
S, A, H = 3, 7, 16
TYPES = ["occupancy", "directional", "social", "dir_social"]


def _inputs(seed, s=S, a=A):
    obs1, obs2, p1, p2 = step_inputs(seed, s, a, n_pad=2)
    rng = np.random.default_rng(seed + 1)
    hidden = rng.normal(size=(s, a, H)) * p2[..., None]
    slot = np.arange(a)[None] < np.array([a - 2] * (s - 1) + [1])[:, None]
    return obs1, obs2, p1, p2, hidden, slot


def _pools(seed=0, **kw):
    kw = {"hidden_dim": H, "cell_side": CELL_SIDE, "n": 4, "out_dim": 16, "latent_dim": 4,
          "layer_dims": [8, 6], "constant": 0.5, **kw}
    jpool = JGrid(**kw)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jpool.init_params(jax.random.PRNGKey(seed)))
    return jpool, jparams, GridBasedPooling(**kw), params_from_jax(jax.tree.map(np.asarray,
                                                                                jparams))


def _jax_grid(jpool, jparams, obs1, obs2, p1, p2, hidden, slot):
    return np.asarray(jpool.make_grid(jnp.asarray(hidden), *map(jnp.asarray, (obs1, obs2, p1,
                                                                               p2)), jparams))


def _port_grid(pool, params, obs1, obs2, p1, p2, hidden, slot):
    return pool.make_grid(*map(torch.from_numpy, (obs1, obs2, p1, p2)),
                          torch.from_numpy(hidden), params).numpy()


def _identity_encoding(jparams, params):
    """The social grids' hidden encoding as the identity (hidden_dim ==
    latent_dim), so that their values, and not only their selection, are
    exact on both sides."""
    eye = np.eye(H)
    jparams = {**jparams, "hidden_dim_encoding": {"w": jnp.asarray(eye),
                                                  "b": jnp.zeros(H)}}
    params = {**params, "hidden_dim_encoding": {"w": torch.from_numpy(eye),
                                                "b": torch.zeros(H, dtype=torch.float64)}}
    return jparams, params


@pytest.mark.parametrize("options", [{}, {"front": True}, {"pool_size": 2}, {"n": 5},
                                     {"blur_size": 3}, {"pool_size": 2, "blur_size": 3}])
@pytest.mark.parametrize("type_", TYPES)
def test_grids_match_jax(type_, options):
    inputs = _inputs(3)
    jpool, jparams, pool, params = _pools(type_=type_, latent_dim=H, **options)
    if "social" in type_:
        jparams, params = _identity_encoding(jparams, params)
    p = options.get("pool_size", 1)
    # the last-write grid, before blur and pool_size: the same grid at side
    # n * pool_size and cell side cell_side / pool_size, bit-exact
    jraw, _, raw_pool, _ = _pools(type_=type_, n=pool.n * p, cell_side=CELL_SIDE / p,
                                  front=pool.front, latent_dim=H)
    want_raw = _jax_grid(jraw, jparams, *inputs)
    got_raw = pool.last_write(*map(torch.from_numpy, inputs[:4]), torch.from_numpy(inputs[4]),
                              params).numpy()
    np.testing.assert_array_equal(got_raw, want_raw)
    assert (want_raw == 0.5).any() and (want_raw != 0.5).any()  # cells hit and the background

    want, got = _jax_grid(jpool, jparams, *inputs), _port_grid(pool, params, *inputs)
    assert got.shape == want.shape == (S, A, pool.pooling_dim, pool.n, pool.n)
    if p == 1 and pool.blur_size == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["one_layer", "two_layer", "three_layer", "None"])
@pytest.mark.parametrize("options", [{}, {"front": True, "blur_size": 3, "pool_size": 2}])
@pytest.mark.parametrize("type_", TYPES)
def test_apply_matches_jax(type_, options, arch):
    obs1, obs2, p1, p2, hidden, slot = _inputs(4)
    jpool, jparams, pool, params = _pools(type_=type_, embedding_arch=arch, **options)
    want, _ = jpool.apply(jparams, None, jnp.asarray(hidden),
                          *map(jnp.asarray, (obs1, obs2, p1, p2, slot)))
    got, state = pool.apply(params, None, torch.from_numpy(hidden),
                            *map(torch.from_numpy, (obs1, obs2, p1, p2, slot)))
    assert state is None and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("type_", ["social", "dir_social"])
def test_social_gradients_match_jax(type_):
    """The winner's value is gathered differentiably: gradients reach the
    hidden state and ``hidden_dim_encoding``; positions get none."""
    obs1, obs2, p1, p2, hidden, slot = _inputs(5)
    jpool, jparams, pool, params = _pools(type_=type_, embedding_arch="two_layer")
    weight = np.random.default_rng(6).normal(size=(S, A, 16))

    def jax_loss(params, hidden):
        out, _ = jpool.apply(params, None, hidden, *map(jnp.asarray, (obs1, obs2, p1, p2, slot)))
        return jnp.sum(out * weight)

    want_params, want_hidden = jax.grad(jax_loss, argnums=(0, 1))(jparams, jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_()
    leaves = jax.tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    out, _ = pool.apply(params, None, h, *map(torch.from_numpy, (obs1, obs2, p1, p2, slot)))
    grads = torch.autograd.grad((out * torch.from_numpy(weight)).sum(), [h, *leaves])
    assert bool(grads[0].abs().sum() > 0)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_hidden), atol=GRAD_ATOL, rtol=0)
    for g, w in zip(grads[1:], jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)
    # the winners' values reach the encoding
    encoding = next(i for i, x in enumerate(leaves) if x is params["hidden_dim_encoding"]["w"])
    assert bool(grads[1 + encoding].abs().sum() > 0)


@pytest.mark.parametrize("type_", ["directional", "social"])
def test_lstm_layer_states_over_steps(type_):
    """The stateful embedding over four steps: only tracks taking part (and
    real slots) update, a single-track scene (the last) contributes zeros
    and keeps its state."""
    jpool, jparams, pool, params = _pools(type_=type_, embedding_arch="lstm_layer")
    jstate, state = jpool.init_state(S, A), pool.init_state(S, A, dtype=torch.float64)
    for step in range(4):
        obs1, obs2, p1, p2, hidden, slot = _inputs(10 + step)
        want, jstate = jpool.apply(jparams, jstate, jnp.asarray(hidden),
                                   *map(jnp.asarray, (obs1, obs2, p1, p2, slot)))
        got, state = pool.apply(params, state, torch.from_numpy(hidden),
                                *map(torch.from_numpy, (obs1, obs2, p1, p2, slot)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        for g, w in zip(state, jstate):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        assert not got[-1].any() and not state[0][-1].any()  # the single-track scene
    assert bool(state[0][0].abs().sum() > 0)


@pytest.mark.parametrize("blur", [2, 4])
def test_even_blur_grows_the_map(blur):
    inputs = _inputs(7)
    jpool, jparams, pool, params = _pools(type_="dir_social", blur_size=blur)
    want, got = _jax_grid(jpool, jparams, *inputs), _port_grid(pool, params, *inputs)
    assert got.shape == want.shape == (S, A, pool.pooling_dim, 5, 5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
