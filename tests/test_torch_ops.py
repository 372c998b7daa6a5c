"""Parity of the port's step primitives and grid pooling with the JAX package.

Eager primitives in float64 at 1e-12; the grids bit-exact, at every agent
bucket, with absent agents, padded slots and neighbours on cell boundaries.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.ops import core as jcore
from trajnetplusplusbaselines_tpu.ops import embeddings as jemb
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_torch.ops import core, embeddings
from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax, params_to_numpy

from .torch_parity import CELL_SIDE, N, step_inputs

ATOL = 1e-12


def _jax_params(init, *args):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), init(jax.random.PRNGKey(3), *args))


def _jax_grid(pool, *inputs):
    """JAX ``make_grid`` with a true division by the cell side, as it runs
    eagerly.  Under jit XLA turns the division by a constant into a multiply
    by its reciprocal, which moves neighbours on a cell boundary one cell
    down; with the cell side traced, the compiled program divides."""
    def fn(cell_side, *x):
        traced = copy.copy(pool)
        traced.cell_side = cell_side
        return traced.make_grid(None, *x, None)

    side = jnp.asarray(pool.cell_side, inputs[1].dtype)
    return jax.jit(fn)(side, *map(jnp.asarray, inputs))


def _np_params(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def test_linear_and_mlp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 7))
    lin = _jax_params(jcore.init_linear, 7, 11)
    np.testing.assert_allclose(
        core.linear(_np_params(lin), torch.from_numpy(x)).numpy(),
        np.asarray(jcore.linear(lin, jnp.asarray(x))), atol=ATOL, rtol=0)
    stack = _jax_params(jcore.init_mlp, [7, 9, 4])
    for final_relu in (True, False):
        np.testing.assert_allclose(
            core.mlp(_np_params(stack), torch.from_numpy(x), final_relu).numpy(),
            np.asarray(jcore.mlp(stack, jnp.asarray(x), final_relu)), atol=ATOL, rtol=0)


def test_lstm_cell():
    rng = np.random.default_rng(1)
    x, h, c = (rng.normal(size=(2, 3, d)) for d in (10, 8, 8))
    cell = _jax_params(jcore.init_lstm_cell, 10, 8)
    jh, jc = jcore.lstm_cell(cell, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    th, tc = core.lstm_cell(_np_params(cell), torch.from_numpy(x),
                            (torch.from_numpy(h), torch.from_numpy(c)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)


def test_input_embedding_and_hidden2normal():
    rng = np.random.default_rng(2)
    vel = rng.normal(size=(4, 6, 2))
    emb = _jax_params(jemb.init_input_embedding, 2, 64)
    got = embeddings.input_embedding(_np_params(emb), torch.from_numpy(vel)).numpy()
    np.testing.assert_allclose(got, np.asarray(jemb.input_embedding(emb, jnp.asarray(vel))),
                               atol=ATOL, rtol=0)
    assert got.shape[-1] == 64 and not got[..., -2:].any()  # two zero tag channels

    hid = rng.normal(scale=3.0, size=(4, 6, 16))
    h2n = _jax_params(jemb.init_hidden2normal, 16)
    got = embeddings.hidden2normal(_np_params(h2n), torch.from_numpy(hid)).numpy()
    np.testing.assert_allclose(got, np.asarray(jemb.hidden2normal(h2n, jnp.asarray(hid))),
                               atol=ATOL, rtol=0)
    assert (got[..., 2:4] >= 0.01).all() and (got[..., 2:4] <= 0.21).all()
    assert (got[..., 4] >= 0).all() and (got[..., 4] <= 0.7).all()


def test_init_bounds_and_seed():
    g = torch.Generator().manual_seed(0)
    cell = core.init_lstm_cell(g, 320, 128)
    assert cell["w_ih"].shape == (320, 512) and cell["w_hh"].shape == (128, 512)
    assert cell["w_ih"].abs().max() <= 1 / np.sqrt(128)
    lin = core.init_linear(torch.Generator().manual_seed(0), 288, 256)
    assert lin["w"].abs().max() <= 1 / np.sqrt(288)
    again = core.init_linear(torch.Generator().manual_seed(0), 288, 256)
    assert torch.equal(lin["w"], again["w"]) and torch.equal(lin["b"], again["b"])


def test_params_round_trip():
    tree = {"a": {"w": np.arange(6.0).reshape(2, 3)}, "stack": [{"b": np.ones(3, np.float32)}]}
    back = params_to_numpy(params_from_jax(tree))
    assert back["a"]["w"].dtype == np.float64 and back["stack"][0]["b"].dtype == np.float32
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
    assert isinstance(back["stack"], list)


@pytest.mark.parametrize("a", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("type_", ["directional", "occupancy"])
def test_grid_bit_exact(type_, a):
    s = 2 if a >= 64 else 4
    obs1, obs2, p1, p2 = step_inputs(a, s, a, n_pad=1 + a // 16)
    kw = dict(type_=type_, n=N, cell_side=CELL_SIDE, out_dim=32, constant=0.25)
    want = np.asarray(_jax_grid(JGrid(**kw), obs1, obs2, p1, p2))
    got = GridBasedPooling(**kw).make_grid(
        torch.from_numpy(obs1), torch.from_numpy(obs2), torch.from_numpy(p1),
        torch.from_numpy(p2)).numpy()
    assert got.shape == want.shape == (s, a, 2 if type_ == "directional" else 1, N, N)
    np.testing.assert_array_equal(got, want)
    # the quirks are exercised: cell 0 holds `constant`, neighbours hit cells
    assert (got[:, :, :, 0, 0] == 0.25).any()
    assert (got != 0.25).any()


def test_grid_matches_eager_jax():
    """The traced-cell-side oracle above is the eager ``make_grid``."""
    obs1, obs2, p1, p2 = step_inputs(8, 4, 8)
    pool = JGrid(type_="directional", n=N, cell_side=CELL_SIDE)
    inputs = tuple(map(jnp.asarray, (obs1, obs2, p1, p2)))
    eager = np.asarray(pool.make_grid(None, *inputs, None))
    np.testing.assert_array_equal(np.asarray(_jax_grid(pool, obs1, obs2, p1, p2)), eager)
    got = GridBasedPooling(type_="directional", n=N, cell_side=CELL_SIDE).make_grid(
        *map(torch.from_numpy, (obs1, obs2, p1, p2)))
    np.testing.assert_array_equal(got.numpy(), eager)


@pytest.mark.parametrize("a", [8, 128])
def test_directional_grid_bit_exact_f32(a):
    obs1, obs2, p1, p2 = step_inputs(7 + a, 2, a, dtype=np.float32)
    kw = dict(type_="directional", n=N, cell_side=CELL_SIDE)
    want = np.asarray(_jax_grid(JGrid(**kw), obs1, obs2, p1, p2))
    got = GridBasedPooling(**kw).make_grid(
        torch.from_numpy(obs1), torch.from_numpy(obs2), torch.from_numpy(p1),
        torch.from_numpy(p2)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("type_", ["directional", "occupancy"])
def test_grid_apply(type_):
    obs1, obs2, p1, p2 = step_inputs(5, 3, 8)
    jpool = JGrid(type_=type_, n=N, cell_side=CELL_SIDE, out_dim=256, hidden_dim=128)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jpool.init_params(jax.random.PRNGKey(0)))
    want, _ = jpool.apply(jparams, None, None, jnp.asarray(obs1), jnp.asarray(obs2),
                          jnp.asarray(p1), jnp.asarray(p2))
    pool = GridBasedPooling(type_=type_, n=N, cell_side=CELL_SIDE, out_dim=256, hidden_dim=128)
    got = pool.apply(_np_params(jparams), torch.from_numpy(obs1), torch.from_numpy(obs2),
                     torch.from_numpy(p1), torch.from_numpy(p2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kwargs", [
    dict(type_="social"), dict(type_="dir_social"), dict(embedding_arch="two_layer"),
    dict(embedding_arch="lstm_layer"), dict(front=True), dict(blur_size=3),
    dict(pool_size=2),
])
def test_grid_configs_not_ported_raise(kwargs):
    with pytest.raises(NotImplementedError):
        GridBasedPooling(**{"type_": "directional", **kwargs})
