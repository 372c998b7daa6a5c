"""The port's training losses against the JAX package's, value and gradient.

Each loss runs in float64 on inputs made with numpy from a seed, with
padded scenes (zeroed normals, ``scene_mask`` off); value and gradient
against ``jax.value_and_grad`` at 1e-12.  ``keep_batch_dim`` losses are
reduced with random weights so every scene's gradient is compared.  The
generative models' losses (BCE, the GAN's two with the label that the JAX
package draws from its key passed to the port, the KL divergence) at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu import losses as jlosses
from trajnetplusplusbaselines_torch import losses

TOL = dict(atol=1e-12, rtol=1e-12)


def _normals(rng, t, s, scene_mask):
    """Predicted normals [T, S, 5] (sigma in 0.01..0.21, rho in 0..0.7, as
    ``hidden2normal`` makes them), zero in padded scenes."""
    raw = np.concatenate([
        rng.normal(scale=0.2, size=(t, s, 2)),
        0.01 + 0.2 * rng.random((t, s, 2)),
        0.7 * rng.random((t, s, 1)),
    ], axis=-1)
    return np.where(scene_mask[None, :, None], raw, 0.0)


def _value_and_grad(fn_torch, fn_jax, x, weights=None):
    """(port value, port grad, jax value, jax grad) of fn(x), reduced with
    ``weights`` where fn returns a vector."""
    def reduce_t(v):
        return v if weights is None else torch.sum(v * torch.from_numpy(weights))

    def reduce_j(v):
        return v if weights is None else jnp.sum(v * weights)

    xt = torch.from_numpy(x).requires_grad_()
    value = reduce_t(fn_torch(xt))
    (grad,) = torch.autograd.grad(value, xt)
    jvalue, jgrad = jax.value_and_grad(lambda a: reduce_j(fn_jax(a)))(jnp.asarray(x))
    return value.detach().numpy(), grad.numpy(), np.asarray(jvalue), np.asarray(jgrad)


def _check(got_v, got_g, want_v, want_g):
    assert np.isfinite(got_g).all()
    np.testing.assert_allclose(got_v, want_v, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)


def test_gaussian_2d_matches_jax():
    rng = np.random.default_rng(0)
    params5 = _normals(rng, 4, 6, np.ones(6, bool))
    xy = rng.normal(scale=0.3, size=(4, 6, 2))
    got = losses.gaussian_2d(torch.from_numpy(params5), torch.from_numpy(xy)).numpy()
    want = np.asarray(jlosses.gaussian_2d(jnp.asarray(params5), jnp.asarray(xy)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("keep_batch_dim", [False, True])
@pytest.mark.parametrize("loss_name", ["prediction_loss", "l2_loss"])
def test_loss_value_and_grad_match_jax(loss_name, keep_batch_dim):
    rng = np.random.default_rng(1)
    t, s = 12, 7
    scene_mask = np.array([1, 1, 0, 1, 0, 1, 1], bool)
    inputs = _normals(rng, t, s, scene_mask)
    targets = np.where(scene_mask[None, :, None], rng.normal(scale=0.2, size=(t, s, 2)), 0.0)
    weights = rng.random(s) if keep_batch_dim else None
    port_fn, jax_fn = getattr(losses, loss_name), getattr(jlosses, loss_name)
    got_v, got_g, want_v, want_g = _value_and_grad(
        lambda x: port_fn(x, torch.from_numpy(targets), torch.from_numpy(scene_mask),
                          keep_batch_dim=keep_batch_dim),
        lambda x: jax_fn(x, jnp.asarray(targets), jnp.asarray(scene_mask),
                         keep_batch_dim=keep_batch_dim),
        inputs, weights)
    _check(got_v, got_g, want_v, want_g)
    assert not got_g[:, ~scene_mask].any()  # padded scenes get no gradient


@pytest.mark.parametrize("loss_name", ["prediction_loss", "l2_loss"])
def test_loss_without_scene_mask_matches_jax(loss_name):
    rng = np.random.default_rng(2)
    inputs = _normals(rng, 12, 3, np.ones(3, bool))
    targets = rng.normal(scale=0.2, size=(12, 3, 2))
    port_fn, jax_fn = getattr(losses, loss_name), getattr(jlosses, loss_name)
    _check(*_value_and_grad(lambda x: port_fn(x, torch.from_numpy(targets)),
                            lambda x: jax_fn(x, jnp.asarray(targets)), inputs))


@pytest.mark.parametrize("loss_name", ["prediction_loss", "l2_loss"])
def test_all_padding_but_one_scene_has_finite_gradients(loss_name):
    """The last batch of a bucket: one real scene, the rest padding with
    zeroed normals (sigma = 0), so the safe lanes must keep 0/0 out."""
    rng = np.random.default_rng(3)
    scene_mask = np.zeros(8, bool)
    scene_mask[0] = True
    inputs = _normals(rng, 12, 8, scene_mask)
    targets = rng.normal(scale=0.2, size=(12, 8, 2))  # the padding's data is scene 0's
    port_fn, jax_fn = getattr(losses, loss_name), getattr(jlosses, loss_name)
    got_v, got_g, want_v, want_g = _value_and_grad(
        lambda x: port_fn(x, torch.from_numpy(targets), torch.from_numpy(scene_mask)),
        lambda x: jax_fn(x, jnp.asarray(targets), jnp.asarray(scene_mask)), inputs)
    _check(got_v, got_g, want_v, want_g)
    assert np.isfinite(got_v) and got_g[:, 0].any() and not got_g[:, 1:].any()


def _collision_inputs(rng, t=12, s=5, a=5):
    """Positions [T, S, A, 2] with neighbours within the hinge distance of the
    primary, absent neighbours and a padded scene; no pair at distance 0."""
    primary = rng.normal(scale=0.5, size=(t, s, 1, 2))
    neighs = primary + rng.uniform(-0.35, 0.35, size=(t, s, a - 1, 2))
    positions = np.concatenate([primary, neighs], axis=2)
    mask = rng.random((t, s, a)) > 0.2
    mask[:, :, 0] = True
    scene_mask = np.ones(s, bool)
    scene_mask[-1] = False
    return positions, mask, scene_mask


@pytest.mark.parametrize("col_wt,col_distance", [(10.0, 0.2), (0.5, 0.3)])
def test_collision_loss_matches_jax(col_wt, col_distance):
    rng = np.random.default_rng(4)
    positions, mask, scene_mask = _collision_inputs(rng)
    got_v, got_g, want_v, want_g = _value_and_grad(
        lambda x: losses.collision_loss(x, torch.from_numpy(mask), torch.from_numpy(scene_mask),
                                        col_wt, col_distance),
        lambda x: jlosses.collision_loss(x, jnp.asarray(mask), jnp.asarray(scene_mask),
                                         col_wt, col_distance),
        positions)
    _check(got_v, got_g, want_v, want_g)
    assert want_v > 0  # some pairs are inside the hinge
    assert not got_g[:, :, 1:].any()  # neighbours are detached
    assert not got_g[:, -1].any()  # the padded scene


def test_collision_loss_at_zero_distance():
    """A neighbour on top of the primary: the port's gradient is finite (0
    from that pair) where JAX's norm gives 0/0 = NaN (ROADMAP Queue 3)."""
    rng = np.random.default_rng(5)
    positions, mask, _ = _collision_inputs(rng, s=2)
    positions[3, 1, 2] = positions[3, 1, 0]
    got_v, got_g, want_v, want_g = _value_and_grad(
        lambda x: losses.collision_loss(x, torch.from_numpy(mask)),
        lambda x: jlosses.collision_loss(x, jnp.asarray(mask)), positions)
    np.testing.assert_allclose(got_v, want_v, **TOL)
    assert np.isfinite(got_g).all() and np.isnan(want_g[3, 1, 0]).all()
    ok = np.ones(got_g.shape[:3], bool)
    ok[3, 1, 0] = False
    np.testing.assert_allclose(got_g[ok], want_g[ok], **TOL)


GEN_TOL = dict(atol=1e-10, rtol=1e-10)


def test_bce_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(scale=4.0, size=(9,))
    logits[0] = 40.0  # where a naive log(sigmoid) overflows
    targets = rng.random(9)
    got_v, got_g, want_v, want_g = _value_and_grad(
        lambda x: losses.bce_loss(x, torch.from_numpy(targets)),
        lambda x: jlosses.bce_loss(x, jnp.asarray(targets)), logits)
    for got, want in ((got_v, want_v), (got_g, want_g)):
        np.testing.assert_allclose(got, want, **GEN_TOL)


@pytest.mark.parametrize("which", ["g", "d"])
def test_gan_losses_match_jax_at_the_same_label(which):
    """The label JAX draws from its key, given to the port as a value."""
    rng = np.random.default_rng(7)
    real, fake = rng.normal(size=(2, 6))
    key = jax.random.PRNGKey(8)
    label_key = key if which == "g" else jax.random.split(key)[0]
    label = float(jax.random.uniform(label_key, (), minval=0.7, maxval=1.2))
    if which == "g":
        port_fn = lambda x: losses.gan_g_loss(x, label)
        jax_fn = lambda x: jlosses.gan_g_loss(x, key)
    else:
        port_fn = lambda x: losses.gan_d_loss(torch.from_numpy(real), x, label)
        jax_fn = lambda x: jlosses.gan_d_loss(jnp.asarray(real), x, key)
    got_v, got_g, want_v, want_g = _value_and_grad(port_fn, jax_fn, fake)
    np.testing.assert_allclose(got_v, want_v, **GEN_TOL)
    np.testing.assert_allclose(got_g, want_g, **GEN_TOL)


def test_smoothed_label_is_drawn_from_the_generator():
    draws = [float(losses.smoothed_label(torch.Generator().manual_seed(seed)))
             for seed in range(64)]
    assert all(0.7 <= y < 1.2 for y in draws) and len(set(draws)) == 64
    assert float(losses.smoothed_label(torch.Generator().manual_seed(3))) == draws[3]


@pytest.mark.parametrize("with_target", [False, True])
def test_kld_loss_matches_jax(with_target):
    rng = np.random.default_rng(9)
    inputs = np.concatenate([rng.normal(size=(5, 4)), 0.01 + rng.random((5, 4))], axis=-1)
    targets = (np.concatenate([rng.normal(size=(5, 4)), rng.normal(scale=0.3, size=(5, 4))],
                              axis=-1) if with_target else None)
    got_v, got_g, want_v, want_g = _value_and_grad(
        lambda x: losses.kld_loss(x, None if targets is None else torch.from_numpy(targets)),
        lambda x: jlosses.kld_loss(x, None if targets is None else jnp.asarray(targets)),
        inputs)
    np.testing.assert_allclose(got_v, want_v, **GEN_TOL)
    np.testing.assert_allclose(got_g, want_g, **GEN_TOL)
