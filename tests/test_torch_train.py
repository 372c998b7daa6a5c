"""The port's training path against the JAX package's, on the CPU.

Small widths (grid n=4, embedding 8, hidden 16, pool 16), float64 params,
float32 data as the resident datasets of both packages store it, inputs made
with numpy from a seed:

- the teacher-forced ``forward`` (rel_pred, pred, valid) at 1e-10;
- loss and gradients of ``_loss_from_outputs . _forward_train`` at 1e-10;
- one and three optimizer steps, with a global-norm clip that bites,
  against optax's chain at 1e-9;
- one whole epoch, augmentation off, the port's ``Trainer.train`` against
  JAX's from the same params and seed, parameters at 1e-8;
- the epoch plan and the resident buckets, exactly.

JAX's jitted grid multiplies by the reciprocal of the cell side where eager
JAX and the port divide (ROADMAP Queue 3).  The JAX side therefore runs with
the cell side traced (``torch_parity.with_traced_cell_side``) where the test
builds the jitted function; the epoch test, which runs JAX's own trainer,
uses random-walk scenes, on which no neighbour lands within an ulp of a cell
boundary.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.data.rows import TrackRow
from trajnetplusplusbaselines_tpu.models.lstm import LSTM as JLSTM
from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid
from trajnetplusplusbaselines_tpu.trainers import common as jcommon
from trajnetplusplusbaselines_tpu.trainers.lstm import Trainer as JTrainer
from trajnetplusplusbaselines_torch.trainers import common
from trajnetplusplusbaselines_torch.trainers.lstm import Trainer
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from .torch_parity import example_batch, port_model, with_traced_cell_side

POOLS = ["directional", "occupancy", None]


def _models(pool_type, seed=0):
    pool = None
    if pool_type is not None:
        pool = JGrid(type_=pool_type, hidden_dim=16, cell_side=0.6, n=4, out_dim=16)
    jmodel = JLSTM(pool=pool, embedding_dim=8, hidden_dim=16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           jmodel.init_params(jax.random.PRNGKey(seed)))
    return jmodel, jparams, port_model(jmodel)


def _port_params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _batch(s=4, a=5, seed=0, padded=True, dtype=np.float32):
    """A training batch as the epoch runners gather it: f32 positions
    [21, S, A, 2], masks, scene mask; with ``padded`` the last scene is
    padding (scene 0's data, every mask off)."""
    xy, mask = example_batch(s, a, seed=seed)
    xy = xy.astype(dtype)
    scene = np.ones(s, bool)
    if padded:
        xy[:, -1], mask[:, -1], scene[-1] = xy[:, 0], False, False
    return xy, mask, scene


def _jax_jit(jtrainer, fn):
    """``jax.jit(fn)(trainer, *args)``, the pool's cell side traced; the
    first argument is the params."""
    if jtrainer.model.pool is None:
        return jax.jit(lambda *args: fn(jtrainer, *args))

    def inner(model, *args):
        traced = copy.copy(jtrainer)
        traced.model = model
        return fn(traced, *args)

    return with_traced_cell_side(inner, jtrainer.model)


def _trainers(pool_type, criterion="pred", col_wt=0.0, clip_grad=None, batch_size=4, seed=3):
    jmodel, jparams, model = _models(pool_type)
    jtr = JTrainer(jmodel, jparams, jcommon.make_optimizer(1e-4, clip_grad),
                   jcommon.step_lr(1e-3, 10), criterion=criterion, batch_size=batch_size,
                   augment=False, col_wt=col_wt, seed=seed)
    tr = Trainer(model, _port_params(jparams), common.step_lr(1e-3, 10), criterion=criterion,
                 batch_size=batch_size, augment=False, col_wt=col_wt, seed=seed,
                 clip_grad=clip_grad)
    return jtr, tr


def _jax_loss(jtr, params, xy, mask, scene):
    s, a = xy.shape[1:3]
    goals, slot = jnp.zeros((s, a, 2)), jnp.ones((s, a), bool)
    outputs = jtr._forward_train(params, xy, mask, goals, slot, 0)
    return jtr._loss_from_outputs(*outputs, xy, mask, scene)


def _leaves_close(port_tree, jax_tree, tol, rtol=0.0):
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax_tree))
    got = jax.tree.leaves(jax.tree.map(lambda x: x.detach().numpy(), port_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=tol, rtol=rtol)


@pytest.mark.parametrize("pool_type", POOLS)
def test_teacher_forced_forward_matches_jax(pool_type):
    jmodel, jparams, model = _models(pool_type)
    xy, mask, _ = _batch(s=3, a=6, seed=1, padded=False)
    s, a = xy.shape[1:3]

    def fwd(model, params, xy, mask):
        return model.forward(params, xy[:9], mask[:9], jnp.zeros((s, a, 2)),
                             jnp.ones((s, a), bool), prediction_truth=xy[9:20],
                             prediction_truth_mask=mask[9:20])

    run = (with_traced_cell_side(fwd, jmodel) if pool_type else
           jax.jit(lambda *args: fwd(jmodel, *args)))
    want = run(jparams, jnp.asarray(xy), jnp.asarray(mask))
    x, m = torch.from_numpy(xy), torch.from_numpy(mask)
    got = model.forward(_port_params(jparams), x[:9], m[:9], prediction_truth=x[9:20],
                        prediction_truth_mask=m[9:20])
    rel, pred, valid = (t.numpy() for t in got)
    assert rel.shape == (19, s, a, 5) and pred.shape == (19, s, a, 2)
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    np.testing.assert_allclose(rel, np.asarray(want[0]), atol=1e-10, rtol=0)
    np.testing.assert_allclose(pred, np.asarray(want[1]), atol=1e-10, rtol=0)


def test_teacher_forcing_reads_truth_for_neighbours_only():
    """Neighbours follow the ground truth, the primary its own detached
    prediction: moving a neighbour's future moves the primary's outputs,
    moving the primary's own future does not."""
    _, jparams, model = _models("directional")
    params = _port_params(jparams)
    xy, mask, _ = _batch(s=2, a=4, seed=2, padded=False)

    def rel(x):
        x = torch.from_numpy(x)
        m = torch.from_numpy(mask)
        return model.forward(params, x[:9], m[:9], prediction_truth=x[9:20],
                             prediction_truth_mask=m[9:20])[0]

    base = rel(xy)
    moved = xy.copy()
    moved[12:, :, 0] += 0.3  # the primary's future
    assert torch.equal(rel(moved), base)
    moved = xy.copy()
    moved[12:, :, 1] += 0.3  # a neighbour's future
    assert not torch.equal(rel(moved)[12:, :, 0], base[12:, :, 0])


# The collision term runs in the data's dtype in both packages (the primary's
# predictions are cast into the positions, as JAX's ``.at[].set`` casts
# them).  With f32 data its distances are f32, where XLA may fuse x*x + y*y
# into an FMA: there the loss and gradients agree to f32 rounding, 1e-6
# absolute and relative.
@pytest.mark.parametrize("pool_type,criterion,col_wt,padded,dtype,tol", [
    ("directional", "pred", 0.0, True, np.float32, 1e-10),
    ("directional", "L2", 0.0, True, np.float32, 1e-10),
    ("directional", "pred", 2.0, False, np.float64, 1e-10),
    ("directional", "pred", 2.0, False, np.float32, (1e-6, 1e-6)),
    ("occupancy", "pred", 0.0, True, np.float32, 1e-10),
    (None, "pred", 0.0, True, np.float32, 1e-10),
])
def test_loss_and_grads_match_jax(pool_type, criterion, col_wt, padded, dtype, tol):
    tol, rtol = tol if isinstance(tol, tuple) else (tol, 0.0)
    jtr, tr = _trainers(pool_type, criterion=criterion, col_wt=col_wt)
    xy, mask, scene = _batch(padded=padded, dtype=dtype)
    run = _jax_jit(jtr, lambda t, p, *b: jax.value_and_grad(
        lambda q: _jax_loss(t, q, *b))(p))
    want_loss, want_grads = run(jtr.params, jnp.asarray(xy), jnp.asarray(mask),
                                jnp.asarray(scene))
    loss, grads = tr.loss_and_grads(torch.from_numpy(xy), torch.from_numpy(mask),
                                    torch.from_numpy(scene))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), atol=tol, rtol=rtol)
    by_path = dict(zip(tr.paths, grads))
    grad_tree = jax.tree_util.tree_map_with_path(
        lambda path, _: by_path["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                         for k in path)], jtr.params)
    _leaves_close(grad_tree, want_grads, tol, rtol)
    if col_wt:
        positions = torch.from_numpy(xy[-12:])
        assert bool((torch.linalg.norm(positions[:, :, :1] - positions[:, :, 1:], dim=-1)
                     < 0.2).any())  # the collision term bites


def test_collision_loss_with_padded_scene_has_finite_grads():
    """A padded scene's primary predicts 0 and its absent neighbours sit at
    0: JAX's collision gradient is NaN there (ROADMAP Queue 3), the port's
    is finite."""
    _, tr = _trainers("directional", col_wt=2.0)
    xy, mask, scene = _batch(padded=True)
    _, grads = tr.loss_and_grads(torch.from_numpy(xy), torch.from_numpy(mask),
                                 torch.from_numpy(scene))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_optimizer_steps_match_optax(n_steps):
    """Steps of the port's clip -> Adam(coupled decay) against the JAX step
    core (optax clip_by_global_norm -> add_decayed_weights -> scale_by_adam),
    with a clip that bites at every step."""
    clip = 0.05
    jtr, tr = _trainers("directional", clip_grad=clip)
    batches = [_batch(seed=k, padded=k == 1) for k in range(n_steps)]

    def steps(t, params, opt_state, *flat):
        core = t._train_step_core()
        carry, losses = (params, opt_state), []
        for k in range(n_steps):
            xy, mask, scene = flat[3 * k:3 * k + 3]
            s, a = xy.shape[1:3]
            carry, loss = core(carry, xy, mask, jnp.zeros((s, a, 2)), jnp.ones((s, a), bool),
                               scene, None)
            losses.append(loss)
        return carry[0], jnp.stack(losses)

    flat = [jnp.asarray(x) for b in batches for x in b]
    want_params, want_losses = _jax_jit(jtr, steps)(jtr.params, jtr.opt_state, *flat)
    losses = []
    for xy, mask, scene in batches:
        args = (torch.from_numpy(xy), torch.from_numpy(mask), torch.from_numpy(scene))
        _, grads = tr.loss_and_grads(*args)
        assert float(torch.sqrt(sum((g * g).sum() for g in grads))) > clip
        losses.append(float(tr.train_step(*args)))
    np.testing.assert_allclose(losses, np.asarray(want_losses), atol=1e-9, rtol=0)
    _leaves_close(tr.params, want_params, 1e-9)


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(6)
    tree = [rng.normal(size=(3, 4)), rng.normal(size=(5,))]
    norm = float(np.sqrt(sum((x ** 2).sum() for x in tree)))
    for max_norm in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(x) for x in tree],
                                                             None)
        got = common.clip_by_global_norm([torch.from_numpy(x) for x in tree], max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-15, rtol=1e-15)


def _scenes(seed, sizes):
    """(filename, scene id, paths) of random-walk scenes of ``sizes``
    agents, 21 frames, some agents appearing late."""
    rng = np.random.default_rng(seed)
    scenes = []
    for sid, n in enumerate(sizes):
        xy = rng.normal(scale=0.15, size=(21, n, 2)).cumsum(axis=0)
        xy += rng.uniform(-2, 2, size=(1, n, 2))
        paths = []
        for p in range(n):
            first = 0 if p == 0 else int(rng.choice([0, 0, 2, 6]))
            paths.append([TrackRow(10 * f, 100 * sid + p, float(xy[f, p, 0]),
                                   float(xy[f, p, 1])) for f in range(first, 21)])
        scenes.append(("synth", sid, paths))
    return scenes


def test_epoch_plan_and_buckets_match_jax():
    scenes = _scenes(7, [2, 3, 5, 4, 7, 3, 9, 2, 6])
    jres = jcommon.ResidentDataset(jcommon.SceneDataset(scenes, None, 9, False))
    res = common.ResidentDataset(common.SceneDataset(scenes, 9, False), "cpu")
    assert list(res.buckets) == list(jres.buckets) == [(21, 4), (21, 8), (21, 16)]
    for key, data in res.buckets.items():
        np.testing.assert_array_equal(data["xs"].numpy(), np.asarray(jres.buckets[key]["xs"]))
        np.testing.assert_array_equal(data["mask"].numpy(),
                                      np.asarray(jres.buckets[key]["mask"]))
        np.testing.assert_array_equal(data["num_agents"].numpy(),
                                      np.asarray(jres.buckets[key]["num_agents"]))
    for shuffle in (True, False, True):
        jrng, rng = np.random.default_rng(11), np.random.default_rng(11)
        want, got = jres.epoch_plan(3, jrng, shuffle), res.epoch_plan(3, rng, shuffle)
        for key in want:
            np.testing.assert_array_equal(got[key][0], want[key][0])
            np.testing.assert_array_equal(got[key][1], want[key][1])
        assert rng.integers(1 << 30) == jrng.integers(1 << 30)


def test_one_epoch_matches_jax_trainer():
    """JAX's ``Trainer.train`` (its resident epoch, one scan per bucket) and
    the port's, from the same params and seed: the same batches in the same
    order, padded last batches included."""
    scenes = _scenes(8, [2, 3, 4, 3, 2, 4, 3, 6, 5, 7])  # buckets A=4 (7 scenes), A=8 (3)
    jtr, tr = _trainers("directional", batch_size=3, seed=5)
    jtr.train(jcommon.SceneDataset(scenes, None, 9, False), 0)
    tr.train(common.SceneDataset(scenes, 9, False), 0)
    _leaves_close(tr.params, jtr.params, 1e-8)


def test_augmentation_invariants():
    """Rotation keeps every pairwise distance; noise lands only on the
    neighbours' observed frames, within +-0.02; padded scenes stay off."""
    scenes = _scenes(9, [3, 4, 2, 4, 3])
    res = common.ResidentDataset(common.SceneDataset(scenes, 9, False), "cpu")
    data = res.buckets[(21, 4)]
    idx, valid = res.epoch_plan(2, np.random.default_rng(0), shuffle=False)[(21, 4)]
    plain = list(common.bucket_batches(data, idx, valid))
    gen = torch.Generator().manual_seed(0)
    rotated = list(common.bucket_batches(data, idx, valid, augment=True, generator=gen))
    noisy = list(common.bucket_batches(data, idx, valid, augment_noise=True, generator=gen))
    assert len(plain) == 3 and not plain[-1].scene_mask[1]  # 5 scenes: the last batch is padded
    assert not plain[-1].slot_mask[1].any()  # a padded scene has no real slot
    for (xy, mask, scene, goals, slot), (rxy, rmask, rscene, rgoals, rslot), \
            (nxy, nmask, _, ngoals, _) in zip(plain, rotated, noisy):
        assert torch.equal(mask, rmask) and torch.equal(scene, rscene) and torch.equal(mask, nmask)
        assert torch.equal(slot, rslot) and torch.equal(goals, ngoals)
        assert goals.shape == (2, 4, 2) and not goals.any()  # no goal files: zero goals
        dist = torch.cdist(xy.reshape(-1, 4, 2), xy.reshape(-1, 4, 2))
        rdist = torch.cdist(rxy.reshape(-1, 4, 2), rxy.reshape(-1, 4, 2))
        torch.testing.assert_close(rdist, dist, atol=1e-5, rtol=0)
        assert not torch.equal(rxy, xy)
        noise = nxy - xy
        assert bool((noise.abs() <= 0.02 + 1e-6).all())
        assert not noise[:, :, 0].any() and not noise[9:].any()
        assert bool(noise[:9, :, 1:].any())
