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


def write_goal_files(data_dir, goal_root="goal_files", subsets=("train", "val", "test_private")):
    """Goal files for the ndjson files of ``data_dir/<subset>/``, as the
    trainers and the evaluator read them: ``goal_root/<subset>/<file>.pkl``,
    a dict from pedestrian id to the last position of its track."""
    import os
    import pickle

    from trajnetplusplusbaselines_tpu.data import Reader

    for subset in subsets:
        out = os.path.join(goal_root, subset)
        os.makedirs(out, exist_ok=True)
        for name in sorted(os.listdir(os.path.join(data_dir, subset))):
            if not name.endswith(".ndjson"):
                continue
            goals = {}
            for _, paths in Reader(os.path.join(data_dir, subset, name),
                                   scene_type="paths").scenes():
                for path in paths:
                    goals[path[0].pedestrian] = (path[-1].x, path[-1].y)
            with open(os.path.join(out, name[:-len(".ndjson")] + ".pkl"), "wb") as f:
                pickle.dump(goals, f)


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


def port_pool(jax_pool):
    """The port's counterpart of a JAX pool configuration (any of the
    eleven types' pool classes), built from its attributes."""
    from trajnetplusplusbaselines_torch.ops import pooling
    from trajnetplusplusbaselines_torch.utils.checkpoint import from_attributes

    if jax_pool is None:
        return None
    return from_attributes(getattr(pooling, type(jax_pool).__name__), vars(jax_pool))


def port_model(jax_model):
    """The port's counterpart of a JAX model configuration: an LSTM, an
    SGAN (with its generator and discriminator), or a VAE."""
    from trajnetplusplusbaselines_torch.models import lstm, sgan, vae
    from trajnetplusplusbaselines_torch.utils.checkpoint import from_attributes

    port_class = {"LSTM": lstm.LSTM, "LSTMGenerator": sgan.LSTMGenerator,
                  "LSTMDiscriminator": sgan.LSTMDiscriminator, "SGAN": sgan.SGAN,
                  "VAE": vae.VAE}[type(jax_model).__name__]
    attrs = dict(vars(jax_model))
    if "pool" in attrs:
        attrs["pool"] = port_pool(attrs["pool"])
    for key in ("generator", "discriminator"):
        if key in attrs:
            attrs[key] = port_model(attrs[key])
    return from_attributes(port_class, attrs)


# tiny trainer arguments for every pool type: pool_dim a multiple of neigh
# (the nearest-neighbour pools embed each of the n slots into pool_dim / n)
TINY_POOL_ARGS = dict(hidden_dim=16, pool_dim=16, n=4, cell_side=CELL_SIDE, vel_dim=4,
                      spatial_dim=4, neigh=4, mp_iters=2, latent_dim=4, layer_dims=[8, 8])

# the eleven --type values, and the model variants of the parity tests:
# name -> (type, make_pool args over TINY_POOL_ARGS, LSTM args)
POOL_MODELS = {
    **{t: (t, {}, {}) for t in ("vanilla", "occupancy", "directional", "social",
                                "dir_social", "hiddenstatemlp", "attentionmlp", "nn",
                                "nn_lstm", "traj_pool", "nmmp")},
    "goals": ("directional", {}, {"goal_flag": True, "goal_dim": 6}),
    "pool_to_input_false": ("directional", {}, {"pool_to_input": False}),
    "two_layer": ("directional", {"embedding_arch": "two_layer"}, {}),
    "lstm_layer": ("directional", {"embedding_arch": "lstm_layer"}, {}),
}


def jax_pool_model(name, seed=0, dtype=np.float64):
    """A tiny JAX LSTM of ``POOL_MODELS[name]``, its params in ``dtype``, and
    the same params as torch tensors."""
    import types

    import jax
    import jax.numpy as jnp

    from trajnetplusplusbaselines_tpu.models.lstm import LSTM
    from trajnetplusplusbaselines_tpu.ops.pooling import make_pool

    type_, pool_args, lstm_args = POOL_MODELS[name]
    pool = make_pool(type_, types.SimpleNamespace(**{**TINY_POOL_ARGS, **pool_args}))
    model = LSTM(pool=pool, embedding_dim=8, hidden_dim=16, **lstm_args)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                          model.init_params(jax.random.PRNGKey(seed)))
    return model, params, params_from_jax(jax.tree.map(np.asarray, params))


def jax_runner(fn, model):
    """``jax.jit(fn)(model, *args)``; for a grid pool with its cell side
    traced (``with_traced_cell_side``)."""
    import jax

    if getattr(model.pool, "cell_side", None) is None:
        return jax.jit(lambda *args: fn(model, *args))
    return with_traced_cell_side(fn, model)


def pool_batch(s=4, a=5, t=21, seed=0):
    """Scenes as a bucket holds them, for whole-model parity: xy [t, S, A, 2],
    mask [t, S, A], goals [S, A, 2], slot_mask [S, A].  Scene 0 is full, with
    agent 0's goal on its last observed position (a zero goal distance);
    scene 1 holds a single track; scene 2 has one padded slot; every scene
    has a late-appearing agent and an agent absent mid-way where it has
    room."""
    xy, mask = example_batch(s, a, t=t, seed=seed)
    num_agents = np.full(s, a)
    num_agents[1] = 1
    if s > 2:
        num_agents[2] = a - 1
    slot_mask = np.arange(a)[None] < num_agents[:, None]
    mask &= slot_mask[None]
    mask[:, 1, 0] = True
    xy = np.where(mask[..., None], xy, 0.0)
    rng = np.random.default_rng(seed + 100)
    goals = np.where(slot_mask[..., None], rng.normal(scale=2.0, size=(s, a, 2)), 0.0)
    goals[0, 0] = xy[8, 0, 0]
    return xy, mask, goals, slot_mask


# the generative models' tiny widths beside TINY_POOL_ARGS
TINY_NOISE_DIM, TINY_LATENT = 4, 8


def jax_generative(kind, pool_type="directional", seed=0, k=3, dtype=np.float64, **model_args):
    """A tiny JAX SGAN (``kind="sgan"``: generator and discriminator with a
    pool each, noise 4) or VAE (latent 8) at embedding 8, hidden 16, pool 16,
    grid n 4, its params in ``dtype``, and the same params as torch
    tensors."""
    import types

    import jax
    import jax.numpy as jnp

    from trajnetplusplusbaselines_tpu.models.sgan import SGAN, LSTMDiscriminator, LSTMGenerator
    from trajnetplusplusbaselines_tpu.models.vae import VAE
    from trajnetplusplusbaselines_tpu.ops.pooling import make_pool

    def pool():
        return make_pool(pool_type, types.SimpleNamespace(**TINY_POOL_ARGS))

    widths = dict(embedding_dim=8, hidden_dim=16)
    if kind == "sgan":
        model = SGAN(LSTMGenerator(pool=pool(), noise_dim=TINY_NOISE_DIM, **widths, **model_args),
                     LSTMDiscriminator(pool=pool(), **widths), k=k)
    else:
        model = VAE(pool=pool(), num_modes=k, latent_dim=TINY_LATENT, **widths, **model_args)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                          model.init_params(jax.random.PRNGKey(seed)))
    return model, params, params_from_jax(jax.tree.map(np.asarray, params))


def key_chain(key, n):
    """The ``n`` subkeys of ``key, sub = jax.random.split(key)`` repeated, as
    the JAX SGAN and VAE draw one per mode."""
    import jax

    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(sub))
    return subs


class KeyedDraws:
    """Pins the JAX package's random draws by key: the draw made with the
    ``i``-th key of ``keys`` is ``values[i]`` (sliced to the shape asked
    for).  It holds under ``jit`` and ``vmap``, where a draw runs once per
    trace, since the value depends on the key and not on a call count."""

    def __init__(self, keys, values):
        self.keys = np.stack([np.asarray(k) for k in keys])
        self.values = np.stack(values)

    def __call__(self, key, shape):
        import jax.numpy as jnp

        index = jnp.argmax(jnp.all(jnp.asarray(key) == self.keys, axis=-1))
        value = jnp.asarray(self.values)[index]
        return value[tuple(slice(0, n) for n in shape)]

    def pin_noise(self, monkeypatch):
        """JAX ``models.sgan.get_noise`` draws these values."""
        import trajnetplusplusbaselines_tpu.models.sgan as jsgan

        monkeypatch.setattr(jsgan, "get_noise",
                            lambda key, shape, noise_type, dtype=None: self(key, shape))

    def pin_latent(self, monkeypatch, jax_model):
        """JAX ``VAE.sample_latent`` of ``jax_model`` takes these values as
        its standard-normal draw, its formulas otherwise unchanged."""
        import jax.numpy as jnp

        def sample_latent(key, z_mu, z_log_var, training):
            eps = self(key, z_mu.shape)
            if training:
                return z_mu + jnp.exp(0.5 * z_log_var) * eps
            return eps * jnp.exp(0.5 * z_log_var)

        monkeypatch.setattr(jax_model, "sample_latent", sample_latent, raising=False)


def classical_scene(rng, n, t=21, obs=9, scene_id=0, step=0.3):
    """Paths (the port's ``TrackRow``s, frames 10 apart) of ``n`` agents over
    ``t`` frames, for the classical predictors: the primary throughout; the
    others random walks from random starts, some appearing late (at the last
    observed frame too: one past point), some leaving before the last
    observed frame, none leaving exactly there (``pred_end`` needs a
    future).  Pedestrian ids are unique across scene ids."""
    from trajnetplusplusbaselines_torch.data.rows import TrackRow

    f0 = 1000 * scene_id
    xy = (rng.uniform(-4, 4, size=(1, n, 2))
          + rng.normal(scale=0.4, size=(1, n, 2)) * np.arange(t)[:, None, None]
          + rng.normal(scale=step, size=(t, n, 2)).cumsum(axis=0) * 0.1)
    paths = []
    for p in range(n):
        first = 0 if p == 0 else int(rng.choice([0, 0, 0, 2, 5, obs - 1]))
        last = t
        if p and first + 1 < obs - 1 and rng.random() < 0.15:
            last = int(rng.integers(first + 1, obs - 1))  # gone before the last observed frame
        paths.append([TrackRow(f0 + 10 * f, 100 * scene_id + p + 1, float(xy[f, p, 0]),
                               float(xy[f, p, 1])) for f in range(first, last)])
    return paths


def observed(paths, obs=9):
    """The paths cut at the primary's last observed frame, as the evaluator's
    ``preprocess_test`` gives them to a predictor."""
    last = paths[0][obs - 1].frame
    return [[r for r in p if r.frame <= last] for p in paths if p[0].frame <= last]
