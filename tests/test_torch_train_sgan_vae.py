"""The SGAN and VAE trainers of the port against the JAX package's.

One SGAN generator step, one discriminator step and one VAE step at tiny
widths in float64: the loss and the gradient of every leaf against
``jax.value_and_grad`` of the JAX trainer's loss, un-jitted, at 1e-8, with
the noise, the latent normals (``KeyedDraws``) and the smoothed label pinned
on both sides.  Then each trainer's ``main`` for 2 epochs on the CPU at the
tiny size: its pickle loads and serves through its CLI; and the default
``--device cuda`` raises without a card.
"""

import importlib
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu import losses as jlosses
from trajnetplusplusbaselines_tpu.tools.plot_log import read_log
from trajnetplusplusbaselines_tpu.trainers import common as jcommon
from trajnetplusplusbaselines_tpu.trainers.sgan import Trainer as JSGANTrainer
from trajnetplusplusbaselines_tpu.trainers.vae import Trainer as JVAETrainer
from trajnetplusplusbaselines_torch.models.sgan import SGANPredictor
from trajnetplusplusbaselines_torch.models.vae import VAEPredictor
from trajnetplusplusbaselines_torch.trainers import common
from trajnetplusplusbaselines_torch.trainers import sgan as sgan_trainer
from trajnetplusplusbaselines_torch.trainers import vae as vae_trainer
from trajnetplusplusbaselines_torch.utils import checkpoint as ckpt

from .helpers import make_synthetic_dataset
from .torch_parity import (
    TINY_LATENT,
    TINY_NOISE_DIM,
    KeyedDraws,
    jax_generative,
    key_chain,
    pool_batch,
    port_model,
)

TOL = 1e-8
K = 3
LABEL = 0.93  # the smoothed real label, pinned


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return np.asarray(tree)


def _grads_close(paths, grads, jax_grads):
    assert len(paths) == len(jax.tree.leaves(jax_grads))
    for path, g in zip(paths, grads):
        want = _leaf(jax_grads, path)
        assert np.isfinite(g.numpy()).all(), path
        np.testing.assert_allclose(g.numpy(), want, atol=TOL, rtol=0, err_msg=path)


def _batch(seed):
    arrays = pool_batch(seed=seed)
    scene = np.ones(arrays[0].shape[1], bool)
    return (tuple(map(jnp.asarray, arrays)) + (jnp.asarray(scene),),
            tuple(map(torch.from_numpy, arrays)) + (torch.from_numpy(scene),))


def _sgan_trainers(pool_type="directional", seed=1):
    jmodel, jparams, params = jax_generative("sgan", pool_type, seed=seed, k=K)
    opt = jcommon.make_optimizer(1e-4)
    jtr = JSGANTrainer(jmodel, jparams, opt, opt, jcommon.step_lr(1e-3, 10),
                       jcommon.step_lr(1e-3, 10), criterion="pred", batch_size=4, augment=False)
    tr = sgan_trainer.Trainer(port_model(jmodel), params, common.step_lr(1e-3, 10),
                              common.step_lr(1e-3, 10), criterion="pred", batch_size=4,
                              augment=False)
    return jtr, jparams, tr


@pytest.mark.parametrize("pool_type", ["directional", "nn_lstm"])
def test_sgan_generator_step_matches_jax(pool_type, monkeypatch):
    """Variety loss over K teacher-forced rollouts plus the adversarial loss
    of the last mode's scores, whose gradient reaches the generator through
    the discriminator's (plain) grid."""
    jtr, jparams, tr = _sgan_trainers(pool_type)
    (xy, mask, goals, slot, scene), (x, m, g, sl, sc) = _batch(seed=2)
    zs = np.random.default_rng(3).normal(size=(K, TINY_NOISE_DIM))
    key = jax.random.PRNGKey(4)
    KeyedDraws(key_chain(key, K), list(zs)).pin_noise(monkeypatch)

    def loss_fn(g_params):
        params = {"generator": g_params, "discriminator": jparams["discriminator"]}
        rel_list, _, _, _, scores_fake = jtr._forward(params, xy, mask, goals, slot, "g", key)
        return (jtr.variety_loss(rel_list, xy, scene)
                + jlosses.bce_loss(scores_fake, jnp.ones_like(scores_fake) * LABEL))

    want, jgrads = jax.value_and_grad(loss_fn)(jparams["generator"])
    loss, grads = tr.g_loss_and_grads(x, m, sc, g, sl, noise=torch.from_numpy(zs), label=LABEL)
    np.testing.assert_allclose(float(loss), float(want), atol=TOL, rtol=0)
    _grads_close(tr.g_paths, grads, jgrads)


def test_sgan_discriminator_step_matches_jax(monkeypatch):
    jtr, jparams, tr = _sgan_trainers(seed=5)
    (xy, mask, goals, slot, scene), (x, m, g, sl, sc) = _batch(seed=6)
    z = np.random.default_rng(7).normal(size=(1, TINY_NOISE_DIM))
    key = jax.random.PRNGKey(8)
    KeyedDraws(key_chain(key, 1), list(z)).pin_noise(monkeypatch)

    def loss_fn(d_params):
        params = {"generator": jparams["generator"], "discriminator": d_params}
        _, _, _, real, fake = jtr._forward(params, xy, mask, goals, slot, "d", key)
        return (jlosses.bce_loss(real, jnp.ones_like(real) * LABEL)
                + jlosses.bce_loss(fake, jnp.zeros_like(fake)))

    want, jgrads = jax.value_and_grad(loss_fn)(jparams["discriminator"])
    loss, grads = tr.d_loss_and_grads(x, m, sc, g, sl, noise=torch.from_numpy(z), label=LABEL)
    np.testing.assert_allclose(float(loss), float(want), atol=TOL, rtol=0)
    _grads_close(tr.d_paths, grads, jgrads)


def test_sgan_step_types_alternate():
    _, _, tr = _sgan_trainers()
    tr.model.g_steps, tr.model.d_steps = 2, 1
    assert tr.step_types(7) == ["g", "g", "d", "g", "g", "d", "g"]


def _init_defaults(cls):
    """{parameter: default} of a constructor, following ``**kwargs`` into
    the constructors of its bases."""
    out = {}
    for klass in cls.__mro__:
        if "__init__" not in vars(klass):
            continue
        params = list(inspect.signature(klass.__init__).parameters.values())[1:]
        for p in params:
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                out.setdefault(p.name, p.default)
        if not any(p.kind is p.VAR_KEYWORD for p in params):
            return out
    return out


@pytest.mark.parametrize("module,cls", [("lstm", "Trainer"), ("sgan", "Trainer"),
                                        ("vae", "Trainer"), ("ensemble", "EnsembleTrainer")])
def test_trainer_defaults_match_jax(module, cls):
    """A trainer built directly trains what JAX's trains: every parameter
    both constructors take has the same default (the SGAN's criterion is
    "L2" in both)."""
    port = _init_defaults(getattr(importlib.import_module(
        f"trajnetplusplusbaselines_torch.trainers.{module}"), cls))
    jax_ = _init_defaults(getattr(importlib.import_module(
        f"trajnetplusplusbaselines_tpu.trainers.{module}"), cls))
    shared = [name for name in jax_ if name in port]
    assert len(shared) >= 10, shared
    assert {n: port[n] for n in shared} == {n: jax_[n] for n in shared}
    if module == "sgan":
        assert port["criterion"] == "L2"


@pytest.mark.parametrize("pool_type", ["directional", "nn_lstm"])
def test_vae_step_matches_jax(pool_type, monkeypatch):
    """Reconstruction averaged over K modes plus alpha_kld x the primaries'
    KL divergence, through the prediction encoder and the latent gate."""
    jmodel, jparams, params = jax_generative("vae", pool_type, seed=9, k=K)
    jtr = JVAETrainer(jmodel, jparams, jcommon.make_optimizer(1e-4), jcommon.step_lr(1e-3, 10),
                      criterion="pred", batch_size=4, augment=False, alpha_kld=0.5)
    tr = vae_trainer.Trainer(port_model(jmodel), params, common.step_lr(1e-3, 10),
                             alpha_kld=0.5, batch_size=4, augment=False)
    (xy, mask, goals, slot, scene), (x, m, g, sl, sc) = _batch(seed=10)
    eps = np.random.default_rng(11).normal(size=(K, *x.shape[1:3], TINY_LATENT))
    key = jax.random.PRNGKey(12)
    KeyedDraws(key_chain(key, K), list(eps)).pin_latent(monkeypatch, jmodel)

    def loss_fn(p):
        reconstr, kld = jtr._losses(p, xy, mask, goals, slot, scene, key, True)
        return reconstr + 0.5 * kld, reconstr

    (want, want_reconstr), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    loss, reconstr, grads = tr.loss_and_grads(x, m, sc, g, sl, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss), float(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(reconstr), float(want_reconstr), atol=TOL, rtol=0)
    _grads_close(tr.paths, grads, jgrads)


TINY = ["--path", "synthset", "--batch_size", "2", "--hidden-dim", "16",
        "--coordinate-embedding-dim", "8", "--pool_dim", "16", "--type", "directional",
        "--n", "4", "--k", "2", "--device", "cpu"]


@pytest.fixture
def data_tree(tmp_path, monkeypatch):
    make_synthetic_dataset(os.path.join(str(tmp_path), "DATA_BLOCK", "synthset"))
    monkeypatch.chdir(str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize("kind,extra", [("sgan", ["--noise_dim", "4"]),
                                        ("vae", ["--vae_latent_dim", "8"])])
def test_cli_trains_and_serves(data_tree, kind, extra):
    """Two epochs through ``main``; the pickle and its sidecar load, and the
    pickle serves 2 modes through the model's CLI."""
    from trajnetplusplusbaselines_torch.evaluator import sgan_cli, vae_cli

    main = {"sgan": sgan_trainer.main, "vae": vae_trainer.main}[kind]
    trainer = main(argv=[*TINY, *extra, "--epochs", "2", "--save_every", "1", "-o", "t"])
    out = f"OUTPUT_BLOCK/synthset/{kind}_directional_t.pkl"
    for suffix in ("", ".state", ".epoch0", ".epoch2"):
        assert os.path.exists(out + suffix), suffix
    records = read_log(out + ".log")
    assert len(records["train-epoch"]) == len(records["val-epoch"]) == 2
    losses = [r["loss"] for r in records["train-epoch"] + records["val-epoch"]]
    assert np.isfinite(losses).all()

    predictor = ckpt.load_predictor(out)
    assert type(predictor) is {"sgan": SGANPredictor, "vae": VAEPredictor}[kind]
    state = ckpt.load_state(out + ".state")
    assert state["epoch"] == 2
    trained = trainer.params["generator"] if kind == "sgan" else trainer.params
    loaded = predictor.params["generator"] if kind == "sgan" else predictor.params
    np.testing.assert_array_equal(loaded["decoder"]["w_hh"].numpy(),
                                  trained["decoder"]["w_hh"].detach().numpy())

    cli = {"sgan": sgan_cli, "vae": vae_cli}[kind]
    table = cli.main(["--path", "synthset", "--output", out, "--modes", "2", "--device", "cpu"])
    overall = table.results[f"{kind}_directional_t_modes2"][32:40]
    assert overall[0] == 4 and np.isfinite(overall[1:3]).all()


def test_cli_resumes_from_full_state(data_tree):
    tiny = [*TINY, "--noise_dim", "4", "-o", "r", "--save_every", "10"]
    sgan_trainer.main(argv=[*tiny, "--epochs", "1"])
    out = "OUTPUT_BLOCK/synthset/sgan_directional_r.pkl"
    trainer = sgan_trainer.main(argv=[*tiny, "--epochs", "2", "--load-full-state",
                                      out + ".state"])
    assert [r["epoch"] for r in read_log(out + ".log")["train-epoch"]] == [1, 2]
    # 2 batches per epoch, generator and discriminator in turn
    for optimizer in (trainer.g_optimizer, trainer.d_optimizer):
        assert {float(s["step"]) for s in optimizer.state.values()} == {2.0}


@pytest.mark.parametrize("module", [sgan_trainer, vae_trainer])
def test_trainer_default_device_refuses_to_run_on_the_cpu(tmp_path, monkeypatch, module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv=["--path", "synthset", "--type", "directional"])
    assert not os.path.exists(tmp_path / "OUTPUT_BLOCK")  # nothing ran


# the --bf16 case was a refusal until bf16 was ported; it keeps its id and
# now trains an epoch of each trainer in bf16.  --dp 2 was refused until
# multi-device training was ported; it keeps its id, and in one process it
# raises, naming the launch of each trainer's module.
@pytest.mark.parametrize("flags,match", [pytest.param(["--bf16"], None, id="flags0-item 5"),
                                         pytest.param(["--dp", "2"], "torch.distributed.run",
                                                      id="flags1-item 8"),
                                         (["--orbax"], "Do not port")])
def test_trainers_refuse_what_is_not_ported(tmp_path, monkeypatch, flags, match):
    monkeypatch.chdir(tmp_path)
    if match is None:
        make_synthetic_dataset(os.path.join(str(tmp_path), "DATA_BLOCK", "synthset"))
        for module, extra in ((sgan_trainer, ["--noise_dim", "4"]),
                              (vae_trainer, ["--vae_latent_dim", "8"])):
            trainer = module.main(argv=[*TINY, *extra, *flags, "--epochs", "1", "-o", "b"])
            assert trainer.model.compute_dtype == torch.bfloat16
            kind = "sgan" if module is sgan_trainer else "vae"
            out = f"OUTPUT_BLOCK/synthset/{kind}_directional_b.pkl"
            records = read_log(out + ".log")
            assert np.isfinite(records["train-epoch"][0]["loss"])
            assert np.isfinite(records["val-epoch"][0]["loss"])
            leaves = trainer.leaves if kind == "vae" else trainer.g_leaves + trainer.d_leaves
            assert all(leaf.dtype == torch.float32 for leaf in leaves)  # f32 masters
            assert ckpt.load_predictor(out).model.compute_dtype is None
        return
    for module in (sgan_trainer, vae_trainer):
        if "--dp" in flags:
            launch = (f"--dp 2 --tp 1 takes 2 processes, and this run has 1: launch it as "
                      f"python -m torch.distributed.run --standalone --nproc_per_node 2 "
                      f"-m {module.__name__} --dp 2 --tp 1")
            with pytest.raises(RuntimeError, match=re.escape(launch)):
                module.main(argv=[*TINY, *flags])
            continue
        with pytest.raises(NotImplementedError, match=match):
            module.main(argv=[*TINY, *flags])
    assert not os.path.exists(tmp_path / "OUTPUT_BLOCK")
