"""The along reading of ``chip_smoke.py`` phases 7(a) and 8(a), on the CPU.

``chip_smoke.along_positions`` runs a model's own step on the CPU along a
rollout made on the card: every step reads that rollout's inputs, so the
reading is each step's arithmetic, not a parting of two free rollouts.

- (a) fed its own free rollout, the reading returns it within 1e-12, in
  float64 at tiny widths, for every model of phase 7 (``pool_models``) and
  for the SGAN and the VAE at k=3 modes folded;
- (b) fed the JAX package's free rollout of the same params, converted with
  ``params_from_jax``, it returns JAX's positions within 1e-9 in float64:
  directional, social, attentionmlp, the goal D-LSTM, the SGAN (noise
  pinned) and the VAE (latent normals pinned with ``KeyedDraws``);
- (c) a step that moves one mode's rows by 1e-4 m at one decoder step of
  the card's rollouts (the CPU's rollouts are left as they are) passes the
  free 1e-3 m reading and fails the along one: ``pools_phase`` and
  ``generative_phase`` raise after reading every model, naming each;
- (d) ``pools_phase`` (tiny widths) and ``generative_phase`` (the
  flagship's widths at a handful of scenes) run on the CPU, the card's side
  played by the plain versions, and print each rollout's along reading
  within 4e-5 m beside its free reading.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from trajnetplusplusbaselines_torch.models import lstm as lstm_module
from trajnetplusplusbaselines_torch.ops.cuda import fused_step

from .torch_parity import (
    TINY_LATENT,
    TINY_NOISE_DIM,
    TINY_POOL_ARGS,
    KeyedDraws,
    jax_generative,
    jax_pool_model,
    jax_runner,
    key_chain,
    pool_batch,
    port_model,
)

OWN_ATOL = 1e-12  # metres, the reading of a rollout fed its own inputs
JAX_ATOL = 1e-9  # metres, the reading fed the JAX package's rollout, f64
K = 3
FAULT_M, FAULT_STEP, FAULT_MODE = 1e-4, 3, 1  # the card's fault: metres, decoder step, mode
# phase 7's models at tiny widths (the trainer's arguments of the parity tests)
TINY_PHASE7 = {key: TINY_POOL_ARGS[key] for key in chip_smoke.POOL_ARGS}
# the rehearsals' (scenes, agents): every scene count off POOL_CPU_SCENES, so
# that a step can tell the card's rollouts from the CPU's by their rows
REHEARSAL_ROLLOUTS = ((4, 8), (3, 32))
REHEARSAL_CPU_SCENES = 2


def _batch(seed=2):
    """``pool_batch``'s observed frames, goals and slot mask, for the JAX
    package and for the port."""
    xy, mask, goals, slot = pool_batch(seed=seed)
    arrays = (xy[:9], mask[:9], goals, slot)
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


def _own_reading(model, params, pred, valid, x, m, **kw):
    return chip_smoke.along_reading(params, x, m, pred, valid, model, **kw)


@pytest.fixture
def tiny_phase7(monkeypatch):
    monkeypatch.setattr(chip_smoke, "POOL_ARGS", TINY_PHASE7)
    monkeypatch.setattr(chip_smoke, "POOL_EMBEDDING", 8)


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("name", list(chip_smoke.pool_models()))
def test_along_reading_of_its_own_rollout_is_the_rollout(name, tiny_phase7):
    model = chip_smoke.pool_models()[name]
    params = model.init_params(torch.Generator().manual_seed(7), dtype=torch.float64)
    _, (x, m, g, sl) = _batch()
    with torch.no_grad():
        _, pred, valid = model.forward(params, x, m, n_predict=12, goals=g, slot_mask=sl)
    assert bool(valid.any()) and bool((~valid).any())
    reading = _own_reading(model, params, pred, valid, x, m, goals=g, slot_mask=sl)
    assert reading["max_position_err_m"] <= OWN_ATOL
    assert set(reading["worst_along"]) == {"step", "scene", "agent"}


@pytest.mark.parametrize("kind", ["sgan", "vae"])
def test_along_reading_of_its_own_folded_rollout_is_the_rollout(kind):
    """Each of the k folded modes read along its own rows."""
    jmodel, _, params = jax_generative(kind, seed=3)
    model = port_model(jmodel)
    _, (x, m, g, sl) = _batch(seed=4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        if kind == "sgan":
            draws = torch.randn(K, TINY_NOISE_DIM, generator=gen, dtype=torch.float64)
            _, pred, valid = model.generate(params, x, m, n_predict=12, modes=K, noise=draws,
                                            goals=g, slot_mask=sl)
        else:
            draws = torch.randn(K, *x.shape[1:3], TINY_LATENT, generator=gen,
                                dtype=torch.float64)
            _, pred, valid, _, _ = model.forward(params, x, m, n_predict=12, training=False,
                                                 modes=K, eps=draws, goals=g, slot_mask=sl)
    assert float((pred[0] - pred[1]).abs().max()) > 1e-3  # the modes differ
    reading = _own_reading(model, params, pred, valid, x, m, draws=draws, goals=g,
                           slot_mask=sl)
    assert reading["max_position_err_m"] <= OWN_ATOL
    assert set(reading["worst_along"]) == {"mode", "step", "scene", "agent"}


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("name", ["directional", "social", "attentionmlp", "goals"])
def test_along_reading_of_the_jax_rollout_is_the_jax_rollout(name):
    jmodel, jparams, params = jax_pool_model(name, seed=1)
    (xy, mask, goals, slot), (x, m, g, sl) = _batch(seed=6)
    _, want, want_valid = jax_runner(
        lambda model, *args: model.forward(*args, n_predict=12), jmodel)(
        jparams, xy, mask, goals, slot)
    pred, valid = (torch.from_numpy(np.array(out)) for out in (want, want_valid))
    reading = _own_reading(port_model(jmodel), params, pred, valid, x, m, goals=g,
                           slot_mask=sl)
    assert reading["max_position_err_m"] <= JAX_ATOL


@pytest.mark.parametrize("kind", ["sgan", "vae"])
def test_along_reading_of_the_jax_folded_rollout_is_the_jax_rollout(kind, monkeypatch):
    """JAX's k rollouts (its SGAN vmaps or loops the modes, its VAE loops
    them) on pinned draws, read along by the port's folded decoder."""
    jmodel, jparams, params = jax_generative(kind, seed=8)
    (xy, mask, goals, slot), (x, m, g, sl) = _batch(seed=9)
    rng = np.random.default_rng(10)
    if kind == "sgan":
        draws = rng.normal(size=(K, TINY_NOISE_DIM))
        keys = [jax.random.PRNGKey(20 + i) for i in range(K)]
        KeyedDraws(keys, list(draws)).pin_noise(monkeypatch)
        runs = [jmodel.generator.forward(jparams["generator"], xy, mask, goals, slot, key=key,
                                         n_predict=12) for key in keys]
        want, want_valid = (np.stack([np.asarray(r[i]) for r in runs]) for i in (1, 2))
    else:
        draws = rng.normal(size=(K, *x.shape[1:3], TINY_LATENT))
        key = jax.random.PRNGKey(21)
        KeyedDraws(key_chain(key, K), list(draws)).pin_latent(monkeypatch, jmodel)
        out = jmodel.forward(jparams, xy, mask, goals, slot, n_predict=12, key=key,
                             training=False)
        want, want_valid = (np.stack([np.asarray(w) for w in out[i]]) for i in (1, 2))
    pred, valid = torch.from_numpy(want), torch.from_numpy(want_valid)
    assert pred.shape == (K, 19, *x.shape[1:3], 2)
    reading = _own_reading(port_model(jmodel), params, pred, valid, x, m,
                           draws=torch.from_numpy(draws), goals=g, slot_mask=sl)
    assert reading["max_position_err_m"] <= JAX_ATOL


# -------------------------------------------------------- (c) and (d)
@pytest.fixture
def rehearsal(monkeypatch):
    """Phases 7 and 8 on the CPU: the wrappers' launches counted where the
    model calls them, the card's clocks and memory statistics stubbed, the
    rollouts at ``REHEARSAL_ROLLOUTS`` against ``REHEARSAL_CPU_SCENES``
    CPU scenes."""
    def counted(fn, wrapper):
        def call(*args, **kw):
            wrapper.launches += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(lstm_module, "directional_grid",
                        counted(lstm_module.directional_grid, fused_step.directional_grid))
    monkeypatch.setattr(lstm_module, "fused_dlstm_step",
                        counted(lstm_module.fused_dlstm_step, fused_step.fused_dlstm_step))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps=20, warmup=3: 1.0)
    monkeypatch.setattr(chip_smoke, "kernel_ms_per_launch", lambda fn, reps, kernel: 1e-3)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *args: 0)
    monkeypatch.setattr(chip_smoke, "POOL_ROLLOUTS", REHEARSAL_ROLLOUTS)
    monkeypatch.setattr(chip_smoke, "GEN_ROLLOUTS", REHEARSAL_ROLLOUTS)
    monkeypatch.setattr(chip_smoke, "POOL_CPU_SCENES", REHEARSAL_CPU_SCENES)
    monkeypatch.setattr(chip_smoke, "POOL_SPLIT", (16, 8, 8))
    monkeypatch.setattr(chip_smoke, "GEN_TIMED_REPEATS", 1)
    monkeypatch.setattr(chip_smoke, "GEN_TIMED_REPS", 1)


def _card_fault(monkeypatch, card_scenes=frozenset(s for s, _ in REHEARSAL_ROLLOUTS)):
    """``LSTM.step`` adding ``FAULT_M`` to the x offset at decoder step
    ``FAULT_STEP`` of the card's rollouts (told by their scene counts,
    ``card_scenes``): in mode ``FAULT_MODE``'s rows of a folded rollout, in
    every row of a rollout of one mode."""
    real = lstm_module.LSTM.step
    decoder_steps = []

    def step(self, params, cell, carry, obs1, *args, **kw):
        carry, normal, mask = real(self, params, cell, carry, obs1, *args, **kw)
        if cell == "encoder":
            decoder_steps.clear()
            return carry, normal, mask
        decoder_steps.append(1)
        rows = obs1.shape[0]
        if len(decoder_steps) == FAULT_STEP and rows in card_scenes:
            normal = normal.clone()
            normal[..., 0] += FAULT_M
        elif len(decoder_steps) == FAULT_STEP and rows // chip_smoke.GEN_MODES in card_scenes:
            s = rows // chip_smoke.GEN_MODES
            normal = normal.clone()
            normal[FAULT_MODE * s:(FAULT_MODE + 1) * s, :, 0] += FAULT_M
        return carry, normal, mask

    monkeypatch.setattr(lstm_module.LSTM, "step", step)


@pytest.mark.parametrize("name", ["directional", "lstm_layer", "goals", "sgan", "vae"])
def test_along_reading_sees_a_step_fault_at_its_step_only(name, monkeypatch):
    """A rollout whose step moved one mode's rows by ``FAULT_M`` at one
    decoder step: the along reading differs from it there by ``FAULT_M``
    and nowhere else by more than ``OWN_ATOL`` (a free reading would part
    from it at every later step)."""
    _, (x, m, g, sl) = _batch(seed=11)
    kw = dict(n_predict=12, goals=g, slot_mask=sl)
    gen = torch.Generator().manual_seed(12)
    if name in ("sgan", "vae"):
        jmodel, _, params = jax_generative(name, seed=13)
        model, draws = port_model(jmodel), torch.randn(
            K, *((TINY_NOISE_DIM,) if name == "sgan" else (*x.shape[1:3], TINY_LATENT)),
            generator=gen, dtype=torch.float64)
        if name == "sgan":
            def rollout():
                return model.generate(params, x, m, modes=K, noise=draws, **kw)[1:3]
        else:
            def rollout():
                return model.forward(params, x, m, training=False, modes=K, eps=draws,
                                     **kw)[1:3]
    else:
        jmodel, _, params = jax_pool_model(name, seed=13)
        model, draws = port_model(jmodel), None

        def rollout():
            return model.forward(params, x, m, **kw)[1:3]

    with monkeypatch.context() as patched, torch.no_grad():
        _card_fault(patched, card_scenes={x.shape[1]})
        pred, valid = rollout()
    with torch.no_grad():
        free = rollout()[0]
    err = torch.where(valid, (chip_smoke.along_positions(
        params, x, m, pred, valid, model, draws=draws, goals=g, slot_mask=sl)
        - pred).abs().amax(dim=-1), 0.0)
    t = 8 + FAULT_STEP - 1
    faulted = err[FAULT_MODE, t] if draws is not None else err[t]
    assert float(faulted[valid[FAULT_MODE, t] if draws is not None else valid[t]].min()) \
        == pytest.approx(FAULT_M, rel=1e-6)
    if draws is not None:
        err[FAULT_MODE, t] = 0.0
    else:
        err[t] = 0.0
    assert float(err.max()) <= OWN_ATOL
    # the free rollout parts from the faulted one after the fault's step
    assert float((free - pred)[..., t + 1:, :, :, :].abs().max()) > FAULT_M / 2


def _lines(capsys, phase):
    return [line for line in map(json.loads, (text for text in capsys.readouterr().out
                                              .splitlines() if text.startswith("{")))
            if line["phase"] == phase]


def _check_readings(lines, models, fault=False):
    assert {line["model"] for line in lines} == set(models)
    assert len(lines) == len(models) * len(REHEARSAL_ROLLOUTS)
    for line in lines:
        assert line["along_atol_m"] == chip_smoke.ALONG_ATOL
        assert line["free_max_position_err_m"] <= chip_smoke.POSITION_ATOL
        assert set(line["worst_along"]) >= {"step", "scene", "agent"}
        if fault:  # the along reading sees the fault where it was made
            assert line["max_position_err_m"] > chip_smoke.ALONG_ATOL
            assert line["worst_along"]["step"] == 8 + FAULT_STEP - 1
            assert line["worst_along"].get("mode", FAULT_MODE) == FAULT_MODE
        else:
            assert line["max_position_err_m"] <= chip_smoke.ALONG_ATOL


@pytest.mark.parametrize("fault", [False, True])
def test_pools_phase_reads_every_rollout_along(rehearsal, tiny_phase7, monkeypatch, capsys,
                                               fault):
    models = list(chip_smoke.pool_models())
    if fault:
        _card_fault(monkeypatch)
        with pytest.raises(AssertionError, match="along the card's own rollout") as raised:
            chip_smoke.pools_phase(torch.device("cpu"), np.random.default_rng(0))
        assert all(f"{name} at S=" in str(raised.value) for name in models)
    else:
        out = chip_smoke.pools_phase(torch.device("cpu"), np.random.default_rng(0))
        assert out["grid_err"] == 0.0
    _check_readings(_lines(capsys, "pools_rollout"), models, fault)


@pytest.mark.parametrize("fault", [False, True])
def test_generative_phase_reads_every_rollout_along(rehearsal, monkeypatch, capsys, fault):
    if fault:
        _card_fault(monkeypatch)
        with pytest.raises(AssertionError, match="along the card's own rollout") as raised:
            chip_smoke.generative_phase(torch.device("cpu"), np.random.default_rng(0), "CPU")
        assert all(f"{kind} at S=" in str(raised.value) for kind in ("sgan", "vae"))
    else:
        chip_smoke.generative_phase(torch.device("cpu"), np.random.default_rng(0), "CPU")
    _check_readings(_lines(capsys, "generative_rollout"), ("sgan", "vae"), fault)
