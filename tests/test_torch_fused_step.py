"""The fused D-LSTM step's plain version against the JAX package.

- against JAX ``LSTM.step`` in float64 at 1e-12, for both cells;
- against the Pallas kernel ``fused_dlstm_step`` run in interpret mode, in
  float32 at 1e-5, as ``tests/test_pallas_fused.py`` runs it;
- the wrappers take a CPU tensor to the plain version, never counting a
  launch.
The kernel itself runs only on the card: ``tests/test_torch_guards.py`` and
``chip_smoke.py`` compare it with the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_torch.models.lstm import StepCarry
from trajnetplusplusbaselines_torch.ops.cuda import fused_step

from .torch_parity import CELL_SIDE, N, flagship_params, port_model, step_inputs, \
    with_traced_cell_side

HIDDEN = 128


def _state(seed, s, a, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(s, a, HIDDEN)).astype(dtype),
            rng.normal(scale=0.5, size=(s, a, HIDDEN)).astype(dtype))


@pytest.mark.parametrize("a", [4, 8])
@pytest.mark.parametrize("cell", ["encoder", "decoder"])
def test_plain_step_matches_jax_step(cell, a):
    jmodel, jparams, params = flagship_params(seed=a)
    s = 4
    obs1, obs2, p1, p2 = step_inputs(11 * a, s, a, n_pad=1)
    h, c = _state(a, s, a)

    def jax_step(model, params, h, c, obs1, obs2, p1, p2):
        carry = model.init_carry(s, a)._replace(h=h, c=c)
        goals = jnp.zeros((s, a, 2))
        new, normal, mask = model.step(params, cell, carry, obs1, obs2, p1, p2, goals,
                                       jnp.ones((s, a), bool))
        return new.h, new.c, normal, mask

    want = with_traced_cell_side(jax_step, jmodel)(
        jparams, *map(jnp.asarray, (h, c, obs1, obs2, p1, p2)))

    model = port_model(jmodel)
    assert model.fused
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    carry, normal, mask = model.step(params, cell, StepCarry(t(h), t(c)),
                                     t(obs1), t(obs2), t(p1), t(p2))
    got = (carry.h, carry.c, normal, mask)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[3]))

    # the model's step is the plain fused step, nothing else
    direct = fused_step.fused_dlstm_step_plain(
        t(obs1), t(obs2), t(p1), t(p2), t(h), t(c),
        fused_step.weights_from_params(params, cell), n=N, cell_side=CELL_SIDE)
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


@pytest.mark.parametrize("a", [4, 8])
def test_plain_step_matches_pallas_interpret(a):
    from jax.experimental.pallas import tpu as pltpu

    from trajnetplusplusbaselines_tpu.ops.pallas import fused_step as pallas_step

    _, jparams, params = flagship_params(seed=a, dtype=jnp.float32)
    s = 4
    # off the cell boundaries: the Pallas kernel divides by a compile-time
    # constant, which XLA turns into a reciprocal multiply
    obs1, obs2, p1, p2 = step_inputs(a, s, a, dtype=np.float32, boundary=False)
    h, c = _state(a, s, a, np.float32)

    am = lambda x: jnp.swapaxes(jnp.asarray(x), 0, 1)  # noqa: E731  [S,A,..]->[A,S,..]
    with pltpu.force_tpu_interpret_mode():
        want = pallas_step.fused_dlstm_step(
            am(obs1), am(obs2), am(p1.astype(np.float32)), am(p2.astype(np.float32)),
            am(h), am(c), pallas_step.weights_from_params(jparams), a=a, scene_block=s)
    want = [np.asarray(jnp.swapaxes(x, 0, 1)) for x in want]

    weights = fused_step.weights_from_params(params, "decoder")
    got = fused_step.fused_dlstm_step_plain(*map(torch.from_numpy, (obs1, obs2, p1, p2, h, c)),
                                            weights, n=N, cell_side=CELL_SIDE)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), want[3] > 0)


def test_weights_from_params_matches_jax():
    from trajnetplusplusbaselines_tpu.ops.pallas import fused_step as pallas_step

    _, jparams, params = flagship_params(seed=1)
    for cell in ("encoder", "decoder"):
        want = pallas_step.weights_from_params(jparams, cell)
        got = fused_step.weights_from_params(params, cell)
        assert set(got) == set(want) == set(fused_step.WEIGHT_NAMES)
        for name in fused_step.WEIGHT_NAMES:
            assert got[name].is_contiguous()
            np.testing.assert_array_equal(got[name].float().numpy(), np.asarray(want[name]))


def test_wrappers_on_cpu_run_the_plain_version():
    _, _, params = flagship_params(seed=2)
    obs1, obs2, p1, p2 = map(torch.from_numpy, step_inputs(3, 2, 8))
    h, c = map(torch.from_numpy, _state(3, 2, 8))
    weights = fused_step.weights_from_params(params, "encoder")
    launches = fused_step.fused_dlstm_step.launches, fused_step.directional_grid.launches

    got = fused_step.fused_dlstm_step(obs1, obs2, p1, p2, h, c, weights)
    want = fused_step.fused_dlstm_step_plain(obs1, obs2, p1, p2, h, c, weights)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    grid = fused_step.directional_grid(obs1, obs2, p1, p2, constant=0.5)
    assert grid.shape == (2, 8, 2 * N * N)
    assert torch.equal(grid, fused_step.directional_grid_plain(obs1, obs2, p1, p2, constant=0.5))
    assert (fused_step.fused_dlstm_step.launches,
            fused_step.directional_grid.launches) == launches


def test_check_weights_refuses_what_the_kernel_does_not_take(monkeypatch):
    # the shapes the kernel reports when built for the flagship (n=12,
    # embedding 64, pool 256, hidden 128); no build on the CPU
    shapes = {"w_emb": (2, 62), "b_emb": (62,), "w_grid": (288, 256), "b_grid": (256,),
              "w_ih": (320, 512), "w_hh": (128, 512), "b_gates": (512,),
              "w_h2n": (128, 5), "b_h2n": (5,)}
    monkeypatch.setattr(fused_step, "_kernel_shapes", lambda: (N, 128, shapes))
    _, _, params = flagship_params(seed=3)
    weights = {k: v.float() for k, v in fused_step.weights_from_params(params, "decoder").items()}

    checked = fused_step.check_weights(weights, "cpu")
    assert isinstance(checked, fused_step.KernelWeights) and checked.device == torch.device("cpu")
    assert set(checked) == set(fused_step.WEIGHT_NAMES)
    assert all(checked[k] is weights[k] for k in fused_step.WEIGHT_NAMES)
    with pytest.raises(ValueError, match="w_grid is missing"):
        fused_step.check_weights({k: v for k, v in weights.items() if k != "w_grid"}, "cpu")
    with pytest.raises(TypeError, match="w_ih"):
        fused_step.check_weights({**weights, "w_ih": weights["w_ih"].double()}, "cpu")
    with pytest.raises(TypeError, match="w_hh"):
        fused_step.check_weights({**weights, "w_hh": weights["w_hh"].t()}, "cpu")
    with pytest.raises(ValueError, match="b_gates must have shape"):
        fused_step.check_weights({**weights, "b_gates": weights["b_gates"][:256]}, "cpu")
    with pytest.raises(TypeError, match="on meta"):
        fused_step.check_weights(weights, "meta")


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 3, 2, device="meta")
    m = torch.zeros(2, 3, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_step.directional_grid(x, x, m, m)
    with pytest.raises(ValueError, match="no kernel"):
        fused_step.fused_dlstm_step(x, x, m, m, None, None, {})
