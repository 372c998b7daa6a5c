"""The grid stage's edge cases: the plain grid against JAX's, and the kernel
against the plain grid on the card.

``chip_smoke.grid_edge_cases`` builds batches that each hit one rule of the
directional grid's last write (an out-of-range neighbour overwriting cell 0,
two neighbours in one cell, the grid's edges, an agent that appears at t or
is absent at t, 1 to 1,024 agents, sides 1 and 32, ``front``, centimetre
offsets).  On the CPU ``directional_grid_plain`` is held bit-exact to the
JAX package's grid, run with the cell side traced so that it divides as its
eager code does, in f32 and f64, and each case is checked to hit its rule.
The ``cuda`` test holds the kernel bit-exact to the plain grid; where jax is
not installed run it without the suite's conftest:

    python -m pytest tests/test_torch_grid_stage.py -m cuda --noconftest -p no:cacheprovider
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from trajnetplusplusbaselines_torch.ops.cuda import fused_step

from .torch_parity import step_inputs

CASE_NAMES = [case.name for case in chip_smoke.grid_edge_cases(np.random.default_rng(0))]


def _cases(dtype):
    return {case.name: case for case in
            chip_smoke.grid_edge_cases(np.random.default_rng(0), dtype=dtype)}


def _jax_grid(case):
    """JAX's flat directional grid [S, A, 2 n^2] of ``case``, with the cell
    side traced (under jit XLA turns a division by a constant into a
    multiply by its reciprocal)."""
    import jax
    import jax.numpy as jnp

    from trajnetplusplusbaselines_tpu.ops.pooling import GridBasedPooling as JGrid

    geometry = case.geometry
    pool = JGrid(type_="directional", n=geometry["n"], cell_side=geometry["cell_side"],
                 constant=geometry["constant"], front=geometry["front"])

    def fn(cell_side, *x):
        traced = copy.copy(pool)
        traced.cell_side = cell_side
        return traced.make_grid(None, *x, None)

    inputs = [jnp.asarray(x) for x in (case.obs1, case.obs2, case.p1, case.p2)]
    grid = jax.jit(fn)(jnp.asarray(geometry["cell_side"], inputs[1].dtype), *inputs)
    s, a = case.p2.shape
    return np.asarray(grid).reshape(s, a, -1)


def test_edge_cases_are_seeded_and_named():
    assert len(CASE_NAMES) == len(set(CASE_NAMES)) >= 14
    again = _cases(np.float32)
    for case in chip_smoke.grid_edge_cases(np.random.default_rng(0)):
        assert case.checks, case.name
        for x, y in zip(case[1:5], again[case.name][1:5]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_plain_grid_matches_jax_on_edge_cases(name, dtype):
    case = _cases(dtype)[name]
    got = fused_step.directional_grid_plain(
        *map(torch.from_numpy, (case.obs1, case.obs2, case.p1, case.p2)), **case.geometry)
    want = _jax_grid(case)
    assert got.dtype == torch.float32 if dtype == np.float32 else got.dtype == torch.float64
    assert got.shape == want.shape == (*case.p2.shape, 2 * case.geometry["n"] ** 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # the case hits the rule it is named for
    assert chip_smoke.grid_case_failures(case, want) == []


def test_case_checks_fail_on_a_grid_that_breaks_them():
    """``grid_case_failures`` is not vacuous: a grid of all zeros, or one
    with the winners' cells swapped for their neighbours', breaks checks."""
    for case in _cases(np.float32).values():
        s, a = case.p2.shape
        zeros = np.zeros((s, a, 2 * case.geometry["n"] ** 2), np.float32)
        kinds = {kind for kind, *_ in case.checks}
        if kinds - {"zero", "boundary"}:
            assert chip_smoke.grid_case_failures(case, zeros), case.name
        grid = fused_step.directional_grid_plain(
            *map(torch.from_numpy, (case.obs1, case.obs2, case.p1, case.p2)),
            **case.geometry).numpy()
        if "value" in kinds:
            assert chip_smoke.grid_case_failures(case, np.roll(grid, 1, axis=-1)), case.name


@pytest.mark.cuda
def test_grid_stage_matches_plain_on_the_card():
    """The kernel bit-exact against the plain grid on every edge case and at
    every side n from 1 to 32, with ``front`` on and off, at A=8 and A=40,
    one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    launches = fused_step.directional_grid.launches
    calls = 0
    for case in _cases(np.float32).values():
        obs1, obs2, p1, p2 = (torch.from_numpy(x).to(dev)
                              for x in (case.obs1, case.obs2, case.p1, case.p2))
        got = fused_step.directional_grid(obs1, obs2, p1, p2, **case.geometry)
        calls += 1
        assert torch.equal(got, fused_step.directional_grid_plain(obs1, obs2, p1, p2,
                                                                  **case.geometry)), case.name
        assert chip_smoke.grid_case_failures(case, got.cpu()) == [], case.name
    for a in (8, 40):
        obs1, obs2, p1, p2 = (torch.from_numpy(x).to(dev) for x in
                              step_inputs(a, 24, a, n_pad=max(1, a // 8), dtype=np.float32))
        for n in range(1, 33):
            for front in (False, True):
                kw = dict(n=n, cell_side=3.6 / n, constant=0.25, front=front)
                got = fused_step.directional_grid(obs1, obs2, p1, p2, **kw)
                calls += 1
                assert torch.equal(got, fused_step.directional_grid_plain(
                    obs1, obs2, p1, p2, **kw)), (a, n, front)
    torch.cuda.synchronize()
    assert fused_step.directional_grid.launches - launches == calls
