"""The double integrator's column and block steps in the port, their plain
trial rollout, and the facade with the block step, against altro_tpu.

* `double_integrator_cols(2)` / `double_integrator_tile(2)` (an exact
  discrete step, no integrator) equal JAX's and the lane dynamics
  `double_integrator_dynamics(2)` (tests/test_pallas_rollout.py:53's zoo
  case) in f64, and name the device step of csrc/device_steps.cuh
  (INTEGRATOR_DISCRETE); other dims name none.
* The plain trial rollout (`trial_rollout_ref`) with that step equals
  JAX's `make_trial_grid_rollout(double_integrator_tile(2), interpret=True,
  n_con=P)` in f64 (phi and states within 1e-10) at P in (0, 2, 4), random
  rows in x and u active at every knot, the terminal knot's included.
* tests/test_api.py:54's problem with the goal replaced by a terminal
  cost, through the facade with `set_tile_dynamics(double_integrator_
  tile(2))` (`mpc.double_integrator_block_step_solver`): the solve runs
  the trial rollout (here its plain twin), equals the solve without the
  block step, and is held to JAX's facade with the same setting in f64.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.double_integrator import double_integrator_dynamics as jdi  # noqa: E402
from altro_tpu.models.tile_steps import double_integrator_cols as jdi_cols  # noqa: E402
from altro_tpu.models.tile_steps import double_integrator_tile as jdi_tile  # noqa: E402
from altro_tpu.ops.pallas_rollout import make_trial_grid_rollout  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.models.double_integrator import double_integrator_dynamics  # noqa: E402
from altro_tpu_torch.models.tile_steps import (  # noqa: E402
    INTEGRATOR_DISCRETE,
    MODEL_DOUBLE_INTEGRATOR,
    double_integrator_cols,
    double_integrator_tile,
)
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402
from test_torch_api import assert_same_solve, options  # noqa: E402

n, m = 4, 2


def test_steps_match_jax_and_lane_dynamics():
    rng = np.random.default_rng(0)
    W, h = 8, 0.1
    x, u = 0.3 * rng.standard_normal((W, n)), 1.0 + 0.3 * rng.standard_normal((W, m))
    got = double_integrator_tile(2)(torch.as_tensor(x), torch.as_tensor(u),
                                    torch.full((W, 1), h, dtype=torch.float64))
    want = jdi_tile(2)(jnp.asarray(x), jnp.asarray(u), jnp.full((W, 1), h))
    lane = jax.vmap(lambda xi, ui: jdi(2)(xi, ui, h, 0))(jnp.asarray(x), jnp.asarray(u))
    port_lane = double_integrator_dynamics(2)(torch.as_tensor(x.T), torch.as_tensor(u.T), h, 0).T
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), np.asarray(lane), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(port_lane.numpy(), np.asarray(lane), rtol=1e-13, atol=1e-14)
    cols = double_integrator_cols(2)(tuple(torch.as_tensor(x.T)), tuple(torch.as_tensor(u.T)), h)
    jcols = jdi_cols(2)(tuple(jnp.asarray(x.T)), tuple(jnp.asarray(u.T)), h)
    for a, b in zip(cols, jcols):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-14)
    for step in (double_integrator_cols(2), double_integrator_tile(2)):
        ds = step.device_step
        assert (ds.model, ds.integrator, ds.n, ds.m) == (MODEL_DOUBLE_INTEGRATOR,
                                                         INTEGRATOR_DISCRETE, n, m)
    assert double_integrator_tile(3).device_step is None


@pytest.mark.parametrize("P", [0, 2, 4])
def test_plain_trial_rollout_matches_jax_f64(P):
    step, args, con = mpc.trial_operands("double_integrator", 30, 8, P, dtype=torch.float64,
                                         device="cpu")
    before = tr.LAUNCHES
    phi, xs = tr.trial_rollout(step, *args, con=con)
    assert tr.LAUNCHES == before
    grid = make_trial_grid_rollout(jdi_tile(2), interpret=True, n_con=P)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    if con is not None:
        jargs += [jnp.asarray(c.numpy()) for c in con[:3]] + [float(con[3])]
    phi_j, xs_j = grid(*jargs)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0, atol=1e-10)
    assert tr.ineligibility(step, n, m, 8, P) is None
    if P:  # the rows bite, the terminal ones included
        wa, wu, wg, _ = (c.numpy() for c in con)
        w_N = wg[-1][None] - np.einsum("pi,wi->wp", wa[-1], xs.numpy()[:, -1])
        assert (w_N < 0).any()


def _jax_block_step_solver(with_tile):
    from altro_tpu.api import ALTROSolver as JSolver

    s = JSolver(mpc.DI_N)
    s.set_dimension(n, m)
    s.set_time_step(0.5)
    s.set_explicit_dynamics(jdi(2))
    s.set_lqr_cost(np.ones(n), np.full(m, 1e-2), np.zeros(n), np.zeros(m), 0, mpc.DI_N)
    s.set_lqr_cost(np.full(n, 100.0), np.full(m, 1e-2), np.zeros(n), np.zeros(m), mpc.DI_N)
    s.set_input_bounds(u_lo=[-1.0, -1.0], u_hi=[1.0, 1.0])
    s.set_initial_state([2.0, 2.0, 0.0, 0.0])
    if with_tile:
        s.set_tile_dynamics(jdi_tile(2))
    s.initialize()
    s.set_options(options("jax", iterations_max=12, penalty_initial=100.0,
                          penalty_scaling=100.0, use_backtracking_linesearch=True,
                          parallel_linesearch=True, ls_phase_split=True,
                          ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8,
                          throw_errors=False))
    return s


def test_facade_block_step_matches_jax_facade(monkeypatch):
    calls = []
    ref = tr.trial_rollout_ref
    monkeypatch.setattr(tr, "trial_rollout_ref", lambda *a, **k: calls.append(1) or ref(*a, **k))
    s_plain = mpc.double_integrator_block_step_solver(False, torch.float64, "cpu")
    s_tile = mpc.double_integrator_block_step_solver(True, torch.float64, "cpu")
    assert tr.problem_ineligibility(s_tile.problem) is None
    assert sum(spec.dim for spec in s_tile.problem.constraints) == 4
    assert s_plain.solve() == s_tile.solve() == SolveStatus.SUCCESS
    assert calls  # the block step ran the trial rollout's plain twin
    assert s_plain.get_iterations() == s_tile.get_iterations()
    np.testing.assert_allclose(s_plain.state.u.numpy(), s_tile.state.u.numpy(), atol=1e-10)
    np.testing.assert_allclose(s_tile.get_input(0), [-1.0, -1.0], atol=1e-4)  # at the bound
    for with_tile, ts in ((False, s_plain), (True, s_tile)):
        js = _jax_block_step_solver(with_tile)
        assert js.solve() == ts.get_status()
        assert_same_solve(js, ts)


def test_grid_takes_the_column_step():
    """rollout_grid.cu has the column step at P 0 and 2 (at most two
    groups): the facade problem's four bound rows are refused, no rows or
    two are taken."""
    s = mpc.double_integrator_block_step_solver(True, torch.float64, "cpu")
    prob = dataclasses.replace(s.problem, dynamics_cols=double_integrator_cols(2))
    assert "4 constraint rows" in rg.ineligibility(prob)
    assert rg.ineligibility(dataclasses.replace(prob, constraints=())) is None
