"""The single-lane solve's phase-split grid without the trial rollout,
against altro_tpu on tests/test_api.py's configuration.

tests/test_api.py::test_set_tile_dynamics_fast_path_matches_plain solves
the pendulum swing-up (midpoint, N=30, h=float32(0.06), Q=0.1, R=1e-3, the input
bounds |u| <= 6 as the facade declares them: two affine NEGATIVE_ORTHANT
rows with a diagonal Hessian on the stage knots, u = 0.1) under the
phase-split Armijo-only grid with the default `pallas_rollout` and no
block step: JAX's solve falls back to its scan grid. The port's
`solver.solve` on the same problem, built here through its `Problem`
(tests/test_torch_api_block_step.py builds it through the port's
facade), does the same on the CPU in f64: status,
iterations and ls_iterations equal, x and u to 1e-8, nothing launched.
On the card such a problem is refused before the solve starts
(tests/test_torch_single_solve.py::test_solve_refuses_ineligible_trial_grid).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu.api import ALTROSolver  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.pendulum import pendulum_continuous as jpendulum  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch.cones import Cone  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.pendulum import pendulum_continuous  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.problem import ConstraintSpec, Problem, lqr_cost_from_reference  # noqa: E402

N, n, m = 30, 2, 1
KW = dict(iterations_max=12, use_backtracking_linesearch=True, parallel_linesearch=True,
          ls_phase_split=True, ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8,
          throw_errors=False)


def _jax_facade():
    """tests/test_api.py's build(False), solved."""
    dyn = jmidpoint(jpendulum())
    s = ALTROSolver(N)
    s.set_dimension(n, m)
    s.set_time_step(0.06)
    s.set_explicit_dynamics(lambda x, u, h, k: dyn(x, u, h, k))
    s.set_lqr_cost(np.full(n, 1e-1), np.full(m, 1e-3), np.array([np.pi, 0.0]), np.zeros(m))
    s.set_input_bounds(u_lo=[-6.0], u_hi=[6.0])
    s.set_initial_state(np.zeros(n))
    s.initialize()
    s.set_input(np.full((m,), 0.1), 0, N)
    s.set_options(JOpts(**KW))
    status = s.solve()
    assert s.problem.dynamics_tile is None
    return s, status


def _port_problem():
    kw = dict(dtype=torch.float64, device="cpu")
    cost = lqr_cost_from_reference(
        torch.full((N + 1, n), 1e-1, **kw), torch.full((N + 1, m), 1e-3, **kw),
        torch.tensor([np.pi, 0.0], **kw).expand(N + 1, n), torch.zeros((N + 1, m), **kw))
    active = torch.ones(N + 1, dtype=torch.bool)
    active[N] = False
    bounds = ConstraintSpec(fn=lambda x, u, k: torch.cat([u - 6.0, -6.0 - u]),
                            cone=Cone.NEGATIVE_ORTHANT, dim=2, active=active,
                            label="input bounds", diag_hessian=True, affine=True)
    return Problem(N=N, n=n, m=m, dynamics=midpoint(pendulum_continuous()), dynamics_jac=None,
                   constraints=(bounds,), cost=cost,
                   h=torch.full((N,), float(np.float32(0.06)), **kw),  # the facade's float32 h
                   x0=torch.zeros(n, **kw))


def test_phase_split_without_block_step_matches_jax_facade():
    s, status = _jax_facade()
    prob = _port_problem()
    opts = SolverOptions(**KW)
    assert opts.pallas_rollout and solver.single_lane_refusal(prob, opts) is None
    state = dataclasses.replace(solver.init_state(prob),
                                u=torch.full((N, m), 0.1, dtype=torch.float64))
    before = (rl.LAUNCHES, tr.LAUNCHES)
    st, stats = solver.solve(prob, state, opts)
    assert (rl.LAUNCHES, tr.LAUNCHES) == before  # CPU: plain versions only
    assert int(stats.status) == int(status)
    assert int(stats.iterations) == s.get_iterations()
    assert int(stats.ls_iterations) == int(s.stats.ls_iterations)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(s.state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(s.state.u), rtol=0, atol=1e-8)
    # the bound is in play: the swing-up saturates the torque
    assert float(st.u.abs().max()) > 5.9
