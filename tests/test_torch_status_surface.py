"""The port's status surface against altro_tpu, solve for solve.

The cases of tests/test_status_surface.py: MERIT_FUN_GRADIENT_TOO_SMALL
kept through the loop and cleared by a real step, the divergence guards
(MAX_OBJECTIVE_EXCEEDED, STATE_OUT_OF_BOUNDS, INPUT_OUT_OF_BOUNDS) off
by default, and bp_fail_index (N when the backward pass holds, the
failing knot with BACKWARD_PASS_FAILED). Unconstrained double
integrator (N=10), default strong-Wolfe search, f64 on the CPU: status,
iterations, bp_fail_index and alpha equal to JAX's, and the JAX test's
own expectation. The facade's case (test_status_surface.py:141): under
`throw_errors` both facades return MERIT_FUN_GRADIENT_TOO_SMALL without
raising.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.double_integrator import double_integrator_dynamics as jdyn  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import DiagonalCost as JCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402

N = rp.DI_N
S = SolveStatus
# case: (R weight, options, expected statuses, expected iterations or None)
CASES = {
    "merit_gradient_too_small": (
        1e-2, dict(iterations_max=3, tol_meritfun_gradient=1e10, tol_stationarity=1e-12),
        (S.MERIT_FUN_GRADIENT_TOO_SMALL,), 3),
    "merit_gradient_status_clears": (1e-2, dict(iterations_max=10),
                                     (S.SUCCESS, S.MAX_ITERATIONS), None),
    "max_objective_exceeded": (1e-2, dict(iterations_max=10, max_objective_value=1e-6,
                                          tol_stationarity=0.0),
                               (S.MAX_OBJECTIVE_EXCEEDED,), 1),
    "state_out_of_bounds": (1e-2, dict(iterations_max=10, max_state_value=0.5,
                                       tol_stationarity=0.0), (S.STATE_OUT_OF_BOUNDS,), 1),
    "input_out_of_bounds": (1e-2, dict(iterations_max=10, max_input_value=1e-7,
                                       tol_stationarity=0.0), (S.INPUT_OUT_OF_BOUNDS,), 1),
    "guards_off_by_default": (1e-2, dict(iterations_max=10), (S.SUCCESS,), None),
    "bp_fail_index_ok_is_N": (1e-2, dict(iterations_max=3), None, None),
    "bp_fail_index_reports_failing_knot": (
        -1.0, dict(iterations_max=5, reg_initial=0.0, reg_max_retries=0),
        (S.BACKWARD_PASS_FAILED,), None),
}


def _jax_problem(r):
    cost = JCost(Q=jnp.ones((N + 1, 4)), R=jnp.full((N + 1, 2), r), q=jnp.zeros((N + 1, 4)),
                 r=jnp.zeros((N + 1, 2)), c=jnp.zeros(N + 1))
    return JProblem(N=N, n=4, m=2, dynamics=jdyn(2), dynamics_jac=None, constraints=(),
                    cost=cost, h=jnp.full(N, rp.DI_H), x0=jnp.asarray([1.0, 2.0, 0.0, 0.0]))


@pytest.mark.parametrize("case", list(CASES))
def test_status_surface_matches_jax(case):
    r, kw, want, want_iters = CASES[case]
    jprob = _jax_problem(r)
    _, j_stats = jsolve(jprob, jinit(jprob), JOpts(throw_errors=False, **kw))
    prob = rp.double_integrator_problem([1.0, 2.0, 0.0, 0.0], r=r, dtype=torch.float64,
                                        device="cpu")
    _, stats = solver.solve(prob, solver.init_state(prob),
                            SolverOptions(throw_errors=False, **kw))

    for k in ("status", "iterations", "bp_fail_index", "ls_iterations"):
        assert int(getattr(stats, k)) == int(getattr(j_stats, k)), k
    np.testing.assert_allclose(float(stats.alpha), float(j_stats.alpha), rtol=1e-12)
    if want is not None:
        assert int(stats.status) in want
    if want_iters is not None:
        assert int(stats.iterations) == want_iters
    if case == "merit_gradient_too_small":
        assert float(stats.alpha) == 0.0
    if case == "bp_fail_index_ok_is_N":
        assert int(stats.bp_fail_index) == N
    if case == "bp_fail_index_reports_failing_knot":
        assert int(stats.bp_fail_index) == 0


def test_api_merit_gradient_too_small_is_benign():
    """throw_errors does not raise on MERIT_FUN_GRADIENT_TOO_SMALL (the
    reference loop returns NoError through it, solver.cpp:451)."""
    from altro_tpu.api import ALTROSolver as JSolver
    from altro_tpu_torch.api import ALTROSolver
    from altro_tpu_torch.models.double_integrator import double_integrator_dynamics

    statuses = []
    for lib in ("jax", "torch"):
        if lib == "jax":
            s, dyn, Opts = JSolver(N), jdyn(2), JOpts
        else:
            s = ALTROSolver(N, dtype=torch.float64, device="cpu")
            dyn, Opts = double_integrator_dynamics(2), SolverOptions
        s.set_dimension(4, 2)
        s.set_time_step(rp.DI_H)
        s.set_explicit_dynamics(lambda x, u, h, k, dyn=dyn: dyn(x, u, h, k))
        s.set_lqr_cost(np.ones(4), np.full(2, 1e-2), np.zeros(4), np.zeros(2))
        s.set_initial_state([1.0, 2.0, 0.0, 0.0])
        s.initialize()
        s.set_options(Opts(iterations_max=2, tol_meritfun_gradient=1e10,
                           tol_stationarity=1e-12, throw_errors=True))
        statuses.append((int(s.solve()), s.get_iterations()))  # must not raise
    assert statuses[1] == statuses[0] == (int(SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL), 2)
