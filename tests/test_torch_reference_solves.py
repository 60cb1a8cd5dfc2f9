"""The port's single-lane solve on the double integrator oracles, against altro_tpu.

The reference's double_integrator_test.cpp oracles
(tests/test_solver_double_integrator.py:89-122): the goal-constrained
solve in exactly 3 iterations, the control bounds in 5 (saturated at
-u_bnd), the SOC bound in 9 (saturated in norm), each with dist < 1e-4.
Each through `solver.solve` and the JAX `solve` on the same problem in
f64, under three line searches: the default options (the strong-Wolfe
cubic search), `use_backtracking_linesearch=True` (the sequential
backtracking) and `parallel_linesearch=True` with it (the non-split
grid). Status and iterations exact and equal to the oracle; x and u to
1e-8 of JAX's. Plus the dynamics golden of double_integrator_test.cpp.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.double_integrator import double_integrator_dynamics as jdyn  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import DiagonalCost as JCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch.models.double_integrator import double_integrator_dynamics  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402

N, NX, NU = rp.DI_N, 4, 2
CPU = dict(dtype=torch.float64, device="cpu")

# line searches: the default strong-Wolfe search, the sequential
# backtracking, the non-split grid
SEARCHES = {"wolfe": {}, "backtracking": dict(use_backtracking_linesearch=True),
            "grid": dict(use_backtracking_linesearch=True, parallel_linesearch=True)}

# case: (x0, constraint kinds, options, the oracle's iterations)
CASES = {
    "goal": ([1.0, 2.0, 0.0, 0.0], ("goal",), dict(penalty_scaling=100.0), 3),
    "control_bounds": ([2.0, 2.0, 0.0, 0.0], ("goal", "bounds"),
                       dict(penalty_initial=100.0, penalty_scaling=100.0), 5),
    "soc_bound": ([2.0, 2.0, 0.0, 0.0], ("goal", "soc"),
                  dict(penalty_initial=1.0, penalty_scaling=100.0), 9),
}


def _jax_problem(x0, kinds):
    cons = []
    for kind in kinds:
        if kind == "goal":
            cons.append(JSpec(fn=lambda x, u, k: x - jnp.zeros(NX), cone=JCone.ZERO, dim=NX,
                              active=jnp.zeros(N + 1, bool).at[N].set(True)))
        elif kind == "bounds":
            cons.append(JSpec(fn=lambda x, u, k: jnp.concatenate([u - 1.0, -1.0 - u]),
                              cone=JCone.NEGATIVE_ORTHANT, dim=2 * NU,
                              active=jnp.ones(N + 1, bool).at[N].set(False)))
        else:
            cons.append(JSpec(fn=lambda x, u, k: jnp.concatenate([u, jnp.full((1,), 1.0)]),
                              cone=JCone.SECOND_ORDER, dim=NU + 1,
                              active=jnp.ones(N + 1, bool).at[N].set(False)))
    cost = JCost(Q=jnp.ones((N + 1, NX)), R=jnp.full((N + 1, NU), 1e-2),
                 q=jnp.zeros((N + 1, NX)), r=jnp.zeros((N + 1, NU)), c=jnp.zeros(N + 1))
    return JProblem(N=N, n=NX, m=NU, dynamics=jdyn(2), dynamics_jac=None,
                    constraints=tuple(cons), cost=cost, h=jnp.full(N, rp.DI_H),
                    x0=jnp.asarray(x0))


def _port_problem(x0, kinds):
    make = {"goal": lambda: rp.di_goal_constraint(np.zeros(NX), **CPU),
            "bounds": lambda: rp.di_control_bounds(1.0, device="cpu"),
            "soc": lambda: rp.di_soc_control_bound(1.0, device="cpu")}
    return rp.double_integrator_problem(x0, [make[k]() for k in kinds], **CPU)


def test_dynamics_golden():
    """double_integrator_test.cpp:35-67."""
    xn = double_integrator_dynamics(2)(torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64),
                                       torch.tensor([10.1, -20.4], dtype=torch.float64),
                                       0.01, 0)
    expected = [0.10350500000000001, 0.20298000000000002, 0.40099999999999997,
                0.19600000000000004]
    np.testing.assert_allclose(xn.numpy(), expected, atol=1e-8)
    jx = jdyn(2)(jnp.asarray([0.1, 0.2, 0.3, 0.4]), jnp.asarray([10.1, -20.4]), 0.01, 0)
    np.testing.assert_allclose(xn.numpy(), np.asarray(jx), rtol=1e-15)


@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("case", list(CASES))
def test_double_integrator_oracle_matches_jax(case, search):
    x0, kinds, kw, oracle_iters = CASES[case]
    opts = SolverOptions(**kw, **SEARCHES[search])
    jprob = _jax_problem(x0, kinds)
    j_state, j_stats = jsolve(jprob, jinit(jprob), JOpts(**kw, **SEARCHES[search]))

    prob = _port_problem(x0, kinds)
    before = rl.LAUNCHES
    state, stats = solver.solve(prob, solver.init_state(prob), opts)
    assert rl.LAUNCHES == before  # CPU: the plain backward

    assert int(stats.status) == int(j_stats.status) == 0
    assert int(stats.iterations) == int(j_stats.iterations) == oracle_iters
    assert int(stats.ls_iterations) == int(j_stats.ls_iterations)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(stats.objective_value), float(j_stats.objective_value),
                               rtol=1e-8)
    assert float(torch.linalg.norm(state.x[N])) < 1e-4
    if case == "control_bounds":
        np.testing.assert_allclose(state.u[0].numpy(), [-1.0, -1.0], atol=1e-4)
    if case == "soc_bound":
        np.testing.assert_allclose(float(torch.linalg.norm(state.u[0])), 1.0, atol=1e-2)
