"""The port's single-lane solve on the pendulum swing-ups, against altro_tpu.

The reference's pendulum_test.cpp oracles (tests/test_pendulum.py): the
midpoint dynamics goldens (state and Jacobians), the unconstrained
swing-up (N=50, terminal-state golden to 1e-5, at most 10 iterations)
and the goal-constrained one (N=20, dist < 1e-4 in at most 10), each
through `solver.solve` and the JAX `solve` in f64 under the default
strong-Wolfe search, the sequential backtracking and the non-split grid:
status and iterations exact, x and u to 1e-8 of JAX's. The (n, m) =
(2, 1) problem runs the latency backward's plain version here; on the
card the (2, 1) kernel.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.pendulum import pendulum_continuous as jpendulum  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.pendulum import pendulum_continuous  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.problem import lane_jacobian  # noqa: E402

CPU = dict(dtype=torch.float64, device="cpu")
XF = np.array([np.pi, 0.0])
SEARCHES = {"wolfe": {}, "backtracking": dict(use_backtracking_linesearch=True),
            "grid": dict(use_backtracking_linesearch=True, parallel_linesearch=True)}
# case: (N, tf, goal-constrained, iterations_max)
CASES = {"unconstrained": (50, 3.0, False, 20), "goal_constrained": (20, 2.0, True, 100)}


def _jax_problem(N, tf, goal):
    n, m = 2, 1
    cost = jlqr(np.concatenate([np.full((N, n), 1e-2), np.full((1, n), 1.0)]),
                np.full((N + 1, m), 1e-3), np.tile(XF, (N + 1, 1)), np.zeros((N + 1, m)))
    cons = ()
    if goal:
        cons = (JSpec(fn=lambda x, u, k: jnp.asarray(XF) - x, cone=JCone.ZERO, dim=2,
                      active=jnp.zeros(N + 1, bool).at[N].set(True)),)
    return JProblem(N=N, n=n, m=m, dynamics=jmidpoint(jpendulum()), dynamics_jac=None,
                    constraints=cons, cost=cost, h=jnp.full(N, float(np.float32(tf / N))),
                    x0=jnp.zeros(n))


def test_midpoint_dynamics_golden():
    """pendulum_test.cpp:14-43: the step and its Jacobians, as the port's
    solve takes them (forward mode)."""
    dyn = midpoint(pendulum_continuous())
    x = torch.tensor([0.1, -0.4], dtype=torch.float64)
    u = torch.tensor([1.34], dtype=torch.float64)
    h = float(np.float32(0.05))
    np.testing.assert_allclose(dyn(x, u, h, 0).numpy(),
                               [0.08445158545673655, -0.21395149094594346], atol=1e-6)
    Jx, Ju = lane_jacobian(dyn, x, u, h, 0)
    J_expected = np.array([[0.9755975228465564, 0.0495, 0.005000000000000001],
                           [-0.967268640223389, 0.9557742592228808, 0.198]])
    np.testing.assert_allclose(np.hstack([Jx.numpy(), Ju.numpy()]), J_expected, atol=1e-6)
    jdyn = jmidpoint(jpendulum())
    jx, ju = jnp.asarray([0.1, -0.4]), jnp.asarray([1.34])
    np.testing.assert_allclose(dyn(x, u, h, 0).numpy(), np.asarray(jdyn(jx, ju, h, 0)),
                               rtol=1e-15)
    np.testing.assert_allclose(Jx.numpy(), np.asarray(jax.jacfwd(jdyn)(jx, ju, h, 0)),
                               rtol=1e-14)


@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("case", list(CASES))
def test_swing_up_matches_jax(case, search):
    N, tf, goal, iters_max = CASES[case]
    jprob = _jax_problem(N, tf, goal)
    j_st0 = jinit(jprob)
    j_st0 = dataclasses.replace(j_st0, u=jnp.full_like(j_st0.u, 0.1))
    j_state, j_stats = jsolve(jprob, j_st0, JOpts(iterations_max=iters_max, **SEARCHES[search]))

    cons = (rp.pendulum_goal_constraint(N, **CPU),) if goal else ()
    prob = rp.pendulum_problem(N, tf, cons, **CPU)
    st0 = solver.init_state(prob)
    st0 = dataclasses.replace(st0, u=torch.full_like(st0.u, 0.1))
    state, stats = solver.solve(prob, st0, SolverOptions(iterations_max=iters_max,
                                                         **SEARCHES[search]))

    assert int(stats.status) == int(j_stats.status) == 0
    assert int(stats.iterations) == int(j_stats.iterations) <= 10
    assert int(stats.ls_iterations) == int(j_stats.ls_iterations)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
    if goal:
        assert float(torch.linalg.norm(state.x[-1] - torch.as_tensor(XF))) < 1e-4
    elif search == "wolfe":  # the reference's terminal-state golden
        xN_expected = [3.12099917161669, 0.0011966258762942175]
        np.testing.assert_allclose(np.linalg.norm(state.x[-1].numpy() - xN_expected), 0,
                                   atol=1e-5)
