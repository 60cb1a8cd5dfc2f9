"""tests/test_aux.py's pendulum swing-up through the implicit midpoint rule
(`implicit.implicit_dynamics`) on the port, held to JAX's solve in f64."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.implicit import implicit_dynamics as jimplicit  # noqa: E402
from altro_tpu.implicit import implicit_midpoint_residual as jres  # noqa: E402
from altro_tpu.models.pendulum import pendulum_continuous as jpendulum  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.problem import Problem, lqr_cost_from_reference  # noqa: E402
from altro_tpu_torch.solver import init_state, solve  # noqa: E402
from test_torch_aux import _port_implicit  # noqa: E402


def test_solve_with_implicit_dynamics_matches_jax():
    """test_aux.py's pendulum swing-up through the implicit midpoint rule,
    under the sequential backtracking search: SUCCESS in JAX's iterations,
    x within 1e-10. (Under the default strong-Wolfe search both packages
    take the same 17 trials of the first iteration, bit for bit in what
    they print, until the zoom's window is 2e-6 wide; there the cubic fit
    is ill-conditioned, and JAX's rounding puts its argmin at 0.357,
    outside the window, which passes, while the port's stays inside and
    the search ends LINE_SEARCH_FAILED.)"""
    N, n, m = 30, 2, 1
    xf = np.array([np.pi, 0.0])
    Qd = np.concatenate([np.full((N, n), 1e-2), np.full((1, n), 1.0)])
    Rd = np.full((N + 1, m), 1e-3)
    jstep, jjac = jimplicit(jres(jpendulum()))
    jp = JProblem(N=N, n=n, m=m, dynamics=jstep, dynamics_jac=jjac, constraints=(),
                  cost=jlqr(Qd, Rd, np.tile(xf, (N + 1, 1)), np.zeros((N + 1, m))),
                  h=jnp.full(N, 0.1), x0=jnp.zeros(n))
    jst = dataclasses.replace(jinit(jp), u=jnp.full((N, m), 0.1))
    js, jstats = jsolve(jp, jst, JOpts(iterations_max=30, use_backtracking_linesearch=True))
    _, (step, jac) = _port_implicit()
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    tp = Problem(N=N, n=n, m=m, dynamics=step, dynamics_jac=jac, constraints=(),
                 cost=lqr_cost_from_reference(t(Qd), t(Rd), t(np.tile(xf, (N + 1, 1))),
                                              t(np.zeros((N + 1, m)))),
                 h=torch.full((N,), 0.1, dtype=torch.float64),
                 x0=torch.zeros(n, dtype=torch.float64))
    tst = dataclasses.replace(init_state(tp), u=torch.full((N, m), 0.1, dtype=torch.float64))
    ts, tstats = solve(tp, tst, SolverOptions(iterations_max=30, use_backtracking_linesearch=True))
    assert int(tstats.status) == int(jstats.status) == 0
    assert int(tstats.iterations) == int(jstats.iterations)
    assert abs(float(ts.x[-1, 0]) - np.pi) < 0.2
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-10)
