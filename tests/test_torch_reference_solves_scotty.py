"""The port's single-lane Scotty solve against altro_tpu.

bicycle_test.cpp:247-264 (tests/test_bicycle.py:111-116): the Scotty
tracking problem over the first window (N=30, the steering bound at
every knot, given as a plain function, so dense expansions) with
`SolverOptions(iterations_max=80)`, through `solver.solve`
(`mpc.scotty_reference_problem`) and the JAX `solve` in f64, under the
default strong-Wolfe search, the sequential backtracking and the
non-split grid. Status SUCCESS and iterations exact; x, u and the
objective to 1e-8 of JAX's.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.io.scotty import load_scotty as jload  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import mpc, solver  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402

N, n, m = 30, 4, 2
DM = 60 * np.pi / 180.0
SEARCHES = {"wolfe": {}, "backtracking": dict(use_backtracking_linesearch=True),
            "grid": dict(use_backtracking_linesearch=True, parallel_linesearch=True)}


def _jax_problem_and_state(ref):
    """tests/test_bicycle.py::make_scotty_problem."""
    steering = JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                     cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool))
    prob = JProblem(
        N=N, n=n, m=m, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
        constraints=(steering,),
        cost=jlqr(np.full((N + 1, n), 1e-2), np.full((N + 1, m), 1e-3), ref.x[: N + 1],
                  ref.u[: N + 1]),
        h=jnp.full(N, float(np.float32(ref.tf / ref.N))), x0=jnp.asarray(ref.x[0]))
    st = dataclasses.replace(jinit(prob), u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0]), (N, 1)),
                             x=jnp.asarray(ref.x[: N + 1]))
    return prob, st


@pytest.mark.parametrize("search", list(SEARCHES))
def test_scotty_single_solve_matches_jax(search):
    jprob, jst = _jax_problem_and_state(jload())
    j_state, j_stats = jsolve(jprob, jst, JOpts(iterations_max=80, **SEARCHES[search]))

    prob, st = mpc.scotty_reference_problem(load_scotty(), N=N, dtype=torch.float64,
                                            device="cpu")
    assert solver.al.diag_expansion_eligible(prob) is False  # dense, as JAX runs it
    state, stats = solver.solve(prob, st, SolverOptions(iterations_max=80, **SEARCHES[search]))

    assert int(stats.status) == int(j_stats.status) == 0
    assert int(stats.iterations) == int(j_stats.iterations)
    assert int(stats.ls_iterations) == int(j_stats.ls_iterations)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(stats.objective_value), float(j_stats.objective_value),
                               rtol=1e-8)
    np.testing.assert_allclose(float(stats.rho), float(j_stats.rho), rtol=1e-12)
    for zt, zj in zip(state.z, j_state.z):
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-8)
