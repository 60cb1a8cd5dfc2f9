"""The rocket landing's single solve against altro_tpu (tests/test_rocket.py).

JAX's three rocket tests, each held against the port's `solver.solve` on
the same problem in f64 (N=40, the tests' options: 60 iterations,
penalty 10 scaled by 10, the sequential backtracking, the reference's
1e-4 tolerances, u = hover): the converged solve (SUCCESS, feasibility,
touchdown), its cones (each within 1e-4, the pointing cone active) and
the warm restart from the converged state with `penalty_warm_start`
(SUCCESS in at most 2 iterations). Each against JAX: status, iterations
and ls_iterations equal, x and u to 1e-8. CPU tensors run the plain
backward (riccati_latency_ref, launching nothing); on the card in f32
the backward is csrc/riccati_latency.cu at (6, 3).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

from rocket_landing import build_problem  # noqa: E402

from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import mpc, solver  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.reference_problems import rocket_landing_problem  # noqa: E402

N = 40
TAN_TH = np.tan(np.deg2rad(25.0))
TAN_GA = np.tan(np.deg2rad(45.0))
KW = dict(iterations_max=60, penalty_initial=10.0, penalty_scaling=10.0,
          use_backtracking_linesearch=True, throw_errors=False)


@pytest.fixture(scope="module")
def solves():
    """(JAX, port) pairs of (state, stats): the cold solve and the warm
    restart from its result."""
    jprob, jhover = build_problem(N=N, dtype=jnp.float64)
    jst = dataclasses.replace(jinit(jprob), u=jnp.tile(jhover, (N, 1)))
    j1 = jax.jit(lambda s: jsolve(jprob, s, JOpts(**KW)))(jst)
    j2 = jax.jit(lambda s: jsolve(jprob, s, JOpts(**KW, penalty_warm_start=True)))(j1[0])

    prob, hover = rocket_landing_problem(N=N, dtype=torch.float64, device="cpu")
    before = rl.LAUNCHES
    r1 = mpc.run_rocket_landing(prob, hover, SolverOptions(**KW))
    t2 = solver.solve(prob, r1.state, SolverOptions(**KW, penalty_warm_start=True))
    assert rl.LAUNCHES == before  # CPU: the plain backward only
    return {"cold": (j1, (r1.state, r1.stats)), "warm": (j2, t2), "port": r1}


def _parity(pair):
    (jst, jstats), (st, stats) = pair
    for k in ("status", "iterations", "ls_iterations"):
        assert int(getattr(stats, k)) == int(getattr(jstats, k)), k
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(jst.u), rtol=0, atol=1e-8)


def test_rocket_landing_converges(solves):
    _parity(solves["cold"])
    _, (st, stats) = solves["cold"]
    assert int(stats.status) == 0 and float(stats.primal_feasibility) < 1e-4
    m = mpc.rocket_metrics(solves["port"])
    assert m["r_N"] < 1e-4 and m["v_N"] < 1e-4


def test_rocket_cones_satisfied_and_active(solves):
    _parity(solves["cold"])
    _, (st, _) = solves["cold"]
    u, x = st.u.numpy(), st.x.numpy()
    tol = 1e-4
    assert np.all(np.linalg.norm(u[:, :2], axis=1) <= TAN_TH * u[:, 2] + tol)
    assert np.all(np.linalg.norm(u, axis=1) <= 20.0 + tol)
    assert np.all(u[:, 2] >= 2.0 - tol)
    assert np.all(np.linalg.norm(x[:, :2], axis=1) <= TAN_GA * x[:, 2] + tol)
    m = mpc.rocket_metrics(solves["port"])
    assert m["max_cone_excess"] <= tol and m["max_pointing_ratio"] > 0.999


def test_rocket_warm_restart_one_iteration(solves):
    _parity(solves["warm"])
    _, (_, stats) = solves["warm"]
    assert int(stats.status) == 0 and int(stats.iterations) <= 2
