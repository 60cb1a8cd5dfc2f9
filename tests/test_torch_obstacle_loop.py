"""tests/test_obstacle_mpc.py's single-lane loop on the port
(`mpc.run_obstacle_loop`) against the JAX package's loop in float64 on
the CPU: N=30, 40 ticks, the disc of radius 0.6 on the path, the
sequential backtracking search and penalty warm start, with the obstacle
and without it (the twin that shows the path crosses the disc). Statuses
and iterations equal tick for tick, distances and tracking errors within
1e-8, and the test's own oracle."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.io.scotty import load_scotty as jload  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.mpc import set_initial_state, shift_trajectory, update_linear_costs  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.solver import solve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402

test_obstacle_mpc = pytest.importorskip("test_obstacle_mpc")

R_OBS = test_obstacle_mpc.R_OBS


def jax_loop(with_obstacle, exact=False, ticks=test_obstacle_mpc.NSIM):
    """tests/test_obstacle_mpc.py's `_run_loop` with `exact_al_hessian`
    and the tick count as parameters; returns (dists, errs, statuses,
    iterations)."""
    ref = jload()
    N = test_obstacle_mpc.N
    problem, state, c_obs, h = test_obstacle_mpc._build(ref, with_obstacle)
    opts = JOpts(iterations_max=30, use_backtracking_linesearch=True, penalty_warm_start=True,
                 throw_errors=False, exact_al_hessian=exact)
    solve_jit = jax.jit(solve, static_argnames=("opts",))
    dyn = jmidpoint(jbicycle())
    Qd = np.full(4, 1e-2)
    c_u = 0.5 * float(ref.u[0] @ (np.full(2, 1e-3) * ref.u[0]))
    x = np.asarray(ref.x[0])
    dists, errs, statuses, iters = [], [], [], []
    for t in range(ticks):
        state, stats = solve_jit(problem, state, opts)
        statuses.append(int(stats.status))
        iters.append(int(stats.iterations))
        x = np.asarray(dyn(jnp.asarray(x), jnp.asarray(state.u[0]), h, 0))
        dists.append(float(np.linalg.norm(x[:2] - c_obs)))
        errs.append(float(np.linalg.norm(x[:2] - ref.x[t + 1][:2])))
        window = ref.x[t + 1: t + N + 2]
        c_new = 0.5 * np.sum(Qd[None, :] * window * window, axis=1)
        c_new[:N] += c_u
        problem = update_linear_costs(problem, q=-(Qd[None, :] * window), c=c_new)
        problem = set_initial_state(problem, x)
        state = shift_trajectory(state)
    return np.asarray(dists), np.asarray(errs), statuses, iters


def check_loop(with_obstacle, exact=False, ticks=test_obstacle_mpc.NSIM):
    d, e, s, it = jax_loop(with_obstacle, exact, ticks)
    res = mpc.run_obstacle_loop(load_scotty(), with_obstacle, exact, ticks=ticks,
                                t_obs=test_obstacle_mpc.T_OBS, r_obs=R_OBS,
                                dtype=torch.float64, device="cpu")
    assert res.status == s
    assert res.iterations == it
    np.testing.assert_allclose(res.dist, d, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.tracking_error, e, rtol=0, atol=1e-8)
    return res


def test_obstacle_loop_matches_jax_and_clears():
    res = check_loop(True)
    m = res.metrics()
    assert m["min_dist"] > R_OBS - 0.02
    assert m["mean_tracking_error"] < 1.0
    assert m["last_tracking_error"] < 0.5
    assert m["success_rate"] > 0.9


def test_obstacle_free_twin_matches_jax_and_crosses_the_disc():
    res = check_loop(False)
    assert res.metrics()["min_dist"] < 0.5 * R_OBS
