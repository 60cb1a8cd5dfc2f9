"""The tiled quadrotor waypoint row (`mpc.run_quadrotor_waypoints_tiled`)
against altro_tpu.

Counterpart: the tiled branch of scripts/bench_all.py:433-472
(`quadrotor_waypoint_mpc_B1024_tiled`): JAX's `solve_tiled` on the rk4
quadrotor with the Armijo-only grid. JAX's `solve_tiled` runs its Pallas
backward (float32, interpret mode off the TPU) on 1024-lane tiles, so in
f64 it is held here through its own contract (tests/test_tile_solver.py):
it computes the per-lane iterates of `jax.vmap(solve)` with the same
options, diagonal expansions and the scan grid. The port's row runs its
plain paths (CPU tensors: the plain backward and `rollout_grid_ref`).
B=8 lanes, N=10, 3 closed-loop ticks from cold starts, the waypoint
switching after tick 2. Per lane and tick: status and iterations exact;
plant states, x and u to 1e-8.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.integrators import rk4 as jrk4  # noqa: E402
from altro_tpu.models.quadrotor import quadrotor_continuous as jquad  # noqa: E402
from altro_tpu.mpc import shift_trajectory  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import solve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402

N, B, T, n, m = 10, 8, 3, 12, 4
SWITCH = 2  # waypoint 0 for ticks 0-1, waypoint 1 for tick 2
H = 0.05

OPTS = mpc.quadrotor_tiled_options()
# vmap(solve) reads pallas_backward (dense expansions); solve_tiled does not
J_OPTS = dataclasses.replace(
    JOpts(**{f.name: getattr(OPTS, f.name) for f in dataclasses.fields(OPTS)}),
    pallas_backward=False)
DYN = jrk4(jquad())


def _rows():
    Qd = np.tile(np.concatenate([np.full(3, 1.0), np.full(9, 0.1)]), (N + 1, 1))
    Qd[N] *= 10
    wps = np.zeros((4, n))
    wps[:, :3] = mpc.QUAD_WAYPOINTS
    c_u = 0.5 * float(np.full(m, mpc.QUAD_HOVER) @ (np.full(m, 1e-2) * np.full(m, mpc.QUAD_HOVER)))
    q_wp = -(Qd[None] * wps[:, None])
    c_wp = 0.5 * np.sum(Qd[None] * wps[:, None] ** 2, axis=2)
    c_wp[:, :N] += c_u
    return Qd, q_wp, c_wp


QD, Q_WP, C_WP = _rows()
J_PROBLEM = JProblem(
    N=N, n=n, m=m, dynamics=DYN, dynamics_jac=None, constraints=(),
    cost=jlqr(jnp.asarray(QD), jnp.full((N + 1, m), 1e-2),
              jnp.asarray(np.tile(np.r_[mpc.QUAD_WAYPOINTS[0], np.zeros(9)], (N + 1, 1))),
              jnp.full((N + 1, m), mpc.QUAD_HOVER)),
    h=jnp.full(N, H), x0=jnp.zeros(n))


@jax.jit
def _jax_tick(x_true, st, q, c):
    prob = dataclasses.replace(J_PROBLEM, cost=dataclasses.replace(J_PROBLEM.cost, q=q, c=c))
    st, stats = jax.vmap(
        lambda x0, s: solve(dataclasses.replace(prob, x0=x0), s, J_OPTS))(x_true, st)
    x_true = jax.vmap(lambda x, u: DYN(x, u, jnp.asarray(H), 0))(x_true, st.u[:, 0])
    return x_true, jax.vmap(shift_trajectory)(st), stats


def _x_true0():
    return 0.05 * np.random.default_rng(2).standard_normal((B, n))


def test_tiled_row_matches_jax_closed_loop():
    st = dataclasses.replace(jbatch_init(J_PROBLEM, B), u=jnp.full((B, N, m), mpc.QUAD_HOVER))
    xt = jnp.asarray(_x_true0())
    iters, statuses = [], []
    for t in range(T):
        w = (t // SWITCH) % 4
        xt, st, stats = _jax_tick(xt, st, jnp.asarray(Q_WP[w]), jnp.asarray(C_WP[w]))
        iters.append(np.asarray(stats.iterations))
        statuses.append(np.asarray(stats.status))

    # the row's kernels take the problem in float32 (on the card)
    assert tsv.kernel_refusal(mpc.quadrotor_waypoint_problem(N=N, device="cpu"), OPTS,
                              vmapped=False) is None
    prob = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    before = rg.LAUNCHES
    res = mpc.run_quadrotor_waypoints_tiled(prob, torch.as_tensor(_x_true0()), ticks=T,
                                            switch_every=SWITCH)
    assert rg.LAUNCHES == before  # CPU tensors: the plain grid
    np.testing.assert_array_equal(res.iterations.numpy(), np.stack(iters))
    np.testing.assert_array_equal(res.status.numpy(), np.stack(statuses))
    assert 0 in set(res.status.flatten().tolist())  # lanes converge
    np.testing.assert_allclose(res.x_true.numpy(), np.asarray(xt), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(st.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(st.u), rtol=0, atol=1e-8)
    got = res.metrics()
    assert res.final_waypoint == mpc.QUAD_WAYPOINTS[1]
    dist = np.linalg.norm(np.asarray(xt)[:, :3] - np.asarray(mpc.QUAD_WAYPOINTS[1])[None],
                          axis=1).mean()
    assert got["mean_final_waypoint_dist"] == pytest.approx(dist, rel=1e-9)
