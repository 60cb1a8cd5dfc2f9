"""The single-lane quadrotor latency row (`mpc.run_quadrotor_latency`)
against altro_tpu.

Counterpart: scripts/bench_all.py:514-564 (`quadrotor_latency_B1`): one
quadrotor through the waypoints, one `solve` a tick with the tiled row's
search on the single-lane backward and trial-rollout kernels
(`pallas_latency_backward`, `pallas_rollout`), then u_0 through the rk4
plant and `shift_trajectory`. In f64 on the CPU both packages run their
plain paths (JAX's dispatchers take the scans off the TPU; the port's
wrappers their plain versions on CPU tensors). N=10, 3 ticks from a cold
start, the waypoint switching after tick 2: status and iterations exact
per tick; the plant state, x and u to 1e-8.
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
from altro_tpu.models.tile_steps import quadrotor_tile as jquad_tile  # noqa: E402
from altro_tpu.models.tile_steps import rk4_tile as jrk4_tile  # noqa: E402
from altro_tpu.mpc import shift_trajectory  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import init_state, solve  # noqa: E402
from altro_tpu_torch import mpc, solver  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402

N, T, n, m = 10, 3, 12, 4
SWITCH = 2
H = 0.05

OPTS = mpc.quadrotor_latency_options()
J_OPTS = JOpts(**{f.name: getattr(OPTS, f.name) for f in dataclasses.fields(OPTS)})
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
    h=jnp.full(N, H), x0=jnp.zeros(n), dynamics_tile=jrk4_tile(jquad_tile()))


@jax.jit
def _jax_tick(x_true, st, q, c):
    prob = dataclasses.replace(J_PROBLEM, x0=x_true,
                               cost=dataclasses.replace(J_PROBLEM.cost, q=q, c=c))
    st, stats = solve(prob, st, J_OPTS)
    x_true = DYN(x_true, st.u[0], jnp.asarray(H), 0)
    return x_true, shift_trajectory(st), stats


def _x_true0():
    return 0.05 * np.random.default_rng(4).standard_normal(n)


def test_latency_row_matches_jax_closed_loop():
    st = dataclasses.replace(init_state(J_PROBLEM), u=jnp.full((N, m), mpc.QUAD_HOVER))
    xt = jnp.asarray(_x_true0())
    iters, statuses = [], []
    for t in range(T):
        w = (t // SWITCH) % 4
        xt, st, stats = _jax_tick(xt, st, jnp.asarray(Q_WP[w]), jnp.asarray(C_WP[w]))
        iters.append(int(stats.iterations))
        statuses.append(int(stats.status))

    prob = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    assert solver.single_lane_refusal(prob, OPTS) is None
    before = (rl.LAUNCHES, tr.LAUNCHES)
    res = mpc.run_quadrotor_latency(prob, torch.as_tensor(_x_true0()), ticks=T,
                                    switch_every=SWITCH)
    assert (rl.LAUNCHES, tr.LAUNCHES) == before  # CPU tensors: the plain versions
    assert res.iterations.shape == (T, 1) and res.x_true.shape == (1, n)
    assert res.iterations[:, 0].tolist() == iters
    assert res.status[:, 0].tolist() == statuses
    assert 0 in statuses
    np.testing.assert_allclose(res.x_true[0].numpy(), np.asarray(xt), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(st.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(st.u), rtol=0, atol=1e-8)
    got = res.metrics()
    dist = np.linalg.norm(np.asarray(xt)[:3] - np.asarray(mpc.QUAD_WAYPOINTS[1]))
    assert got["mean_final_waypoint_dist"] == pytest.approx(dist, rel=1e-9)
    assert got["mean_iterations"] == pytest.approx(np.mean(iters))
