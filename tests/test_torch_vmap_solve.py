"""The port's vmapped solve on the quadrotor waypoint row against
`jax.vmap(solve)`.

Counterpart: the non-tiled branch of scripts/bench_all.py:322-512 (the
n=12 rk4 quadrotor flying through waypoints), whose solve is
`jax.vmap(solve)` with `pallas_backward=True` and `ls_armijo_only=False`.
In f64 on the CPU the JAX custom_vmap rule falls back to the vmapped scan
and the port's dense backward runs its plain version: the same dense
expansions, the same recursion. B=8 lanes, N=10, 3 closed-loop ticks from
cold starts, the waypoint switching after tick 2. Per lane and tick:
status, iterations and ls_iterations exact; plant states, x, u and
stats.dphi (the strong-Wolfe completion) to 1e-8.
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
from altro_tpu_torch import convert, mpc  # noqa: E402
from altro_tpu_torch.models.integrators import rk4  # noqa: E402
from altro_tpu_torch.models.quadrotor import quadrotor_continuous  # noqa: E402
from altro_tpu_torch.parallel.batch import batch_init_state, vmap_solve  # noqa: E402

N, B, T, n, m = 10, 8, 3, 12, 4
SWITCH = 2  # waypoint 0 for ticks 0-1, waypoint 1 for tick 2
H = 0.05

OPTS = mpc.quadrotor_options()
J_OPTS = JOpts(**{f.name: getattr(OPTS, f.name) for f in dataclasses.fields(OPTS)})
DYN = jrk4(jquad())


def _rows():
    """Q diag and the waypoints' (q, c) rows, as scripts/bench_all.py builds them."""
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
    return 0.05 * np.random.default_rng(1).standard_normal((B, n))


def _jax_state0():
    return dataclasses.replace(jbatch_init(J_PROBLEM, B), u=jnp.full((B, N, m), mpc.QUAD_HOVER))


@pytest.fixture(scope="module")
def jax_run():
    st = _jax_state0()
    xt = jnp.asarray(_x_true0())
    ticks = []
    for t in range(T):
        w = (t // SWITCH) % 4
        xt, st, stats = _jax_tick(xt, st, jnp.asarray(Q_WP[w]), jnp.asarray(C_WP[w]))
        ticks.append((np.asarray(xt), jax.tree.map(np.asarray, st),
                      jax.tree.map(np.asarray, stats)))
    return ticks


def _port_problem():
    """The JAX problem's leaves carried across with convert (the bicycle's way)."""
    leaves = {k: np.asarray(getattr(J_PROBLEM.cost, k)) for k in ("Q", "R", "q", "r", "c")}
    leaves.update(h=np.asarray(J_PROBLEM.h), x0=np.asarray(J_PROBLEM.x0))
    return convert.problem_from_numpy(leaves, N=N, n=n, m=m,
                                      dynamics=rk4(quadrotor_continuous()), device="cpu")


def test_problem_matches_the_mpc_entry_point():
    a = _port_problem()
    b = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    for name in ("Q", "R", "q", "r", "c"):
        np.testing.assert_allclose(getattr(a.cost, name).numpy(), getattr(b.cost, name).numpy(),
                                   rtol=1e-15, atol=0, err_msg=name)
    assert torch.equal(a.h, b.h) and torch.equal(a.x0, b.x0)


def test_vmap_solve_matches_jax_vmapped_solve(jax_run):
    prob = _port_problem()
    jst = _jax_state0()  # the batched cold start carried across as numpy leaves
    st = convert.state_from_numpy(
        {f.name: jax.tree.map(np.asarray, getattr(jst, f.name)) for f in dataclasses.fields(jst)},
        device="cpu")
    port_st = dataclasses.replace(batch_init_state(prob, B),
                                  u=torch.full((B, N, m), mpc.QUAD_HOVER, dtype=torch.float64))
    for f in ("x", "u", "y", "rho", "K", "d", "P", "p", "reg"):
        assert torch.equal(getattr(st, f), getattr(port_st, f)), f
    xt = torch.as_tensor(_x_true0())
    statuses = set()
    for t, (j_xt, j_st, j_stats) in enumerate(jax_run):
        w = (t // SWITCH) % 4
        cost = dataclasses.replace(prob.cost, q=torch.as_tensor(Q_WP[w]),
                                   c=torch.as_tensor(C_WP[w]))
        st, stats = vmap_solve(dataclasses.replace(prob, cost=cost), OPTS)(xt, st)
        xt = prob.dynamics(xt.T, st.u[:, 0].T, prob.h[0], 0).T
        for name in ("status", "iterations", "ls_iterations"):
            np.testing.assert_array_equal(getattr(stats, name).numpy(), getattr(j_stats, name),
                                          err_msg=f"tick {t}: {name}")
        np.testing.assert_allclose(stats.dphi.numpy(), j_stats.dphi, rtol=0, atol=1e-8)
        assert np.isfinite(j_stats.dphi).all()
        st = dataclasses.replace(st, x=torch.cat([st.x[:, 1:], st.x[:, -1:]], dim=1),
                                 u=torch.cat([st.u[:, 1:], st.u[:, -1:]], dim=1))
        np.testing.assert_allclose(xt.numpy(), j_xt, rtol=0, atol=1e-8)
        np.testing.assert_allclose(st.x.numpy(), j_st.x, rtol=0, atol=1e-8)
        np.testing.assert_allclose(st.u.numpy(), j_st.u, rtol=0, atol=1e-8)
        statuses |= set(stats.status.tolist())
    assert 0 in statuses  # lanes converge


def test_waypoint_run_matches_jax_closed_loop(jax_run):
    prob = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    res = mpc.run_quadrotor_waypoints(prob, torch.as_tensor(_x_true0()), ticks=T,
                                      switch_every=SWITCH)
    j_xt, j_st, _ = jax_run[-1]
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.stack([s.iterations for _, _, s in jax_run]))
    np.testing.assert_array_equal(res.status.numpy(), np.stack([s.status for _, _, s in jax_run]))
    np.testing.assert_allclose(res.x_true.numpy(), j_xt, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.u.numpy(), j_st.u, rtol=0, atol=1e-8)
    got = res.metrics()
    assert res.final_waypoint == mpc.QUAD_WAYPOINTS[1]
    dist = np.linalg.norm(j_xt[:, :3] - np.asarray(mpc.QUAD_WAYPOINTS[1])[None], axis=1).mean()
    assert got["mean_final_waypoint_dist"] == pytest.approx(dist, rel=1e-9)
    assert got["mean_iterations"] == pytest.approx(res.iterations.double().mean().item())
