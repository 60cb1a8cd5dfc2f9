"""The quadrotor with one waypoint per lane: its plain trial grid with
per-lane cost rows against JAX's scan grid with `prob_axes` on q and c,
and the tiled waypoint row with each lane flying its own waypoint
sequence against `jax.vmap(solve)`, in f64 on the CPU.

* The grid: `rollout_grid_ref` on `mpc.quadrotor_waypoint_problem` (N=10)
  with q [N+1, n, B] and c [N+1, B] one row per lane (lane b's waypoint
  b mod 4) against altro_tpu/ops/tile_iter.py::rollout_grid_tiled with
  q and c tiled (tests/test_pallas_rollout_tiled.py's pattern), one lane
  tile (1024 lanes), W=8: phi to 1e-12 relative, states to 1e-12. This is
  the plain twin the card holds the quadrotor's LANE_COST kernel to.
* The row: `mpc.run_quadrotor_waypoints_tiled(per_lane_waypoints=True)`,
  B=8 lanes from cold starts, 3 ticks, the waypoints switching after tick
  2 (lane b at waypoint (b + t // 2) mod 4), against `jax.vmap(solve)`
  with the row's options and those per-lane rows (tests/
  test_torch_quadrotor_tiled.py's closed loop): statuses and iterations
  exact, plant states, x and u to 1e-8, and each lane's final waypoint
  distance.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.ops import tile_iter as jti  # noqa: E402
from altro_tpu.ops.pallas_riccati import batch_to_tiles, tiles_to_batch  # noqa: E402
from altro_tpu.mpc import shift_trajectory  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.solver import solve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from test_torch_quadrotor_tiled import C_WP, DYN, H, J_OPTS, J_PROBLEM, Q_WP  # noqa: E402
from test_torch_quadrotor_tiled import B, N, T, m, n, _x_true0  # noqa: E402

SWITCH = 2


def _lane_rows(lanes, t=0):
    """q [lanes, N+1, n] and c [lanes, N+1]: lane b's waypoint at tick t."""
    idx = ((t // SWITCH) + np.arange(lanes)) % 4
    return Q_WP[idx], C_WP[idx]


def test_plain_grid_per_lane_rows_match_jax_scan_grid():
    lanes, W = 1024, 8
    q, c = _lane_rows(lanes)
    rng = np.random.default_rng(5)
    xr = 0.02 * rng.standard_normal((lanes, N + 1, n))
    ur = mpc.QUAD_HOVER + 0.001 * rng.standard_normal((lanes, N, m))
    K = 0.005 * rng.standard_normal((lanes, N, m, n))
    d = 0.002 * rng.standard_normal((lanes, N, m))
    rho = 1.0 + rng.random(lanes)
    x0 = 0.05 * rng.standard_normal((lanes, n))
    alphas = 0.5 ** np.arange(W)

    t = lambda a: batch_to_tiles(jnp.asarray(a))  # noqa: E731
    prob_j = dataclasses.replace(J_PROBLEM, x0=t(x0), cost=dataclasses.replace(
        J_PROBLEM.cost, q=t(q), c=t(c)))
    axes = dataclasses.replace(
        J_PROBLEM, cost=dataclasses.replace(J_PROBLEM.cost, Q=False, R=False, q=True, r=False,
                                            c=True),
        h=False, x0=True, A=False, B=False, f_aff=False, constraints=())
    phi_j, xs_j = jti.rollout_grid_tiled(jti.TileArgs(prob_j, axes, ()), t(xr), t(ur), t(K),
                                         t(d), (), t(rho[:, None])[:, 0], jnp.asarray(alphas),
                                         t(x0))
    phi_j = np.stack([np.asarray(tiles_to_batch(phi_j[w][:, None]))[:, 0] for w in range(W)])
    xs_j = np.stack([np.asarray(tiles_to_batch(xs_j[w])) for w in range(W)])  # [W, B, N+1, n]

    prob = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    lane_minor = lambda a: torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)))  # noqa
    prob = dataclasses.replace(prob, cost=dataclasses.replace(prob.cost, q=lane_minor(q),
                                                              c=lane_minor(c)))
    assert rg.rollout_tiled_eligible(prob) and rg.lane_rows(prob, lanes)["q"].shape == (
        N + 1, n, lanes)
    phi, xs = rg.rollout_grid_ref(prob, lane_minor(xr), lane_minor(ur), lane_minor(K),
                                  lane_minor(d), (), torch.as_tensor(rho),
                                  torch.as_tensor(alphas), lane_minor(x0))
    np.testing.assert_allclose(phi.numpy(), phi_j, rtol=1e-12)
    np.testing.assert_allclose(xs.permute(0, 3, 1, 2).numpy(), xs_j, rtol=0, atol=1e-12)


@jax.jit
def _jax_tick(x_true, st, q, c):
    def one(x0, s, q_, c_):
        prob = dataclasses.replace(J_PROBLEM, x0=x0, cost=dataclasses.replace(
            J_PROBLEM.cost, q=q_, c=c_))
        return solve(prob, s, J_OPTS)

    st, stats = jax.vmap(one)(x_true, st, q, c)
    x_true = jax.vmap(lambda x, u: DYN(x, u, jnp.asarray(H), 0))(x_true, st.u[:, 0])
    return x_true, jax.vmap(shift_trajectory)(st), stats


def test_tiled_row_per_lane_waypoints_match_jax_closed_loop():
    st = dataclasses.replace(jbatch_init(J_PROBLEM, B), u=jnp.full((B, N, m), mpc.QUAD_HOVER))
    xt = jnp.asarray(_x_true0())
    iters, statuses = [], []
    for tick in range(T):
        q, c = _lane_rows(B, tick)
        xt, st, stats = _jax_tick(xt, st, jnp.asarray(q), jnp.asarray(c))
        iters.append(np.asarray(stats.iterations))
        statuses.append(np.asarray(stats.status))

    prob = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    res = mpc.run_quadrotor_waypoints_tiled(prob, torch.as_tensor(_x_true0()), ticks=T,
                                            switch_every=SWITCH, per_lane_waypoints=True)
    np.testing.assert_array_equal(res.iterations.numpy(), np.stack(iters))
    np.testing.assert_array_equal(res.status.numpy(), np.stack(statuses))
    np.testing.assert_allclose(res.x_true.numpy(), np.asarray(xt), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(st.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(st.u), rtol=0, atol=1e-8)
    final = np.asarray(mpc.QUAD_WAYPOINTS)[((T - 1) // SWITCH + np.arange(B)) % 4]
    np.testing.assert_array_equal(np.asarray(res.final_waypoint), final)
    dist = np.linalg.norm(np.asarray(xt)[:, :3] - final, axis=1).mean()
    assert res.metrics()["mean_final_waypoint_dist"] == pytest.approx(dist, rel=1e-9)
    # the tiled row and the vmapped solve take the same steps per lane
    vm = mpc.run_quadrotor_waypoints(prob, torch.as_tensor(_x_true0()), ticks=T,
                                     switch_every=SWITCH, per_lane_waypoints=True,
                                     opts=mpc.quadrotor_tiled_options().replace(
                                         pallas_backward=False))
    assert torch.equal(vm.status, res.status) and torch.equal(vm.x_true, res.x_true)
    # on the card in f32 the row takes its per-lane rows on both kernels
    card = mpc.quadrotor_waypoint_problem(N=N, device="cpu")
    q, c = _lane_rows(B)
    card = dataclasses.replace(card, cost=dataclasses.replace(
        card.cost, q=tsv.batch_to_lanes(torch.as_tensor(q, dtype=torch.float32)),
        c=tsv.batch_to_lanes(torch.as_tensor(c, dtype=torch.float32))))
    assert tsv.kernel_refusal(card, mpc.quadrotor_tiled_options(), vmapped=False) is None
