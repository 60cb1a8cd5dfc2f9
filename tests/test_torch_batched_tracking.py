"""examples/batched_mpc.py's closed loop on the port against the JAX package's.

`mpc.run_batched_tracking` (the port's `batched_tracking_solver` per tick,
per-lane q and c from the sliding window, u_0 through the plant, the
shift) against the example's loop written with altro_tpu's
`batched_tracking_solver` on the same problem, options and starts (the
port's numpy draw), in f64: B=8 lanes, 5 ticks. Per tick: statuses and
iterations exact; plant states, x and u to 1e-9. The port runs the dense
backward's plain version (`pallas_backward=True`, its CPU path) and the
plain recursion; the example's options leave `pallas_backward` off, and
on the CPU both take JAX's steps (dense expansions either way).
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
from altro_tpu.models import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models import midpoint as jmidpoint  # noqa: E402
from altro_tpu.mpc import shift_trajectory  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.parallel.batch import batched_tracking_solver as jtracking  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.ops import riccati_dense as rd  # noqa: E402

B, T, N, n, m = 8, 5, 30, 4, 2


@pytest.fixture(scope="module")
def jax_run():
    """examples/batched_mpc.py:36-85 in f64 from the port's starts."""
    ref = jload()
    h = float(np.float32(ref.tf / ref.N))
    Qd, Rd = np.full(n, 1e-2), np.full(m, 1e-3)
    cost = jlqr(jnp.asarray(np.tile(Qd, (N + 1, 1))), jnp.asarray(np.tile(Rd, (N + 1, 1))),
                jnp.asarray(ref.x[: N + 1]), jnp.asarray(ref.u[: N + 1]))
    dm = np.deg2rad(60.0)
    steering = JSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                     cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                     label="steering")
    dyn = jmidpoint(jbicycle())
    problem = JProblem(N=N, n=n, m=m, dynamics=dyn, dynamics_jac=None, constraints=(steering,),
                       cost=cost, h=jnp.full(N, h), x0=jnp.asarray(ref.x[0]))
    opts = JOpts(iterations_max=10, use_backtracking_linesearch=True, tol_stationarity=1e-3,
                 tol_primal_feasibility=1e-3, throw_errors=False)
    runner = jtracking(problem, opts)
    x_true = jnp.asarray(mpc.batched_tracking_initial_states(
        B, dtype=torch.float64, device="cpu").numpy())
    states = dataclasses.replace(
        jbatch_init(problem, B), u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0]), (B, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1]), (B, 1, 1)))
    shift = jax.jit(jax.vmap(shift_trajectory))
    step = jax.jit(jax.vmap(lambda x, u: dyn(x, u, h, 0)))
    out = []
    for t in range(T):
        window = jnp.asarray(ref.x[t: t + N + 1])
        q = jnp.broadcast_to(-(jnp.asarray(Qd) * window), (B, N + 1, n))
        c = jnp.broadcast_to(0.5 * jnp.sum(jnp.asarray(Qd) * window * window, 1), (B, N + 1))
        u0, states, stats = runner(x_true, q, c, states)
        x_true = step(x_true, u0)
        states = shift(states)
        out.append((np.asarray(x_true), jax.tree.map(np.asarray, states),
                    jax.tree.map(np.asarray, stats)))
    return out


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas_backward", "plain_backward"])
def test_run_batched_tracking_matches_jax_loop(jax_run, pallas):
    prob = mpc.batched_tracking_problem(dtype=torch.float64, device="cpu")
    x0 = mpc.batched_tracking_initial_states(B, dtype=torch.float64, device="cpu")
    opts = mpc.batched_tracking_options(pallas_backward=pallas)
    before = rd.LAUNCHES
    res = mpc.run_batched_tracking(prob, x0, ticks=T, opts=opts)
    assert rd.LAUNCHES == before  # CPU: the plain twin
    j_xt, j_st, _ = jax_run[-1]
    for t, (_, _, j_stats) in enumerate(jax_run):
        np.testing.assert_array_equal(res.status[t].numpy(), j_stats.status, err_msg=f"tick {t}")
        np.testing.assert_array_equal(res.iterations[t].numpy(), j_stats.iterations,
                                      err_msg=f"tick {t}")
    np.testing.assert_allclose(res.x_true.numpy(), j_xt, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.state.x.numpy(), j_st.x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.state.u.numpy(), j_st.u, rtol=0, atol=1e-9)
    row = res.metrics()
    assert row["success_rate"] > 0.5 and row["trials_per_solve_mean"] >= 1
    assert row["syncs_per_tick"] > row["passes_per_tick"] > 0
    assert np.isfinite(row["mean_final_tracking_error"])


def test_starts_are_the_documented_draw():
    ref = load_scotty()
    x0 = mpc.batched_tracking_initial_states(3, dtype=torch.float64, device="cpu")
    want = ref.x[0][None] + 0.05 * np.random.default_rng(0).standard_normal((3, n))
    np.testing.assert_array_equal(x0.numpy(), want)
