"""The `tracking_tiled_mpc` row (`mpc.run_tracking_tiled`) against the JAX
package in float64 on the CPU: 8 bicycle lanes, each tracking the Scotty
path from its own knot, q and c per lane sliding with each lane's window,
the bench's options and rescue through `solve_tiled_with_rescue`, 3
ticks. JAX's side is jax.vmap(solve) over the per-lane problems with the
rescue's second tier on the failed lanes (the per-lane iterates its
`solve_tiled` with `prob_axes` on q and c promises; its tiled kernels
take float32 only). Statuses and iterations equal lane for lane and tick
for tick, the plant states within 1e-9."""

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
from altro_tpu.mpc import shift_trajectory as jshift  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402

N, B, TICKS = 30, 8, 3
DM = 60 * np.pi / 180.0
F64 = jnp.float64


def _jopts(o):
    return JOpts(**{f.name: getattr(o, f.name) for f in dataclasses.fields(o)})


def _jax_loop(starts, x0, xw, qs, cs):
    ref = jload()
    prob = JProblem(
        N=N, n=4, m=2, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
        constraints=(JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                           cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                           diag_hessian=True, affine=True),),
        cost=jlqr(jnp.full((N + 1, 4), 1e-2, F64), jnp.full((N + 1, 2), 1e-3, F64),
                  jnp.asarray(ref.x[: N + 1], F64), jnp.asarray(ref.u[: N + 1], F64)),
        h=jnp.full(N, float(np.float32(ref.tf / ref.N)), F64), x0=jnp.asarray(ref.x[0], F64))
    opts, opts_r = (_jopts(o) for o in mpc.bench_options())

    @jax.jit
    def tick(x, st, q, c):
        def solve_all(s, o):
            return jax.vmap(lambda x0_, s_, q_, c_: jsolve(dataclasses.replace(
                prob, x0=x0_, cost=dataclasses.replace(prob.cost, q=q_, c=c_)), s_, o))(
                x, s, q, c)

        st1, stats1 = solve_all(st, opts)
        failed = stats1.status != 0
        st2, stats2 = solve_all(st1, opts_r)
        st = jax.tree.map(
            lambda a, b: jnp.where(failed.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), st2, st1)
        status = jnp.where(failed, stats2.status, stats1.status)
        iters = stats1.iterations + jnp.where(failed, stats2.iterations, 0)
        x = jax.vmap(lambda xi, ui: prob.dynamics(xi, ui, prob.h[0], 0))(x, st.u[:, 0])
        return x, jax.vmap(jshift)(st), status, iters

    u0 = np.zeros((B, N, 2))
    u0[:, :, 0] = np.asarray(ref.u)[starts, 0][:, None]
    st = dataclasses.replace(jbatch_init(prob, B), u=jnp.asarray(u0), x=jnp.asarray(xw[0]))
    x = jnp.asarray(x0)
    xs, statuses, iters = [], [], []
    for t in range(TICKS):
        x, st, status, it = tick(x, st, jnp.asarray(qs[t]), jnp.asarray(cs[t]))
        xs.append(np.asarray(x))
        statuses.append(np.asarray(status))
        iters.append(np.asarray(it))
    return np.stack(xs), np.stack(statuses), np.stack(iters)


def test_tracking_tiled_first_ticks_match_jax_f64():
    ref = load_scotty()
    starts = mpc.tracking_tiled_starts(B)
    assert starts.min() >= 0 and starts.max() <= mpc.TRACKING_TILED_LAST_START
    x0 = mpc.tracking_tiled_initial_states(ref, starts, dtype=torch.float64, device="cpu")
    xw, qs, cs = mpc.tracking_tiled_windows(ref, starts, N, TICKS, dtype=torch.float64,
                                            device="cpu")
    bm = lambda t: np.moveaxis(t.numpy(), -1, 1)  # noqa: E731  [T+1, B, ...]
    j_x, j_status, j_iters = _jax_loop(starts, x0.numpy(), bm(xw), bm(qs), bm(cs))

    prob = mpc.scotty_problem(ref, N=N, dtype=torch.float64, device="cpu")
    res = mpc.run_tracking_tiled(prob, ref, starts, x0, ticks=TICKS)
    np.testing.assert_array_equal(res.status.numpy(), j_status)
    np.testing.assert_array_equal(res.iterations.numpy(), j_iters)
    assert res.rescue_ticks >= 1  # the rescue's tier runs in these ticks
    np.testing.assert_allclose(res.x_true.numpy(), j_x[-1], rtol=0, atol=1e-9)
    err = np.linalg.norm(j_x - np.moveaxis(xw.numpy()[1:, 0], -1, 1), axis=2)
    np.testing.assert_allclose(res.tracking_error.numpy(), err, rtol=0, atol=1e-9)
    m = mpc.closed_loop_metrics(res)
    assert m["success_rate"] == float(np.mean(j_status == 0))
