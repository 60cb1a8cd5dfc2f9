"""The port's closed loop (solve_tiled plus rescue) against altro_tpu's
`rescue.vmap_solve_with_rescue` (jax.vmap(solve) plus the same rescue).

B=8 lanes, N=12, 3 closed-loop ticks in f64 with the bench's options
(parallel phase-split x-only Armijo-only grid search, W=8, one block,
penalty warm start, best-decrease fallback) and the bench's rescue tier.
The primary budget is cut to 2 iterations so that lanes fail and the
rescue runs. Per lane and tick: iterations and status equal; x, u and
tracking error to 1e-8. This is the tests/test_tile_solver.py contract
held against the port.
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
from altro_tpu.mpc import shift_trajectory  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.rescue import vmap_solve_with_rescue  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402

N, B, T, n, m = 12, 8, 3, 4, 2
DM = 60 * np.pi / 180.0

REF = jload()
H = float(np.float32(REF.tf / REF.N))
T_OPTS, T_RESCUE = mpc.bench_options(iterations_max=2)


def _jax_opts(o):
    return JOpts(**{f.name: getattr(o, f.name) for f in dataclasses.fields(o)})


J_OPTS, J_RESCUE = _jax_opts(T_OPTS), _jax_opts(T_RESCUE)
DYN = jmidpoint(jbicycle())
J_PROBLEM = JProblem(
    N=N, n=n, m=m, dynamics=DYN, dynamics_jac=None,
    constraints=(JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                       cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                       diag_hessian=True, affine=True),),
    cost=jlqr(jnp.asarray(np.full((N + 1, n), 1e-2)), jnp.asarray(np.full((N + 1, m), 1e-3)),
              jnp.asarray(REF.x[: N + 1]), jnp.asarray(REF.u[: N + 1])),
    h=jnp.full(N, H), x0=jnp.asarray(REF.x[0]))


@jax.jit
def _jax_tick(x_true, st, q, c):
    prob = dataclasses.replace(J_PROBLEM, cost=dataclasses.replace(J_PROBLEM.cost, q=q, c=c))
    st, stats = vmap_solve_with_rescue(prob, x_true, st, J_OPTS, J_RESCUE)
    x_true = jax.vmap(lambda x, u: DYN(x, u, jnp.asarray(H), 0))(x_true, st.u[:, 0])
    return x_true, jax.vmap(shift_trajectory)(st), stats


def _jax_closed_loop(x_true0):
    xw = np.stack([REF.x[t: t + N + 1] for t in range(T + 1)])
    Qd, Rd = np.full(n, 1e-2), np.full(m, 1e-3)
    qs = -(Qd * xw)
    cs = 0.5 * np.sum(Qd * xw * xw, axis=2)
    cs[:, :N] += 0.5 * float(REF.u[0] @ (Rd * REF.u[0]))
    st = jbatch_init(J_PROBLEM, B)
    st = dataclasses.replace(
        st, u=jnp.tile(jnp.asarray([REF.u[0][0], 0.0]), (B, N, 1)),
        x=jnp.tile(jnp.asarray(REF.x[: N + 1]), (B, 1, 1)))
    xt = jnp.asarray(x_true0)
    iters, status, errs = [], [], []
    for t in range(T):
        xt, st, stats = _jax_tick(xt, st, jnp.asarray(qs[t]), jnp.asarray(cs[t]))
        iters.append(np.asarray(stats.iterations))
        status.append(np.asarray(stats.status))
        errs.append(np.linalg.norm(np.asarray(xt) - xw[t + 1, 0][None], axis=1))
    return np.stack(iters), np.stack(status), np.stack(errs), np.asarray(xt), st


def _port_closed_loop(x_true0):
    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=N, dtype=torch.float64, device="cpu")
    return mpc.run_closed_loop(prob, ref, torch.as_tensor(x_true0), ticks=T,
                               opts=T_OPTS, opts_rescue=T_RESCUE)


def _x_true0(steer_offset):
    rng = np.random.default_rng(0)
    x = REF.x[0][None] + 0.3 * rng.standard_normal((B, n))
    x[:, 3] += steer_offset * np.sign(rng.standard_normal(B))
    return x


@pytest.mark.parametrize("steer_offset, tol", [(0.9, 1e-8), (1.2, 1e-6)])
def test_closed_loop_matches_vmapped_solve_with_rescue(steer_offset, tol):
    """steer_offset 0.9 starts the lanes near the steering bound: the
    primary tier fails on some lanes and the rescue runs. 1.2 starts them
    past it: penalties escalate to 1e8 and lanes end in
    MERIT_FUN_GRADIENT_TOO_SMALL / MAX_ITERATIONS; at that conditioning
    f64 roundoff grows to ~1e-7, so states are held to 1e-6 there."""
    x0 = _x_true0(steer_offset)
    j_iters, j_status, j_errs, j_x, j_st = _jax_closed_loop(x0)
    res = _port_closed_loop(x0)
    np.testing.assert_array_equal(res.iterations.numpy(), j_iters)
    np.testing.assert_array_equal(res.status.numpy(), j_status)
    assert res.rescue_ticks > 0
    np.testing.assert_allclose(res.tracking_error.numpy(), j_errs, rtol=0, atol=tol)
    np.testing.assert_allclose(res.x_true.numpy(), j_x, rtol=0, atol=tol)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(j_st.x), rtol=0, atol=tol)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(j_st.u), rtol=0, atol=tol)
    np.testing.assert_allclose(res.state.rho.numpy(), np.asarray(j_st.rho), rtol=1e-12)
