"""Real-time-iteration mode of the port's batched solve against altro_tpu.

Counterpart: the `rti_mode` branch of altro_tpu/tile_solver.py::solve_tiled
(one full step per tick through the rollout with W=1), checked like
tests/test_tile_solver.py::test_parity_rti_mode: the port's closed loop
against `jax.vmap(solve)` with the same options, B=8, N=12, 3 ticks,
f64. Per lane and tick: status and iterations equal; plant states,
trajectories and tracking error to 1e-8.
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
from altro_tpu.solver import solve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402

N, B, T, n, m = 12, 8, 3, 4, 2
DM = 60 * np.pi / 180.0


def test_rti_closed_loop_matches_vmapped_solve():
    ref = jload()
    h = float(np.float32(ref.tf / ref.N))
    t_opts, t_rescue = mpc.bench_options(rti=True)
    assert t_rescue is None and t_opts.rti_mode and tsv.supported_options(t_opts)
    j_opts = JOpts(**{f.name: getattr(t_opts, f.name) for f in dataclasses.fields(t_opts)})
    dyn = jmidpoint(jbicycle())
    jprob = JProblem(
        N=N, n=n, m=m, dynamics=dyn, dynamics_jac=None,
        constraints=(JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                           cone=JCone.NEGATIVE_ORTHANT, dim=2,
                           active=jnp.ones(N + 1, bool), diag_hessian=True, affine=True),),
        cost=jlqr(jnp.asarray(np.full((N + 1, n), 1e-2)),
                  jnp.asarray(np.full((N + 1, m), 1e-3)),
                  jnp.asarray(ref.x[: N + 1]), jnp.asarray(ref.u[: N + 1])),
        h=jnp.full(N, h), x0=jnp.asarray(ref.x[0]))

    @jax.jit
    def tick(x_true, st, q, c):
        prob = dataclasses.replace(jprob, cost=dataclasses.replace(jprob.cost, q=q, c=c))
        st, stats = jax.vmap(
            lambda x0, s: solve(dataclasses.replace(prob, x0=x0), s, j_opts))(x_true, st)
        x_true = jax.vmap(lambda x, u: dyn(x, u, jnp.asarray(h), 0))(x_true, st.u[:, 0])
        return x_true, jax.vmap(shift_trajectory)(st), stats

    rng = np.random.default_rng(2)
    # near the path: one full step per tick does not converge far from it,
    # and there an unconverged lane amplifies f64 roundoff tick by tick
    x_true0 = ref.x[0][None] + 0.05 * rng.standard_normal((B, n))
    xw = np.stack([ref.x[t: t + N + 1] for t in range(T + 1)])
    Qd, Rd = np.full(n, 1e-2), np.full(m, 1e-3)
    qs, cs = -(Qd * xw), 0.5 * np.sum(Qd * xw * xw, axis=2)
    cs[:, :N] += 0.5 * float(ref.u[0] @ (Rd * ref.u[0]))
    st = jbatch_init(jprob, B)
    st = dataclasses.replace(
        st, u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0]), (B, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1]), (B, 1, 1)))
    xt = jnp.asarray(x_true0)
    iters, status, errs = [], [], []
    for t in range(T):
        xt, st, stats = tick(xt, st, jnp.asarray(qs[t]), jnp.asarray(cs[t]))
        iters.append(np.asarray(stats.iterations))
        status.append(np.asarray(stats.status))
        errs.append(np.linalg.norm(np.asarray(xt) - xw[t + 1, 0][None], axis=1))

    tref = load_scotty()
    prob = mpc.scotty_problem(tref, N=N, dtype=torch.float64, device="cpu")
    res = mpc.run_closed_loop(prob, tref, torch.as_tensor(x_true0), ticks=T, opts=t_opts)
    np.testing.assert_array_equal(res.iterations.numpy(), np.stack(iters))
    np.testing.assert_array_equal(res.status.numpy(), np.stack(status))
    np.testing.assert_allclose(res.tracking_error.numpy(), np.stack(errs), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.x_true.numpy(), np.asarray(xt), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(st.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(st.u), rtol=0, atol=1e-8)
    assert res.rescue_ticks == 0
