"""The obstacle row (`mpc.run_obstacle_mpc`, scripts/bench_all.py:566-730)
against `jax.vmap(solve)` in float64 on the CPU.

The row's problem and options (three constraint groups, the nonlinear
obstacle row with its dense AL Hessian; the phase-split Armijo-only grid
in three blocks, penalty decay 0.5, uncapped line-search recovery, the
best-decrease fallback, relative stationarity), B=8 lanes from the port's
starts, N=30, 5 closed-loop ticks: once with the disc where the row puts
it and once with it moved onto the first knots of the path (t_obs = -10,
the centre at ref.x[5]), so that every resolve swerves; the second under
the Gauss-Newton AL Hessian (the exact one:
test_torch_obstacle_vmapped_exact.py; the row from a later tick:
test_torch_obstacle_vmapped_start.py). Statuses, iterations and
ls_iterations equal lane for lane and tick for tick; plant states and the
solver's x and u to 1e-9.
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
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402

N, B, T, R_OBS = 30, 8, 5, 0.75
REF = jload()
DM = float(np.deg2rad(60.0))


def _jax_row(t_obs, opts, start=0):
    c_obs = [float(v) for v in REF.x[t_obs + N // 2][:2]]

    def obs(x, u, k):
        dx, dy = x[0] - c_obs[0], x[1] - c_obs[1]
        return jnp.stack([R_OBS * R_OBS - dx * dx - dy * dy])

    ones = jnp.ones(N + 1, bool)
    cons = (JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                  cone=JCone.NEGATIVE_ORTHANT, dim=2, active=ones),
            JSpec(fn=lambda x, u, k: jnp.stack([u[0] - 8.0, -u[0], u[1] - 1.5, -1.5 - u[1]]),
                  cone=JCone.NEGATIVE_ORTHANT, dim=4, active=ones.at[N].set(False)),
            JSpec(fn=obs, cone=JCone.NEGATIVE_ORTHANT, dim=1, active=ones))
    h = float(np.float32(REF.tf / REF.N))
    prob = JProblem(N=N, n=4, m=2, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
                    constraints=cons,
                    cost=jlqr(jnp.full((N + 1, 4), 1e-2), jnp.full((N + 1, 2), 1e-3),
                              jnp.asarray(REF.x[: N + 1]), jnp.asarray(REF.u[: N + 1])),
                    h=jnp.full(N, h), x0=jnp.asarray(REF.x[0]))
    j_opts = JOpts(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})
    Qd = np.full(4, 1e-2)
    xw = np.stack([REF.x[t: t + N + 1] for t in range(start, start + T + 1)])
    qs, cs = -(Qd * xw), 0.5 * np.sum(Qd * xw * xw, axis=2)
    cs[:, :N] += 0.5 * float(REF.u[0] @ (np.full(2, 1e-3) * REF.u[0]))
    dyn = prob.dynamics

    @jax.jit
    def tick(x, st, q, c):
        p = dataclasses.replace(prob, cost=dataclasses.replace(prob.cost, q=q, c=c))
        st, stats = jax.vmap(lambda x0, s: solve(dataclasses.replace(p, x0=x0), s, j_opts))(x, st)
        x = jax.vmap(lambda xi, ui: dyn(xi, ui, h, 0))(x, st.u[:, 0])
        return x, jax.vmap(shift_trajectory)(st), stats, st

    st = dataclasses.replace(jbatch_init(prob, B),
                             u=jnp.tile(jnp.asarray([REF.u[0][0], 0.0]), (B, N, 1)),
                             x=jnp.tile(jnp.asarray(REF.x[start: start + N + 1]), (B, 1, 1)))
    x = jnp.asarray(REF.x[start][None]
                    + 0.02 * np.random.default_rng(7).standard_normal((B, 4)))
    out = []
    for t in range(T):
        x, st, stats, solved = tick(x, st, jnp.asarray(qs[t]), jnp.asarray(cs[t]))
        out.append((np.asarray(stats.status), np.asarray(stats.iterations),
                    np.asarray(stats.ls_iterations), np.asarray(x), np.asarray(solved.x),
                    np.asarray(solved.u)))
    return out


def _port_row(t_obs, opts, start=0):
    ref = load_scotty()
    prob = mpc.obstacle_problem(ref, N, t_obs=t_obs, r_obs=R_OBS, dtype=torch.float64,
                                device="cpu")
    x0 = mpc.obstacle_initial_states(ref, B, start=start, dtype=torch.float64, device="cpu")
    out = []

    def solve_lanes_spy(p, st):
        from altro_tpu_torch.parallel.batch import solve_lanes

        st, stats = solve_lanes(p, st, opts)
        out.append([stats.status.numpy(), stats.iterations.numpy(), stats.ls_iterations.numpy(),
                    None, st.x.permute(2, 0, 1).numpy().copy(),
                    st.u.permute(2, 0, 1).numpy().copy()])
        return st, stats

    xs = []
    _, qs, cs = mpc._windows(ref, N, T, prob, start)
    state0 = dataclasses.replace(
        mpc.batch_init_state(prob, B),
        u=torch.tensor([ref.u[0][0], 0.0], dtype=torch.float64).expand(B, N, 2).contiguous(),
        x=torch.as_tensor(ref.x[start: start + N + 1]).expand(B, N + 1, 4).contiguous())
    mpc._lanes_closed_loop(prob, x0, T, state0, solve_lanes_spy,
                           lambda t: dataclasses.replace(prob.cost, q=qs[t], c=cs[t]),
                           observe=lambda t, x: xs.append(x.T.numpy().copy()))
    for rec, x in zip(out, xs):
        rec[3] = x
    # the entry point runs the same loop
    res = mpc.run_obstacle_mpc(prob, ref, x0, ticks=T, start=start, opts=opts, r_obs=R_OBS,
                               t_obs=t_obs)
    np.testing.assert_array_equal(res.status.numpy(), np.stack([o[0] for o in out]))
    np.testing.assert_array_equal(res.x_true.numpy(), xs[-1])
    return out


def check_row(t_obs, exact, start=0):
    opts = mpc.obstacle_options(pallas_backward=False, exact=exact)
    want = _jax_row(t_obs, opts, start)
    got = _port_row(t_obs, opts, start)
    swerved = 0
    for t, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("status", "iterations", "ls_iterations"), g[:3], w[:3]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} at tick {t}")
        for name, a, b in zip(("plant", "x", "u"), g[3:], w[3:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=f"{name} at tick {t}")
        swerved += int(np.sum(w[1] > 1))
    if t_obs < 0 or start > 0:  # the disc is in play: resolves take more than one iteration
        assert swerved > 0


@pytest.mark.parametrize("t_obs", [25, -10], ids=["row", "disc_ahead"])
def test_obstacle_row_matches_jax_vmap_solve(t_obs):
    check_row(t_obs, exact=False)
