"""The single-lane rows of scripts/bench_all.py against altro_tpu, in f64.

`double_integrator_goal_N100` (:100-118), `pendulum_swingup_bounded`
(:120-141) and `bicycle_scotty_window_N30` (:143-209 at N=30), each
built as the row builds it for JAX's `solve` and through the port's
entry points (`mpc.run_double_integrator_goal`, `run_pendulum_bounded`,
`run_bicycle_window` on `reference_problems`' problems and
`mpc.scotty_reference_problem`) with the rows' options (`f32opts`:
30 iterations, tolerances 1e-3, the strong-Wolfe search; the double
integrator's penalty scaling 100; the bicycle's sequential backtracking
with cubic first), on CPU tensors in f64: status, iterations and
ls_iterations equal, x and u to 1e-8, the objective to 1e-8 relative.
On the card in f32 the backward is csrc/riccati_latency.cu at (4, 2) and
(2, 1), dense with lux.
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
from altro_tpu.models.double_integrator import double_integrator_dynamics as jdi  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.pendulum import pendulum_continuous as jpendulum  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402


def _jopts(o):
    return JOpts(**{f.name: getattr(o, f.name) for f in dataclasses.fields(o)})


def _jax_double_integrator():
    N = 100
    goal = JSpec(fn=lambda x, u, k: x - jnp.zeros(4), cone=JCone.ZERO, dim=4,
                 active=jnp.zeros(N + 1, bool).at[N].set(True), label="goal")
    prob = JProblem(N=N, n=4, m=2, dynamics=jdi(2), dynamics_jac=None, constraints=(goal,),
                    cost=jlqr(jnp.ones((N + 1, 4)), jnp.full((N + 1, 2), 1e-2),
                              jnp.zeros((N + 1, 4)), jnp.zeros((N + 1, 2))),
                    h=jnp.full(N, 0.05), x0=jnp.asarray([1.0, 2.0, 0.0, 0.0]))
    return prob, jinit(prob)


def _jax_pendulum():
    N = 50
    Qd = np.concatenate([np.full((N, 2), 1e-2), np.full((1, 2), 1.0)])
    torque = JSpec(fn=lambda x, u, k: jnp.concatenate([u - 8.0, -8.0 - u]),
                   cone=JCone.NEGATIVE_ORTHANT, dim=2,
                   active=jnp.ones(N + 1, bool).at[N].set(False), label="torque bound")
    prob = JProblem(N=N, n=2, m=1, dynamics=jmidpoint(jpendulum()), dynamics_jac=None,
                    constraints=(torque,),
                    cost=jlqr(jnp.asarray(Qd), jnp.full((N + 1, 1), 1e-3),
                              jnp.asarray(np.tile([np.pi, 0.0], (N + 1, 1))),
                              jnp.zeros((N + 1, 1))),
                    h=jnp.full(N, np.float32(3.0 / N), jnp.float64), x0=jnp.zeros(2))
    st = jinit(prob)
    return prob, dataclasses.replace(st, u=jnp.full_like(st.u, 0.1))


def _jax_bicycle():
    ref = jload()
    N = 30
    dm = np.deg2rad(60.0)
    steering = JSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                     cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                     label="steering")
    prob = JProblem(N=N, n=4, m=2, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
                    constraints=(steering,),
                    cost=jlqr(jnp.full((N + 1, 4), 1e-2), jnp.full((N + 1, 2), 1e-3),
                              jnp.asarray(ref.x[: N + 1]), jnp.asarray(ref.u[: N + 1])),
                    h=jnp.full(N, float(np.float32(ref.tf / ref.N))),
                    x0=jnp.asarray(ref.x[0]))
    st = dataclasses.replace(jinit(prob), u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0]), (N, 1)),
                             x=jnp.asarray(ref.x[: N + 1]))
    return prob, st


def _port(row):
    kw = dict(dtype=torch.float64, device="cpu")
    if row == "double_integrator_goal_N100":
        return mpc.run_double_integrator_goal(*rp.double_integrator_goal_problem(**kw))
    if row == "pendulum_swingup_bounded":
        return mpc.run_pendulum_bounded(*rp.pendulum_bounded_problem(**kw))
    return mpc.run_bicycle_window(*mpc.scotty_reference_problem(load_scotty(), N=30, **kw))


ROWS = {"double_integrator_goal_N100": (_jax_double_integrator, mpc.double_integrator_goal_options),
        "pendulum_swingup_bounded": (_jax_pendulum, mpc.baseline_f32_options),
        "bicycle_scotty_window_N30": (_jax_bicycle, mpc.bicycle_window_options)}


@pytest.mark.parametrize("row", list(ROWS))
def test_row_matches_jax_solve_f64(row):
    jax_problem, options = ROWS[row]
    jprob, jst = jax_problem()
    jopts = _jopts(options())
    j_state, j_stats = jax.jit(lambda s: jsolve(jprob, s, jopts))(jst)
    before = rl.LAUNCHES
    res = _port(row)
    assert rl.LAUNCHES == before  # CPU: the plain backward only
    for k in ("status", "iterations", "ls_iterations"):
        assert int(getattr(res.stats, k)) == int(getattr(j_stats, k)), k
    assert int(res.stats.status) == 0
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(res.stats.objective_value),
                               float(j_stats.objective_value), rtol=1e-8)
    np.testing.assert_allclose(float(res.stats.primal_feasibility),
                               float(j_stats.primal_feasibility), rtol=1e-6, atol=1e-12)
