"""The JAX package's own solve in float32 on the reference's test problems.

    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py [--tol-stationarity T]

Runs altro_tpu (the reference package, not the port) in float32 on the
CPU: the three double integrator oracles of
tests/test_solver_double_integrator.py and the 200-tick Scotty MPC of
tests/test_bicycle.py, with the tests' options (the stationarity
tolerance overridable), and prints one JSON line each: status,
iterations, the distance to the goal; for the MPC the statuses per tick
counted, the ticks whose iterations differ from data/scotty_mpc.npz and
the largest tracking-error difference from it. It shows what the
algorithm does in float32 on these problems, which is what chip_smoke.py's
float32 gates of the reference solves rest on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from altro_tpu.cones import Cone
from altro_tpu.io.scotty import load_scotty
from altro_tpu.models.bicycle import bicycle_continuous
from altro_tpu.models.double_integrator import double_integrator_dynamics
from altro_tpu.models.integrators import midpoint
from altro_tpu.mpc import set_initial_state, shift_trajectory, update_linear_costs
from altro_tpu.options import SolverOptions
from altro_tpu.problem import ConstraintSpec, DiagonalCost, Problem, lqr_cost_from_reference
from altro_tpu.solver import init_state, solve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = jnp.float32


def double_integrator(x0, kinds):
    N = 10
    cons = []
    for kind in kinds:
        if kind == "goal":
            cons.append(ConstraintSpec(fn=lambda x, u, k: x, cone=Cone.ZERO, dim=4,
                                       active=jnp.zeros(N + 1, bool).at[N].set(True)))
        elif kind == "bounds":
            cons.append(ConstraintSpec(fn=lambda x, u, k: jnp.concatenate([u - 1.0, -1.0 - u]),
                                       cone=Cone.NEGATIVE_ORTHANT, dim=4,
                                       active=jnp.ones(N + 1, bool).at[N].set(False)))
        else:
            cons.append(ConstraintSpec(
                fn=lambda x, u, k: jnp.concatenate([u, jnp.full((1,), 1.0, u.dtype)]),
                cone=Cone.SECOND_ORDER, dim=3, active=jnp.ones(N + 1, bool).at[N].set(False)))
    cost = DiagonalCost(Q=jnp.ones((N + 1, 4), F32), R=jnp.full((N + 1, 2), 1e-2, F32),
                        q=jnp.zeros((N + 1, 4), F32), r=jnp.zeros((N + 1, 2), F32),
                        c=jnp.zeros(N + 1, F32))
    return Problem(N=N, n=4, m=2, dynamics=double_integrator_dynamics(2), dynamics_jac=None,
                   constraints=tuple(cons), cost=cost, h=jnp.full(N, 0.5, F32),
                   x0=jnp.asarray(x0, F32))


def scotty_mpc(tol, ticks=200, N=30):
    ref = load_scotty()
    dm = 60 * np.pi / 180.0
    steering = ConstraintSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                              cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool))
    cost = lqr_cost_from_reference(np.full((N + 1, 4), 1e-2), np.full((N + 1, 2), 1e-3),
                                   ref.x[: N + 1], ref.u[: N + 1])
    cost = jax.tree.map(lambda a: jnp.asarray(a, F32), cost)
    h = float(np.float32(ref.tf / ref.N))
    problem = Problem(N=N, n=4, m=2, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
                      constraints=(steering,), cost=cost, h=jnp.full(N, h, F32),
                      x0=jnp.asarray(ref.x[0], F32))
    u0 = np.array([ref.u[0][0], 0.0])
    state = dataclasses.replace(init_state(problem), u=jnp.tile(jnp.asarray(u0, F32), (N, 1)),
                                x=jnp.asarray(ref.x[: N + 1], F32))
    opts = SolverOptions(iterations_max=80, use_backtracking_linesearch=True,
                         tol_stationarity=tol)
    run = jax.jit(solve, static_argnames=("opts",))
    dyn = midpoint(bicycle_continuous())
    Qd = np.full(4, 1e-2)
    c_u = 0.5 * float(u0 @ (np.full(2, 1e-3) * u0))
    x = jnp.asarray(ref.x[0], F32)
    iters, statuses, errs = [], [], []
    for t in range(ticks):
        state, stats = run(problem, state, opts)
        iters.append(int(stats.iterations))
        statuses.append(int(stats.status))
        x = dyn(x, state.u[0], problem.h[0], 0)
        errs.append(float(np.linalg.norm(np.asarray(x, np.float64) - ref.x[t + 1])))
        window = ref.x[t + 1: t + N + 2]
        c_new = 0.5 * np.sum(Qd * window * window, axis=1)
        c_new[:N] += c_u
        problem = update_linear_costs(problem, q=-(Qd * window), c=c_new)
        problem = set_initial_state(problem, x)
        state = shift_trajectory(state)
    art = np.load(os.path.join(ROOT, "data", "scotty_mpc.npz"))
    differ = [t for t, (a, b) in enumerate(zip(iters, art["solve_iters"])) if a != b]
    return {"problem": "scotty_mpc", "ticks": ticks, "tol_stationarity": tol,
            "statuses": {str(s): statuses.count(s) for s in sorted(set(statuses))},
            "ticks_iterations_differ": len(differ),
            "max_abs_err_vs_artifact": float(np.abs(np.array(errs) - art["tracking_error"]).max()),
            "mean_tracking_error": float(np.mean(errs))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tol-stationarity", type=float, default=1e-4)
    tol = ap.parse_args().tol_stationarity
    for case, x0, kinds, kw in (
            ("goal", [1.0, 2.0, 0.0, 0.0], ("goal",), dict(penalty_scaling=100.0)),
            ("control_bounds", [2.0, 2.0, 0.0, 0.0], ("goal", "bounds"),
             dict(penalty_initial=100.0, penalty_scaling=100.0)),
            ("soc_bound", [2.0, 2.0, 0.0, 0.0], ("goal", "soc"),
             dict(penalty_initial=1.0, penalty_scaling=100.0))):
        prob = double_integrator(x0, kinds)
        st, stats = solve(prob, init_state(prob), SolverOptions(tol_stationarity=tol, **kw))
        print(json.dumps({"problem": f"double_integrator/{case}", "tol_stationarity": tol,
                          "status": int(stats.status), "iterations": int(stats.iterations),
                          "dist": float(jnp.linalg.norm(st.x[-1]))}), flush=True)
    print(json.dumps(scotty_mpc(tol)), flush=True)


if __name__ == "__main__":
    main()
