"""The JAX package's own solve in float32 on the reference's test problems.

    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py [--tol-stationarity T]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --quadrotor [--lanes B]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --pendulum --rocket [--lanes B]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --batched-tracking [--lanes B]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --single-lane-rows
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --facade
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --quadrotor-vmapped [--ticks T] [--lanes B]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --quadrotor-latency [--ticks T]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --obstacle [--ticks T] [--lanes B]
        [--start S] [--hessian both|gauss_newton|exact]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --obstacle-loop
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --obstacle-loop-draws K
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --tracking-tiled [--lanes B] [--ticks T]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --single-lane-options
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --learned-mpc [--draws K]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --implicit-grad [--lanes B] [--iterations I]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --vmap-rescue [--lanes B]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --aot [--ticks T]
    JAX_PLATFORMS=cpu python tools/jax_f32_reference.py --cartpole-depths 40,50,60,100

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

With --quadrotor it runs instead the two quadrotor rows of
scripts/bench_all.py that reach the TPU kernels, 100 ticks each, from
the starts the port draws (torch.Generator, seed 1, 0.05 N(0, 1)): the
tiled waypoint MPC (`quadrotor_waypoint_mpc_B1024_tiled`: `solve_tiled`
on B lanes, its Pallas backward in interpret mode, the scan grid) and
the single-lane latency row (`quadrotor_latency_B1`: `solve` on lane 0,
the scan paths), and prints each row's success rate, final waypoint
distance and mean iterations: what chip_smoke.py's gates of the port's
two rows rest on. The tiled row takes about 20 minutes at B=1024 on
one CPU.

With --pendulum and --rocket it runs the batched rows of the other two
models through the vmapped `solve` (`pallas_backward=False`: the scan
backward and the scan grid, the per-lane iterates that JAX's
`solve_tiled` promises), from the starts the port draws (numpy
default_rng; the pendulum 0.05 N(0, 1) with seed 3, the rocket its x0
plus 2 N(0, 1) on the position and 0.5 N(0, 1) on the velocity with
seed 0): the pendulum swing-up MPC (`pendulum_swingup_mpc_B1024`,
bench_all.py:845-980, 80 ticks; swing-up rate, success rate, mean
iterations, mean distance from upright) and the rocket landing
(`rocket_soc_tiled_B1024`, bench_all.py:732-843, one solve; success
rate, mean iterations, mean touchdown distance): what chip_smoke.py's
gates of the port's two rows rest on.

With --batched-tracking it runs examples/batched_mpc.py's loop through
altro_tpu's `batched_tracking_solver` in f32 (the example's problem,
options and tick; B lanes from the port's starts, ref.x[0] + 0.05 N(0, 1)
with numpy seed 0): 20 ticks under the example's sequential backtracking,
5 ticks each under the strong-Wolfe search and the non-split grid, and
prints each run's success rate, mean iterations and mean final tracking
error; then each search's first 5 ticks in f32 against the same ticks in
f64 (the largest plant-state difference, status agreement): what
chip_smoke.py's `batched_tracking` gates rest on.

With --single-lane-rows it runs the single-lane solves of the port's
`single_lane_models` phase in float32, each one `solve` from its cold
start with its own options: the rocket landing of
examples/rocket_landing.py (N=60, tolerance 1e-3; status, iterations,
|r_N|, |v_N|, the largest thrust-ball and pointing ratios, the largest
cone excess), the cart-pole swing-up of tests/test_models_extra.py (300
iterations; theta_N and x_N; and its first 30 iterations in float32
against the same in float64, the largest state difference) and the
single-lane rows of scripts/bench_all.py with its `f32opts`
(`double_integrator_goal_N100`, `pendulum_swingup_bounded`,
`bicycle_scotty_window_N30`; status, iterations, objective, feasibility,
x_N), each beside the same solve in float64: what chip_smoke.py's gates
of those solves rest on.

With --quadrotor-vmapped it runs the vmapped quadrotor waypoint row
(`quadrotor_waypoint_mpc_B1024`, bench_all.py:322-512) through
jax.vmap(solve) with the row's options and the scan backward, on the
first B of the port's starts for T ticks (`--ticks`; `--ticks` also sets
the batched tracking's sequential-backtracking ticks): success rate,
final waypoint distance and mean iterations at a cut depth, what
chip_smoke.py's `quadrotor_mpc` gates rest on. Each lane's iterates do
not depend on the others, so B=256 gives the first 256 lanes of B=1024.
With --quadrotor-latency it runs the single-lane latency row of --quadrotor
alone, T ticks (`--ticks`, default 100).

With --facade it runs altro_tpu's `ALTROSolver` in float32 and float64:
examples/pendulum_swingup.py's solve (status, iterations, objective,
x_N); tests/test_api.py:250-293's pendulum configuration with and without
the block step `midpoint_tile(pendulum_tile())` (status, iterations, u;
the largest u difference between JAX's two float32 runs and between each
and its float64 run); test_api.py:54's double integrator with the goal a
terminal cost, with and without the block step `double_integrator_tile(2)`
(status, iterations, u_0, the largest u differences); and test_api.py's
double-integrator facade cases in float32 at the bench's stationarity
tolerance 1e-3 (the goal, the
quadratic cost with a cross term and the generic cost: status,
iterations, x_N and its distance from the float64 run's): what
chip_smoke.py's `facade` gates rest on.

With --obstacle it runs the obstacle-constrained bicycle MPC of
scripts/bench_all.py (`bicycle_obstacle_mpc_B1024`, :566-730) through
jax.vmap(solve) in float32 with the row's options and the scan backward,
from the port's starts (mpc.obstacle_initial_states: ref.x[0] +
0.02 N(0, 1), numpy seed 7): B lanes for T ticks (default 1024 and 60)
under the Gauss-Newton AL Hessian, the first 256 of them under the exact
one (`exact_al_hessian`), each row's success rate, least clearance, mean
tracking error and mean iterations; `--start S` runs the row's ticks S ..
S + T - 1 instead (the plant at ref.x[S] plus the same noise, warm-started
on that window), `--hessian` one Hessian; with both, the first 10 ticks of 64 lanes
in float32 against the same in float64 (status agreement, the largest
plant-state difference and the share of lanes within 1e-3): what
chip_smoke.py's `obstacle_mpc` gates rest on.

With --obstacle-loop it runs tests/test_obstacle_mpc.py's single-lane
loop (40 ticks, radius 0.6) in float32 at the bench's tolerance 1e-3,
with and without the disc, under the Gauss-Newton and the exact AL
Hessian, and the same loops in float64 at the test's 1e-4: the least
distance, the mean and last tracking errors, the success rate and the
iterations, what chip_smoke.py's `obstacle_loop` gates rest on.
With --obstacle-loop-draws K it runs that loop's float32 form (the disc,
the Gauss-Newton Hessian) from K starts moved 1e-6 N(0, 1) off ref.x[0]
(the first unmoved), in JAX and in the port's plain loop on the CPU: the
spread of its success rate under roundoff-sized changes, what the
`obstacle_loop` success floor rests on.

With --tracking-tiled it runs the port's `tracking_tiled_mpc` row through
altro_tpu's own `solve_tiled` with the failed-lane rescue in float32: B
bicycle lanes (default 1024), each tracking the Scotty path from its own
knot s_b (numpy default_rng(11) over knots 0 .. 400; the plant at
ref.x[s_b] + 0.05 N(0, 1), default_rng(12)), q and c per lane through
`prob_axes`, sliding with each lane's window, the bench's options and
rescue, the batched backward in interpret mode and the scan grid, 20
ticks (`--ticks`): success rate, mean iterations and mean tracking error
(|x - ref.x[s_b + t + 1]|), what chip_smoke.py's `tracking_tiled_mpc`
gates rest on; then its first 5 ticks of 256 lanes in float32 against
float64 through jax.vmap(solve) with the rescue (JAX's tiled kernels take
float32 only): status agreement, the largest plant-state difference and
the share of lanes within 1e-3.

With --single-lane-options it runs the Scotty window of scripts/
bench_all.py (`bicycle_scotty_window_N30`, its problem, warm start and
options) under the single-lane options the port's `single_lane_options`
phase drives: `rti_mode` (the phase-split x-only full step), the
light-payload grid (`ls_grid_x_only=False`) and `pallas_backward`, each
in float32 and float64: status, iterations, ls_iterations and x_N, what
that phase's gates rest on.

With --learned-mpc it runs examples/learned_mpc.py's loop (its
`build_problem`, the task loss through `implicit_solve`, `optax.adam(0.1)`,
40 steps) in float64 and float32: the task loss at steps 0, 20 and 39 and
after the last update, the weights at step 39 and after it, and each
float32 number's relative distance from the float64 one; with --draws K
also K float32 loops from log-weights moved 1e-6 N(0, 1) (numpy seed 5):
the spread of the float32 loop under roundoff-sized changes. What
chip_smoke.py's `learned_mpc` gates rest on.

With --implicit-grad it runs tests/test_diff.py's four configurations
through `implicit_solve` in float64 and float32 with the tests' options:
the linear-quadratic gradients in q[0] and x0 (both methods), the
pendulum's in Qd (cg and tvlqr), the control-bounded one in q[0], and
`jax.vmap(jax.grad)` over B lanes of x0 (x0 + 0.1 N(0, 1), numpy seed 16)
against the single-lane gradients of lanes 0, B/2 and B-1; each float32
gradient's largest distance from the float64 one relative to the float64
gradient's largest entry; `--iterations` caps the pendulum's and the
bounded problem's solves (the tests' default 200). What chip_smoke.py's
`implicit_grad` gates rest on.

With --vmap-rescue it runs tests/test_rescue.py's problem and batch at B
lanes (half easy, half hard) through `vmap_solve_with_rescue` with the
test's options and the rescue to 40 iterations, in float32 and float64:
statuses and iterations counted by half, the primary-only run's failed
lanes, and the largest float32-vs-float64 difference of x and u. What
chip_smoke.py's `vmap_rescue` gates rest on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

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


QUAD_HOVER = 0.5 * 9.81 / 4.0
QUAD_WAYPOINTS = ((1.0, 0.0, 1.0), (1.0, 1.0, 1.5), (0.0, 1.0, 1.0), (0.0, 0.0, 0.5))


def _quadrotor_setup(lanes, ticks, switch_every, N):
    """The quadrotor waypoint problem of scripts/bench_all.py:322-564 in
    float32, its waypoint cost rows, the tick's waypoint index, the starts
    the port draws and the row's summary."""
    import torch

    from altro_tpu.models.integrators import rk4
    from altro_tpu.models.quadrotor import quadrotor_continuous
    from altro_tpu.models.tile_steps import quadrotor_cols, quadrotor_tile, rk4_cols, rk4_tile

    n, m = 12, 4
    Qd = np.tile(np.concatenate([np.full(3, 1.0), np.full(9, 0.1)]), (N + 1, 1))
    Qd[N] *= 10
    wps = np.zeros((4, n))
    wps[:, :3] = QUAD_WAYPOINTS
    cost = lqr_cost_from_reference(jnp.asarray(Qd, F32), jnp.full((N + 1, m), 1e-2, F32),
                                   jnp.asarray(np.tile(wps[0], (N + 1, 1)), F32),
                                   jnp.full((N + 1, m), QUAD_HOVER, F32))
    dyn = rk4(quadrotor_continuous())
    problem = Problem(N=N, n=n, m=m, dynamics=dyn, dynamics_jac=None, constraints=(),
                      cost=cost, h=jnp.full(N, 0.05, F32), x0=jnp.zeros(n, F32),
                      dynamics_tile=rk4_tile(quadrotor_tile()),
                      dynamics_cols=rk4_cols(quadrotor_cols()))
    c_u = 0.5 * float(np.full(m, QUAD_HOVER) @ (np.full(m, 1e-2) * np.full(m, QUAD_HOVER)))
    q_wp = jnp.asarray(-(Qd[None] * wps[:, None]), F32)
    c_wp_ = 0.5 * np.sum(Qd[None] * wps[:, None] ** 2, axis=2)
    c_wp_[:, :N] += c_u
    c_wp = jnp.asarray(c_wp_, F32)
    wp_idx = [(t // switch_every) % 4 for t in range(ticks)]
    gen = torch.Generator(device="cpu").manual_seed(1)
    x0 = (0.05 * torch.randn((1024, n), generator=gen, dtype=torch.float64)).numpy()
    x0 = np.resize(x0, (lanes, n)).astype(np.float32)
    final_wp = wps[wp_idx[-1], :3]

    def row(name, iters, statuses, x_final, seconds):
        dist = np.linalg.norm(np.asarray(x_final, np.float64)[:, :3] - final_wp[None], axis=1)
        return {"row": name, "lanes": int(np.asarray(x_final).shape[0]), "ticks": ticks,
                "success_rate": float(np.mean(np.asarray(statuses) == 0)),
                "mean_final_waypoint_dist": float(dist.mean()),
                "mean_iterations": float(np.mean(iters)),
                "max_iterations_of_a_tick": int(np.max(iters)), "cpu_seconds": seconds}

    return problem, dyn, q_wp, c_wp, wp_idx, x0, row


def quadrotor_vmapped_row(lanes, ticks=100, switch_every=25, N=30):
    """The vmapped quadrotor waypoint row (`quadrotor_waypoint_mpc_B1024`,
    bench_all.py:322-512, its non-tiled branch) in float32 through
    jax.vmap(solve) on `lanes` of the port's starts, with the row's options
    and the scan backward (`pallas_backward=False`: the same steps), for
    `ticks` ticks."""
    import time

    from altro_tpu.parallel.batch import batch_init_state

    problem, dyn, q_wp, c_wp, wp_idx, x0, row = _quadrotor_setup(lanes, ticks, switch_every, N)
    m = problem.m
    vopts = SolverOptions(
        iterations_max=15, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, rti_mode=False, use_backtracking_linesearch=True,
        parallel_linesearch=True, ls_phase_split=True, ls_try_cubic_first=False,
        ls_max_iters=8, penalty_warm_start=True, ls_armijo_only=False,
        tol_stationarity_rel=1e-5, pallas_backward=False, ls_armijo_slack=1e-6)

    @jax.jit
    def tick(x, st, q, c):
        prob = dataclasses.replace(problem, cost=dataclasses.replace(problem.cost, q=q, c=c))
        st, stats = jax.vmap(lambda x0_, s_: solve(dataclasses.replace(prob, x0=x0_), s_,
                                                   vopts))(x, st)
        x = jax.vmap(lambda xi, ui: dyn(xi, ui, jnp.asarray(0.05, F32), 0))(x, st.u[:, 0])
        return x, jax.vmap(shift_trajectory)(st), stats.iterations, stats.status

    st = dataclasses.replace(batch_init_state(problem, lanes),
                             u=jnp.full((lanes, N, m), QUAD_HOVER, F32))
    x = jnp.asarray(x0)
    iters, statuses = [], []
    t0 = time.perf_counter()
    for t in range(ticks):
        w = wp_idx[t]
        x, st, it, stat = tick(x, st, q_wp[w], c_wp[w])
        iters.append(np.asarray(it))
        statuses.append(np.asarray(stat))
    print(json.dumps(row("quadrotor_waypoint_mpc_B1024", np.stack(iters), np.stack(statuses),
                         np.asarray(x), time.perf_counter() - t0)), flush=True)


def _quadrotor_tiled_opts():
    """The tiled row's options (bench_all.py:371-398, tiled branch), the scan grid."""
    return SolverOptions(
        iterations_max=15, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, rti_mode=False, use_backtracking_linesearch=True,
        parallel_linesearch=True, ls_phase_split=True, ls_try_cubic_first=False,
        ls_max_iters=8, penalty_warm_start=True, ls_armijo_only=True,
        tol_stationarity_rel=1e-5, pallas_backward=True, pallas_rollout_tiled=False,
        ls_armijo_slack=1e-6)


def quadrotor_rows(lanes, ticks=100, switch_every=25, N=30):
    """The two quadrotor rows (scripts/bench_all.py:322-564) in float32."""
    from altro_tpu import tile_solver as tsv
    from altro_tpu.ops.tile_iter import tile_vmap
    from altro_tpu.parallel.batch import batch_init_state

    problem, dyn, q_wp, c_wp, wp_idx, x0, row = _quadrotor_setup(lanes, ticks, switch_every, N)
    n, m = problem.n, problem.m
    qopts = _quadrotor_tiled_opts()

    import time

    quadrotor_latency_row(ticks, switch_every, N, qopts)

    # tiled waypoint MPC (bench_all.py:433-472)
    tsv._FORCE_INTERPRET = True  # the Pallas backward off the TPU; the grid is the scan
    axes = dataclasses.replace(
        problem, cost=dataclasses.replace(problem.cost, Q=False, R=False, q=False, r=False,
                                          c=False),
        h=False, x0=True, A=False, B=False, f_aff=False, constraints=())
    plant = tile_vmap(lambda xk, uk: dyn(xk, uk, jnp.asarray(0.05, F32), 0), (True, True))

    @jax.jit
    def tick(x_t, st_t, q, c):
        prob = dataclasses.replace(problem, x0=x_t,
                                   cost=dataclasses.replace(problem.cost, q=q, c=c))
        st_t, stats = tsv.solve_tiled(prob, axes, st_t, qopts)
        x_t = plant(x_t, st_t.u[:, 0])
        return x_t, tsv.shift_trajectory_tiled(st_t), stats.iterations, stats.status

    st_t = tsv.state_to_tiles(dataclasses.replace(
        batch_init_state(problem, lanes), u=jnp.full((lanes, N, m), QUAD_HOVER, F32)))
    x_t = tsv.batch_to_tiles(jnp.asarray(x0))
    iters, statuses = [], []
    t0 = time.perf_counter()
    for t in range(ticks):
        w = wp_idx[t]
        x_t, st_t, it, stat = tick(x_t, st_t, q_wp[w], c_wp[w])
        iters.append(np.asarray(it).reshape(-1))
        statuses.append(np.asarray(stat).reshape(-1))
    print(json.dumps(row("quadrotor_waypoint_mpc_B1024_tiled", np.stack(iters),
                         np.stack(statuses), tsv.tiles_to_batch(x_t),
                         time.perf_counter() - t0)), flush=True)


def quadrotor_latency_row(ticks=100, switch_every=25, N=30, qopts=None):
    """The single-lane quadrotor latency row (bench_all.py:514-564) on lane
    0 of the port's starts, in float32, `ticks` ticks."""
    import time

    problem, dyn, q_wp, c_wp, wp_idx, x0, row = _quadrotor_setup(1, ticks, switch_every, N)
    m = problem.m
    if qopts is None:
        qopts = _quadrotor_tiled_opts()
    lopts = dataclasses.replace(qopts, pallas_backward=False, ls_armijo_only=True,
                                pallas_latency_backward=True)
    run = jax.jit(solve, static_argnames=("opts",))
    st = dataclasses.replace(init_state(problem), u=jnp.full((N, m), QUAD_HOVER, F32))
    x = jnp.asarray(x0[0])
    iters, statuses = [], []
    t0 = time.perf_counter()
    for t in range(ticks):
        w = wp_idx[t]
        prob = dataclasses.replace(problem, x0=x, cost=dataclasses.replace(
            problem.cost, q=q_wp[w], c=c_wp[w]))
        st, stats = run(prob, st, lopts)
        x = dyn(x, st.u[0], jnp.asarray(0.05, F32), 0)
        st = shift_trajectory(st)
        iters.append(int(stats.iterations))
        statuses.append(int(stats.status))
    print(json.dumps(row("quadrotor_latency_B1", iters, statuses, np.asarray(x)[None],
                         time.perf_counter() - t0)), flush=True)


def pendulum_row(lanes, ticks=80, N=30, h=0.06):
    """The pendulum swing-up MPC (bench_all.py:845-980) in float32 through
    vmap(solve)."""
    import time

    from altro_tpu.models.pendulum import pendulum_continuous
    from altro_tpu.parallel.batch import batch_init_state

    n, m = 2, 1
    Qd = np.tile(np.full(n, 1e-1), (N + 1, 1))
    Qd[N] *= 100.0
    torque = ConstraintSpec(
        fn=lambda x, u, k: jnp.concatenate([u - 6.0, -6.0 - u]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool).at[N].set(False),
        label="torque bound", diag_hessian=True, affine=True)
    dyn = midpoint(pendulum_continuous())
    problem = Problem(
        N=N, n=n, m=m, dynamics=dyn, dynamics_jac=None, constraints=(torque,),
        cost=lqr_cost_from_reference(
            jnp.asarray(Qd, F32), jnp.full((N + 1, m), 1e-3, F32),
            jnp.asarray(np.tile([np.pi, 0.0], (N + 1, 1)), F32), jnp.zeros((N + 1, m), F32)),
        h=jnp.full(N, h, F32), x0=jnp.zeros(n, F32))
    opts = SolverOptions(
        iterations_max=10, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True, penalty_warm_start=True,
        parallel_linesearch=True, ls_phase_split=True, ls_try_cubic_first=False,
        ls_armijo_only=True, ls_max_iters=8, ls_failure_recovery=True,
        ls_recovery_max_fails=0, ls_best_decrease_fallback=True, pallas_backward=False)
    x0 = (0.05 * np.random.default_rng(3).standard_normal((1024, n)))
    x0 = np.resize(x0, (lanes, n)).astype(np.float32)

    @jax.jit
    def tick(x, st):
        st, stats = jax.vmap(lambda x0_, s: solve(dataclasses.replace(problem, x0=x0_), s,
                                                  opts))(x, st)
        x = jax.vmap(lambda xi, ui: dyn(xi, ui, jnp.asarray(h, F32), 0))(x, st.u[:, 0])
        return x, jax.vmap(shift_trajectory)(st), stats.iterations, stats.status

    st = dataclasses.replace(batch_init_state(problem, lanes),
                             u=jnp.full((lanes, N, m), 0.1, F32))
    x = jnp.asarray(x0)
    iters, statuses = [], []
    t0 = time.perf_counter()
    for _ in range(ticks):
        x, st, it, stat = tick(x, st)
        iters.append(np.asarray(it))
        statuses.append(np.asarray(stat))
    xf = np.asarray(x, np.float64)
    up = np.sqrt((np.mod(xf[:, 0], 2 * np.pi) - np.pi) ** 2 + 0.1 * xf[:, 1] ** 2)
    print(json.dumps({"row": "pendulum_swingup_mpc_B1024", "lanes": lanes, "ticks": ticks,
                      "swingup_rate": float(np.mean(up < 0.3)),
                      "success_rate": float(np.mean(np.stack(statuses) == 0)),
                      "mean_iterations": float(np.mean(np.stack(iters))),
                      "mean_up_error": float(up.mean()),
                      "cpu_seconds": time.perf_counter() - t0}), flush=True)


def rocket_row(lanes):
    """The rocket landing (bench_all.py:732-843) in float32: one vmap(solve)."""
    import sys
    import time

    from altro_tpu.parallel.batch import batch_init_state

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from rocket_landing import build_problem

    problem, hover = build_problem(dtype=F32)
    opts = SolverOptions(
        iterations_max=120, penalty_initial=10.0, penalty_scaling=10.0,
        tol_stationarity=1e-3, tol_primal_feasibility=1e-3, tol_stationarity_rel=1e-5,
        ls_armijo_slack=1e-6, use_backtracking_linesearch=True, parallel_linesearch=True,
        ls_phase_split=True, ls_grid_x_only=True, ls_armijo_only=True, throw_errors=False,
        pallas_backward=False)
    rng = np.random.default_rng(0)
    noise = np.concatenate([2.0 * rng.standard_normal((1024, 3)),
                            0.5 * rng.standard_normal((1024, 3))], axis=1)
    x0s = np.resize(np.asarray(problem.x0, np.float64)[None] + noise, (lanes, 6))
    states = dataclasses.replace(batch_init_state(problem, lanes),
                                 u=jnp.tile(hover, (lanes, problem.N, 1)))
    run = jax.jit(jax.vmap(lambda x0, s: solve(dataclasses.replace(problem, x0=x0), s, opts)))
    t0 = time.perf_counter()
    st, stats = jax.block_until_ready(run(jnp.asarray(x0s, F32), states))
    touchdown = np.linalg.norm(np.asarray(st.x, np.float64)[:, problem.N, :3], axis=1)
    status = np.asarray(stats.status)
    print(json.dumps({"row": "rocket_soc_tiled_B1024", "lanes": lanes,
                      "success_rate": float(np.mean(status == 0)),
                      "statuses": {str(s): int(c) for s, c in zip(*np.unique(
                          status, return_counts=True))},
                      "mean_iterations": float(np.mean(np.asarray(stats.iterations))),
                      "max_iterations": int(np.max(np.asarray(stats.iterations))),
                      "mean_touchdown_m": float(touchdown.mean()),
                      "max_touchdown_m": float(touchdown.max()),
                      "cpu_seconds_with_compile": time.perf_counter() - t0}), flush=True)


BT_SEARCHES = {  # search: (option overrides, ticks) of the batched tracking runs
    "sequential_backtracking": (dict(use_backtracking_linesearch=True), 20),
    "strong_wolfe": (dict(use_backtracking_linesearch=False), 5),
    "non_split_grid": (dict(use_backtracking_linesearch=True, parallel_linesearch=True,
                            ls_phase_split=False), 5),
}


def _batched_tracking_loop(lanes, kw, ticks, dtype):
    """examples/batched_mpc.py's loop in dtype under the option overrides
    kw, from the port's starts (mpc.batched_tracking_initial_states:
    ref.x[0] + 0.05 N(0, 1), numpy seed 0). Returns (iterations [T, B],
    statuses [T, B], ls_iterations [T, B], final plant states [B, 4],
    the reference, seconds)."""
    from altro_tpu.parallel.batch import batch_init_state, batched_tracking_solver

    ref = load_scotty()
    N, n, m = 30, 4, 2
    h = float(np.float32(ref.tf / ref.N))
    Qd, Rd = np.full(n, 1e-2), np.full(m, 1e-3)
    cost = lqr_cost_from_reference(
        jnp.asarray(np.tile(Qd, (N + 1, 1)), dtype), jnp.asarray(np.tile(Rd, (N + 1, 1)), dtype),
        jnp.asarray(ref.x[: N + 1], dtype), jnp.asarray(ref.u[: N + 1], dtype))
    dm = float(np.deg2rad(60.0))  # a weak scalar: the f32 run stays f32 under x64
    steering = ConstraintSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                              cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                              label="steering")
    dyn = midpoint(bicycle_continuous())
    problem = Problem(N=N, n=n, m=m, dynamics=dyn, dynamics_jac=None, constraints=(steering,),
                      cost=cost, h=jnp.full(N, h, dtype), x0=jnp.asarray(ref.x[0], dtype))
    x_true = jnp.asarray(ref.x[0][None] + 0.05 * np.random.default_rng(0).standard_normal(
        (lanes, n)), dtype)
    shift = jax.jit(jax.vmap(shift_trajectory))
    step = jax.jit(jax.vmap(lambda x, u: dyn(x, u, h, 0)))
    opts = SolverOptions(iterations_max=10, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
                         throw_errors=False, **kw)
    runner = batched_tracking_solver(problem, opts)
    states = dataclasses.replace(
        batch_init_state(problem, lanes),
        u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dtype), (lanes, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1], dtype), (lanes, 1, 1)))
    iters, statuses, ls_iters = [], [], []
    t0 = time.perf_counter()
    for t in range(ticks):
        window = jnp.asarray(ref.x[t: t + N + 1], dtype)
        q = jnp.broadcast_to(-(jnp.asarray(Qd, dtype) * window), (lanes, N + 1, n))
        c = jnp.broadcast_to(0.5 * jnp.sum(jnp.asarray(Qd, dtype) * window * window, 1),
                             (lanes, N + 1))
        u0, states, stats = runner(x_true, q, c, states)
        x_true = step(x_true, u0)
        states = shift(states)
        iters.append(np.asarray(stats.iterations))
        statuses.append(np.asarray(stats.status))
        ls_iters.append(np.asarray(stats.ls_iterations))
    return (np.stack(iters), np.stack(statuses), np.stack(ls_iters),
            np.asarray(x_true, np.float64), ref, time.perf_counter() - t0)


def batched_tracking_rows(lanes, ref_ticks=5, ticks=None):
    """examples/batched_mpc.py's loop in f32 under each search of
    BT_SEARCHES (`ticks`, when given, those of the sequential
    backtracking), and each search's first ref_ticks ticks in f32 against
    f64 (what the algorithm itself does in f32 on this loop)."""
    jax.config.update("jax_enable_x64", True)  # the f64 runs; every f32 array is typed
    runs = dict(BT_SEARCHES)
    if ticks is not None:
        runs["sequential_backtracking"] = (runs["sequential_backtracking"][0], ticks)
    for name, (kw, ticks) in runs.items():
        iters, statuses, ls_iters, x_true, ref, seconds = _batched_tracking_loop(
            lanes, kw, ticks, F32)
        err = np.linalg.norm(x_true[:, :2] - ref.x[ticks][None, :2], axis=1)
        print(json.dumps({"row": "batched_tracking", "search": name, "lanes": lanes,
                          "ticks": ticks, "dtype": "float32",
                          "success_rate": float((statuses == 0).mean()),
                          "mean_iterations": float(iters.mean()),
                          "last_tick_mean_iterations": float(iters[-1].mean()),
                          "max_iterations": int(iters.max()),
                          "mean_final_tracking_error": float(err.mean()),
                          "max_final_tracking_error": float(err.max()),
                          "mean_last_ls_iterations": float(ls_iters.mean()),
                          "statuses": {str(k): int(v) for k, v in
                                       zip(*np.unique(statuses, return_counts=True))},
                          "seconds": seconds}), flush=True)
        runs = [_batched_tracking_loop(lanes, kw, ref_ticks, dt) for dt in (F32, jnp.float64)]
        dx = np.abs(runs[0][3] - runs[1][3])
        print(json.dumps({"row": "batched_tracking_f32_vs_f64", "search": name, "lanes": lanes,
                          "ticks": ref_ticks, "max_abs_dx_true": float(dx.max()),
                          "max_abs_dx_true_by_component": dx.max(0).tolist(),
                          "lanes_over_1e-3": int((dx.max(1) > 1e-3).sum()),
                          "status_agreement": float((runs[0][1] == runs[1][1]).mean()),
                          "iteration_agreement": float((runs[0][0] == runs[1][0]).mean())}),
              flush=True)


def _single_lane_problems(dt):
    """The five single-lane solves in dtype dt: name -> (problem, state,
    options)."""
    import sys

    from altro_tpu.models.cartpole import cartpole_continuous
    from altro_tpu.models.integrators import rk4
    from altro_tpu.models.pendulum import pendulum_continuous

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from rocket_landing import build_problem

    f32opts = SolverOptions(iterations_max=30, tol_stationarity=1e-3,
                            tol_primal_feasibility=1e-3, throw_errors=False)
    out = {}
    tol = 1e-3 if dt == F32 else 1e-4
    problem, hover = build_problem(dtype=dt)
    out["rocket_landing"] = (problem, dataclasses.replace(
        init_state(problem), u=jnp.tile(hover, (problem.N, 1))), SolverOptions(
        iterations_max=120, penalty_initial=10.0, penalty_scaling=10.0, tol_stationarity=tol,
        tol_primal_feasibility=tol, tol_stationarity_rel=1e-5,
        use_backtracking_linesearch=True, throw_errors=False))

    N, n = 100, 4
    Qd = np.tile(np.full(n, 1e-2), (N + 1, 1))
    Qd[N] = [10.0, 400.0, 10.0, 10.0]
    cost = lqr_cost_from_reference(
        jnp.asarray(Qd, dt), jnp.full((N + 1, 1), 1e-3, dt),
        jnp.asarray(np.tile([0.0, np.pi, 0.0, 0.0], (N + 1, 1)), dt), jnp.zeros((N + 1, 1), dt))
    problem = Problem(N=N, n=n, m=1, dynamics=rk4(cartpole_continuous()), dynamics_jac=None,
                      constraints=(), cost=cost, h=jnp.full(N, 0.05, dt), x0=jnp.zeros(n, dt))
    out["cartpole_swingup"] = (problem, dataclasses.replace(
        init_state(problem), u=jnp.full((N, 1), 0.2, dt)),
        SolverOptions(iterations_max=300, use_backtracking_linesearch=True))

    N = 100
    goal = ConstraintSpec(fn=lambda x, u, k: x, cone=Cone.ZERO, dim=4,
                          active=jnp.zeros(N + 1, bool).at[N].set(True), label="goal")
    problem = Problem(
        N=N, n=4, m=2, dynamics=double_integrator_dynamics(2), dynamics_jac=None,
        constraints=(goal,), cost=lqr_cost_from_reference(
            jnp.ones((N + 1, 4), dt), jnp.full((N + 1, 2), 1e-2, dt),
            jnp.zeros((N + 1, 4), dt), jnp.zeros((N + 1, 2), dt)),
        h=jnp.full(N, 0.05, dt), x0=jnp.asarray([1.0, 2.0, 0.0, 0.0], dt))
    out["double_integrator_goal_N100"] = (problem, init_state(problem),
                                          dataclasses.replace(f32opts, penalty_scaling=100.0))

    N = 50
    Qd = np.concatenate([np.full((N, 2), 1e-2), np.full((1, 2), 1.0)])
    torque = ConstraintSpec(fn=lambda x, u, k: jnp.concatenate([u - 8.0, -8.0 - u]),
                            cone=Cone.NEGATIVE_ORTHANT, dim=2,
                            active=jnp.ones(N + 1, bool).at[N].set(False), label="torque bound")
    problem = Problem(
        N=N, n=2, m=1, dynamics=midpoint(pendulum_continuous()), dynamics_jac=None,
        constraints=(torque,), cost=lqr_cost_from_reference(
            jnp.asarray(Qd, dt), jnp.full((N + 1, 1), 1e-3, dt),
            jnp.asarray(np.tile([np.pi, 0.0], (N + 1, 1)), dt), jnp.zeros((N + 1, 1), dt)),
        h=jnp.full(N, np.float32(3.0 / N), dt), x0=jnp.zeros(2, dt))
    st = init_state(problem)
    out["pendulum_swingup_bounded"] = (problem, dataclasses.replace(
        st, u=jnp.full_like(st.u, 0.1)), f32opts)

    ref = load_scotty()
    N = 30
    dm = float(np.deg2rad(60.0))
    steering = ConstraintSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                              cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                              label="steering")
    problem = Problem(
        N=N, n=4, m=2, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
        constraints=(steering,), cost=lqr_cost_from_reference(
            jnp.full((N + 1, 4), 1e-2, dt), jnp.full((N + 1, 2), 1e-3, dt),
            jnp.asarray(ref.x[: N + 1], dt), jnp.asarray(ref.u[: N + 1], dt)),
        h=jnp.full(N, float(np.float32(ref.tf / ref.N)), dt), x0=jnp.asarray(ref.x[0], dt))
    st = dataclasses.replace(init_state(problem),
                             u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dt), (N, 1)),
                             x=jnp.asarray(ref.x[: N + 1], dt))
    out["bicycle_scotty_window_N30"] = (problem, st, dataclasses.replace(
        f32opts, use_backtracking_linesearch=True, ls_try_cubic_first=True, ls_max_iters=25))
    return out


def single_lane_rows(cartpole_ref_iterations=30):
    """The single-lane solves in float32, each beside float64 (see the
    module docstring)."""
    jax.config.update("jax_enable_x64", True)  # the f64 runs; every f32 array is typed
    runs = {dt: _single_lane_problems(dt) for dt in (F32, jnp.float64)}
    tan_th, tan_ga = np.tan(np.deg2rad(25.0)), np.tan(np.deg2rad(45.0))
    for name in runs[F32]:
        row = {"row": name}
        for dt, tag in ((F32, "f32"), (jnp.float64, "f64")):
            problem, state, opts = runs[dt][name]
            t0 = time.perf_counter()
            st, stats = jax.block_until_ready(jax.jit(lambda s: solve(problem, s, opts))(state))
            x, u = np.asarray(st.x, np.float64), np.asarray(st.u, np.float64)
            r = {"status": int(stats.status), "iterations": int(stats.iterations),
                 "objective": float(stats.objective_value),
                 "primal_feasibility": float(stats.primal_feasibility),
                 "stationarity": float(stats.stationarity), "x_N": x[-1].tolist(),
                 "finite": bool(np.isfinite(x).all() and np.isfinite(u).all()),
                 "cpu_seconds_with_compile": time.perf_counter() - t0}
            if name == "rocket_landing":
                uxy = np.linalg.norm(u[:, :2], axis=1)
                excess = np.concatenate([uxy - tan_th * u[:, 2],
                                         np.linalg.norm(u, axis=1) - 20.0, 2.0 - u[:, 2],
                                         np.linalg.norm(x[:, :2], axis=1) - tan_ga * x[:, 2]])
                r.update(r_N=float(np.linalg.norm(x[-1, :3])),
                         v_N=float(np.linalg.norm(x[-1, 3:])),
                         max_thrust_ratio=float((np.linalg.norm(u, axis=1) / 20.0).max()),
                         max_pointing_ratio=float((uxy / (tan_th * u[:, 2])).max()),
                         max_cone_excess=float(excess.max()))
            if name == "cartpole_swingup":
                r.update(theta_N_err=float(abs(x[-1, 1] - np.pi)), x_N_abs=float(abs(x[-1, 0])))
            row[tag] = r
        if name == "cartpole_swingup":
            xs = []
            for dt in (F32, jnp.float64):
                problem, state, opts = runs[dt][name]
                cut = dataclasses.replace(opts, iterations_max=cartpole_ref_iterations)
                st, _ = jax.jit(lambda s: solve(problem, s, cut))(state)
                xs.append(np.asarray(st.x, np.float64))
            row["first_iterations"] = cartpole_ref_iterations
            row["max_abs_dx_f32_vs_f64_first_iterations"] = float(np.abs(xs[0] - xs[1]).max())
        print(json.dumps(row), flush=True)


def cartpole_depths(depths):
    """The cart-pole swing-up of `_single_lane_problems` in float32 and
    float64 at each iterations_max of `depths`: |theta_N - pi| and |x_N|,
    what chip_smoke.py's `cartpole_swingup` gate holds at its CP_ITERS."""
    jax.config.update("jax_enable_x64", True)
    for dt, tag in ((F32, "f32"), (jnp.float64, "f64")):
        problem, state, opts = _single_lane_problems(dt)["cartpole_swingup"]
        for iters in depths:
            cut = dataclasses.replace(opts, iterations_max=iters)
            st, stats = jax.jit(lambda s: solve(problem, s, cut))(state)
            x = np.asarray(st.x, np.float64)
            print(json.dumps({"row": "cartpole_swingup", "dtype": tag, "iterations_max": iters,
                              "status": int(stats.status),
                              "theta_N_err": float(abs(x[-1, 1] - np.pi)),
                              "x_N_abs": float(abs(x[-1, 0]))}), flush=True)


def _facade_pendulum(dt, with_tile):
    """tests/test_api.py:250-293's build(with_tile), solved in dtype dt."""
    from altro_tpu.api import ALTROSolver
    from altro_tpu.models.pendulum import pendulum_continuous
    from altro_tpu.models.tile_steps import midpoint_tile, pendulum_tile

    N, n, m = 30, 2, 1
    dyn = midpoint(pendulum_continuous())
    s = ALTROSolver(N, dtype=dt)
    s.set_dimension(n, m)
    s.set_time_step(0.06)
    s.set_explicit_dynamics(lambda x, u, h, k: dyn(x, u, h, k))
    s.set_lqr_cost(np.full(n, 1e-1), np.full(m, 1e-3), np.array([np.pi, 0.0]), np.zeros(m))
    s.set_input_bounds(u_lo=[-6.0], u_hi=[6.0])
    s.set_initial_state(np.zeros(n))
    if with_tile:
        s.set_tile_dynamics(midpoint_tile(pendulum_tile()))
    s.initialize()
    s.set_input(np.full((m,), 0.1), 0, N)
    s.set_options(SolverOptions(
        iterations_max=12, use_backtracking_linesearch=True, parallel_linesearch=True,
        ls_phase_split=True, ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8,
        throw_errors=False))
    status = s.solve()
    return int(status), s.get_iterations(), np.asarray(s.state.u, np.float64)


def _facade_di(dt, kind, tol):
    """A tests/test_api.py double-integrator facade case in dtype dt."""
    from altro_tpu.api import ALTROSolver, LAST_INDEX

    N, nx, nu = 10, 4, 2
    s = ALTROSolver(N, dtype=dt)
    s.set_dimension(nx, nu)
    s.set_time_step(0.5)
    s.set_explicit_dynamics(double_integrator_dynamics(2))
    if kind == "goal":
        s.set_lqr_cost(np.ones(nx), np.full(nu, 1e-2), np.zeros(nx), np.zeros(nu), 0, LAST_INDEX)
        s.set_constraint(lambda x, u, k: x - jnp.zeros(nx, x.dtype), nx, Cone.ZERO, "goal", N)
        opts = SolverOptions(penalty_scaling=100.0)
    elif kind == "quadratic":
        s.set_quadratic_cost(np.eye(nx), 1e-2 * np.eye(nu), np.full((nu, nx), 1e-3),
                             np.zeros(nx), np.zeros(nu), 0.0, 0, LAST_INDEX)
        opts = SolverOptions(iterations_max=10)
    else:
        s.set_cost_function(stage=lambda x, u, k: 0.5 * jnp.sum(x * x) + 0.5e-2 * jnp.sum(u * u),
                            terminal=lambda x: 0.5 * jnp.sum(x * x))
        opts = SolverOptions(iterations_max=10)
    s.set_initial_state([1.0, 2.0, 0.0, 0.0])
    s.set_options(opts.replace(tol_stationarity=tol, throw_errors=False))
    s.initialize()
    status = s.solve()
    return int(status), s.get_iterations(), np.asarray(s.get_state(N), np.float64)


def _facade_di_block(dt, with_tile, tol=1e-4):
    """tests/test_api.py:54's problem with its goal replaced by a terminal
    cost (Q_N = 100), under the phase-split Armijo-only grid, with or
    without the block step double_integrator_tile(2), in dtype dt (the
    port's mpc.double_integrator_block_step_solver)."""
    from altro_tpu.api import ALTROSolver
    from altro_tpu.models.tile_steps import double_integrator_tile

    N, n, m = 10, 4, 2
    s = ALTROSolver(N, dtype=dt)
    s.set_dimension(n, m)
    s.set_time_step(0.5)
    s.set_explicit_dynamics(double_integrator_dynamics(2))
    s.set_lqr_cost(np.ones(n), np.full(m, 1e-2), np.zeros(n), np.zeros(m), 0, N)
    s.set_lqr_cost(np.full(n, 100.0), np.full(m, 1e-2), np.zeros(n), np.zeros(m), N)
    s.set_input_bounds(u_lo=[-1.0, -1.0], u_hi=[1.0, 1.0])
    s.set_initial_state([2.0, 2.0, 0.0, 0.0])
    if with_tile:
        s.set_tile_dynamics(double_integrator_tile(2))
    s.initialize()
    s.set_options(SolverOptions(
        iterations_max=12, penalty_initial=100.0, penalty_scaling=100.0,
        use_backtracking_linesearch=True, parallel_linesearch=True, ls_phase_split=True,
        ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8, throw_errors=False,
        tol_stationarity=tol))
    status = s.solve()
    return int(status), s.get_iterations(), np.asarray(s.state.u, np.float64)


def facade_runs():
    """altro_tpu's facade in float32 and float64 (see the module docstring)."""
    from altro_tpu.api import ALTROSolver as S
    from altro_tpu.models import pendulum_continuous
    from altro_tpu.options import Verbosity

    jax.config.update("jax_enable_x64", True)  # the f64 runs; every f32 facade is typed
    example = {}
    for dt, tag in ((F32, "f32"), (jnp.float64, "f64")):  # examples/pendulum_swingup.py
        N, n, m = 50, 2, 1
        xf = np.array([np.pi, 0.0])
        s = S(N, dtype=dt)
        s.set_dimension(n, m)
        s.set_time_step(3.0 / N)
        s.set_explicit_dynamics(midpoint(pendulum_continuous()))
        s.set_lqr_cost(np.full(n, 1e-2), np.full(m, 1e-3), xf, np.zeros(m), 0, N)
        s.set_lqr_cost(np.ones(n), np.full(m, 1e-3), xf, np.zeros(m), N)
        s.set_initial_state(np.zeros(n))
        s.set_options(SolverOptions(iterations_max=20, verbose=Verbosity.SILENT))
        s.initialize()
        s.set_input([0.1])
        status = s.solve()
        example[tag] = {"status": int(status), "iterations": s.get_iterations(),
                        "objective": s.get_final_objective(),
                        "x_N": np.asarray(s.get_state(N), np.float64).tolist()}
    print(json.dumps({"facade": "pendulum_example", **example,
                      "x_N_f32_vs_f64": float(np.abs(np.subtract(example["f32"]["x_N"],
                                                                 example["f64"]["x_N"])).max())}),
          flush=True)

    runs = {(tag, tile): _facade_pendulum(dt, tile)
            for dt, tag in ((F32, "f32"), (jnp.float64, "f64")) for tile in (True, False)}
    row = {"facade": "block_step_configuration"}
    for (tag, tile), (status, iters, u) in runs.items():
        row[f"{tag}_{'block_step' if tile else 'no_block_step'}"] = {
            "status": status, "iterations": iters, "max_abs_u": float(np.abs(u).max())}
    u = {k: v[2] for k, v in runs.items()}
    row["du_f32_block_vs_no_block"] = float(np.abs(u["f32", True] - u["f32", False]).max())
    row["du_f64_block_vs_no_block"] = float(np.abs(u["f64", True] - u["f64", False]).max())
    row["du_f32_vs_f64_block"] = float(np.abs(u["f32", True] - u["f64", True]).max())
    row["du_f32_vs_f64_no_block"] = float(np.abs(u["f32", False] - u["f64", False]).max())
    print(json.dumps(row), flush=True)

    runs = {(tag, tile): _facade_di_block(dt, tile, tol)
            for dt, tag, tol in ((F32, "f32", 1e-4), (jnp.float64, "f64", 1e-4),
                                 (F32, "f32_tol_1e-3", 1e-3)) for tile in (True, False)}
    row = {"facade": "double_integrator_block_step"}
    for (tag, tile), (status, iters, u) in runs.items():
        row[f"{tag}_{'block_step' if tile else 'no_block_step'}"] = {
            "status": status, "iterations": iters, "u_0": u[0].tolist()}
    u = {k: v[2] for k, v in runs.items()}
    row["du_f32_block_vs_no_block"] = float(np.abs(u["f32", True] - u["f32", False]).max())
    row["du_f32_vs_f64_block"] = float(np.abs(u["f32", True] - u["f64", True]).max())
    row["du_f32_tol_1e-3_block_vs_no_block"] = float(
        np.abs(u["f32_tol_1e-3", True] - u["f32_tol_1e-3", False]).max())
    row["du_f32_tol_1e-3_block_vs_f64"] = float(np.abs(u["f32_tol_1e-3", True]
                                                        - u["f64", True]).max())
    print(json.dumps(row), flush=True)

    for kind in ("goal", "quadratic", "generic"):
        r32 = _facade_di(F32, kind, 1e-3)
        r64 = _facade_di(jnp.float64, kind, 1e-4)
        print(json.dumps({"facade": f"double_integrator/{kind}",
                          "f32_tol_1e-3": {"status": r32[0], "iterations": r32[1],
                                           "x_N": r32[2].tolist()},
                          "f64": {"status": r64[0], "iterations": r64[1], "x_N": r64[2].tolist()},
                          "x_N_f32_vs_f64": float(np.abs(r32[2] - r64[2]).max())}), flush=True)


def _obstacle_problem(dt, N=30, t_obs=25, r_obs=0.75, with_obstacle=True):
    """bench_all.py:580-617's problem (the obstacle row's) in dt."""
    ref = load_scotty()
    dm = float(np.deg2rad(60.0))
    c_obs = [float(v) for v in ref.x[t_obs + N // 2][:2]]

    def obs_fn(x, u, k):
        dx_ = x[0] - c_obs[0]
        dy_ = x[1] - c_obs[1]
        return jnp.stack([r_obs * r_obs - dx_ * dx_ - dy_ * dy_])

    cons = (
        ConstraintSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                       cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                       label="steering"),
        ConstraintSpec(fn=lambda x, u, k: jnp.stack([u[0] - 8.0, -u[0], u[1] - 1.5,
                                                     -1.5 - u[1]]),
                       cone=Cone.NEGATIVE_ORTHANT, dim=4,
                       active=jnp.ones(N + 1, bool).at[N].set(False), label="input bounds"))
    if with_obstacle:
        cons = cons + (ConstraintSpec(fn=obs_fn, cone=Cone.NEGATIVE_ORTHANT, dim=1,
                                      active=jnp.ones(N + 1, bool), label="obstacle"),)
    cost = lqr_cost_from_reference(
        jnp.asarray(np.full((N + 1, 4), 1e-2), dt), jnp.asarray(np.full((N + 1, 2), 1e-3), dt),
        jnp.asarray(ref.x[: N + 1], dt), jnp.asarray(ref.u[: N + 1], dt))
    h = float(np.float32(ref.tf / ref.N))
    problem = Problem(N=N, n=4, m=2, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
                      constraints=cons, cost=cost, h=jnp.full(N, h, dt),
                      x0=jnp.asarray(ref.x[0], dt))
    return problem, ref, np.asarray(c_obs), h


def _obstacle_row(lanes, ticks, dt, exact=False, N=30, r_obs=0.75, start=0):
    """The obstacle row's loop (bench_all.py:645-696) in dt from the first
    `lanes` of the port's starts, over its ticks start .. start + ticks - 1
    (a later start begins at ref.x[start] plus the same noise, warm-started
    on that tick's window, as mpc.run_obstacle_mpc's `start`). Returns
    (statuses, iterations, dists, errors [T, B] each, plant states
    [T, B, 4], seconds)."""
    from altro_tpu.parallel.batch import batch_init_state

    problem, ref, c_obs, h = _obstacle_problem(dt, N=N, r_obs=r_obs)
    opts = SolverOptions(
        iterations_max=25, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True, penalty_warm_start=True,
        penalty_warm_start_decay=0.5, parallel_linesearch=True, ls_phase_split=True,
        ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=24,
        ls_failure_recovery=True, ls_recovery_max_fails=0, ls_best_decrease_fallback=True,
        tol_stationarity_rel=1e-5, pallas_backward=False, exact_al_hessian=exact)
    Qd = np.full(4, 1e-2)
    xw = np.stack([ref.x[t: t + N + 1] for t in range(start, start + ticks + 1)])
    qs = jnp.asarray(-(Qd[None, None, :] * xw), dt)
    cs = 0.5 * np.sum(Qd[None, None, :] * xw * xw, axis=2)
    cs[:, :N] += 0.5 * float(ref.u[0] @ (np.full(2, 1e-3) * ref.u[0]))
    cs = jnp.asarray(cs, dt)
    x0s = ref.x[start][None] + 0.02 * np.random.default_rng(7).standard_normal((1024, 4))
    x = jnp.asarray(np.resize(x0s, (lanes, 4)), dt)
    dyn = problem.dynamics

    @jax.jit
    def tick(x, st, q, c):
        prob = dataclasses.replace(problem, cost=dataclasses.replace(problem.cost, q=q, c=c))
        st, stats = jax.vmap(lambda x0_, s_: solve(dataclasses.replace(prob, x0=x0_), s_,
                                                   opts))(x, st)
        x = jax.vmap(lambda xi, ui: dyn(xi, ui, jnp.asarray(h, dt), 0))(x, st.u[:, 0])
        return x, jax.vmap(shift_trajectory)(st), stats.iterations, stats.status

    st = dataclasses.replace(
        batch_init_state(problem, lanes),
        u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dt), (lanes, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[start: start + N + 1], dt), (lanes, 1, 1)))
    iters, statuses, xs = [], [], []
    t0 = time.perf_counter()
    for t in range(ticks):
        x, st, it, stat = tick(x, st, qs[t], cs[t])
        iters.append(np.asarray(it))
        statuses.append(np.asarray(stat))
        xs.append(np.asarray(x, np.float64))
    xs = np.stack(xs)
    dist = np.linalg.norm(xs[:, :, :2] - c_obs[None, None], axis=2)
    err = np.linalg.norm(xs[:, :, :2] - xw[1: ticks + 1, 0, None, :2], axis=2)
    return np.stack(statuses), np.stack(iters), dist, err, xs, time.perf_counter() - t0


def obstacle_rows(lanes, ticks=60, start=0, hessian="both", exact_lanes=256, ref_lanes=64,
                  ref_ticks=10):
    """The obstacle row in float32 over its ticks start .. start + ticks - 1
    (Gauss-Newton at `lanes`, exact at min(lanes, exact_lanes); `hessian`
    one of them or both), then, for both, f32 against f64 over the first
    `ref_ticks` ticks of `ref_lanes` lanes under each Hessian."""
    jax.config.update("jax_enable_x64", True)  # the f64 runs; every f32 array is typed
    r_obs = 0.75
    for name, B, exact in (("gauss_newton", lanes, False),
                           ("exact", min(lanes, exact_lanes), True)):
        if hessian not in ("both", name):
            continue
        status, iters, dist, err, _, secs = _obstacle_row(B, ticks, F32, exact=exact,
                                                          start=start)
        print(json.dumps({
            "row": f"bicycle_obstacle_mpc_{name}", "lanes": B, "start": start, "ticks": ticks,
            "success_rate": float(np.mean(status == 0)),
            "statuses": {str(s): int(c) for s, c in zip(*np.unique(status, return_counts=True))},
            "min_obstacle_clearance": float(dist.min()) - r_obs,
            "mean_tracking_error": float(err.mean()),
            "mean_iterations": float(iters.mean()), "max_iterations": int(iters.max()),
            "cpu_seconds_with_compile": secs}), flush=True)
    if hessian != "both":
        return
    for name, exact in (("gauss_newton", False), ("exact", True)):
        s32, _, _, _, x32, _ = _obstacle_row(ref_lanes, ref_ticks, F32, exact=exact)
        s64, _, _, _, x64, _ = _obstacle_row(ref_lanes, ref_ticks, jnp.float64, exact=exact)
        dx = np.abs(x32 - x64).max(axis=(0, 2))  # per lane over the ticks
        print(json.dumps({
            "row": f"bicycle_obstacle_mpc_{name}_f32_vs_f64", "lanes": ref_lanes,
            "ticks": ref_ticks, "status_agreement": float(np.mean(s32 == s64)),
            "max_state_diff": float(dx.max()),
            "lanes_within_1e-3": float(np.mean(dx <= 1e-3))}), flush=True)


def _obstacle_loop(dt, with_obstacle, exact, tol, ticks=40, N=30, dx0=None):
    """tests/test_obstacle_mpc.py's loop in dt (its `_build`: the steering
    and input bounds declared diagonal and affine, radius 0.6 at
    ref.x[15 + N // 2]); dx0 moves the plant's start off ref.x[0]."""
    ref = load_scotty()
    problem, _, c_obs, h = _obstacle_problem(dt, N=N, t_obs=15, r_obs=0.6,
                                             with_obstacle=with_obstacle)
    problem = dataclasses.replace(problem, constraints=tuple(
        dataclasses.replace(spec, diag_hessian=True, affine=True)
        if spec.label != "obstacle" else spec for spec in problem.constraints))
    state = dataclasses.replace(
        init_state(problem), u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dt), (N, 1)),
        x=jnp.asarray(ref.x[: N + 1], dt))
    opts = SolverOptions(iterations_max=30, use_backtracking_linesearch=True,
                         penalty_warm_start=True, throw_errors=False, tol_stationarity=tol,
                         tol_primal_feasibility=tol, exact_al_hessian=exact)
    run = jax.jit(solve, static_argnames=("opts",))
    dyn = problem.dynamics
    Qd = np.full(4, 1e-2)
    c_u = 0.5 * float(ref.u[0] @ (np.full(2, 1e-3) * ref.u[0]))
    if dx0 is not None:
        problem = set_initial_state(problem, problem.x0 + jnp.asarray(dx0, dt))
    x = problem.x0
    dists, errs, statuses, iters = [], [], [], []
    for t in range(ticks):
        state, stats = run(problem, state, opts)
        statuses.append(int(stats.status))
        iters.append(int(stats.iterations))
        x = dyn(x, state.u[0], problem.h[0], 0)
        p = np.asarray(x, np.float64)[:2]
        dists.append(float(np.linalg.norm(p - c_obs)))
        errs.append(float(np.linalg.norm(p - ref.x[t + 1][:2])))
        window = ref.x[t + 1: t + N + 2]
        c_new = 0.5 * np.sum(Qd * window * window, axis=1)
        c_new[:N] += c_u
        problem = update_linear_costs(problem, q=jnp.asarray(-(Qd * window), dt),
                                      c=jnp.asarray(c_new, dt))
        problem = set_initial_state(problem, x)
        state = shift_trajectory(state)
    return {"min_dist": min(dists), "mean_tracking_error": float(np.mean(errs)),
            "last_tracking_error": errs[-1],
            "success_rate": float(np.mean(np.asarray(statuses) == 0)),
            "statuses": {str(s): statuses.count(s) for s in sorted(set(statuses))},
            "mean_iterations": float(np.mean(iters)), "max_iterations": max(iters)}


def obstacle_loops():
    """tests/test_obstacle_mpc.py's loop: f32 at 1e-3 and f64 at 1e-4, with
    and without the disc, under each Hessian."""
    jax.config.update("jax_enable_x64", True)
    for dt, tol in ((F32, 1e-3), (jnp.float64, 1e-4)):
        for exact in (False, True):
            for with_obstacle in (True, False):
                out = _obstacle_loop(dt, with_obstacle, exact, tol)
                print(json.dumps({"row": "obstacle_loop", "dtype": jnp.dtype(dt).name,
                                  "tol": tol, "exact": exact, "with_obstacle": with_obstacle,
                                  **out}), flush=True)


def obstacle_loop_draws(draws, scale=1e-6):
    """The spread of tests/test_obstacle_mpc.py's float32 loop (the disc,
    the Gauss-Newton Hessian, tolerance 1e-3) over starts moved off
    ref.x[0] by scale N(0, 1) (numpy seed 0; draw 0 unmoved): JAX's loop
    and, where torch is there, the port's plain loop on the CPU
    (`mpc.run_obstacle_loop`) from the same starts, each draw's success
    rate, statuses and trajectory numbers."""
    jax.config.update("jax_enable_x64", True)
    moves = scale * np.random.default_rng(0).standard_normal((draws, 4))
    moves[0] = 0.0
    try:
        import torch

        from altro_tpu_torch import mpc as port_mpc
        from altro_tpu_torch.io.scotty import load_scotty as port_scotty
    except ImportError:
        torch = None
    for i, dx0 in enumerate(moves):
        out = _obstacle_loop(F32, True, False, 1e-3, dx0=dx0)
        row = {"row": "obstacle_loop_draw", "draw": i, "scale": scale,
               "jax_f32": {k: out[k] for k in ("success_rate", "statuses", "min_dist",
                                               "mean_tracking_error", "last_tracking_error")}}
        if torch is not None:
            torch.set_num_threads(1)
            res = port_mpc.run_obstacle_loop(port_scotty(), True, False, dx0=dx0,
                                             opts=port_mpc.obstacle_loop_options(1e-3),
                                             dtype=torch.float32, device="cpu")
            m = res.metrics()
            row["port_f32_cpu"] = {
                "success_rate": m["success_rate"],
                "statuses": {str(s): res.status.count(s) for s in sorted(set(res.status))},
                **{k: m[k] for k in ("min_dist", "mean_tracking_error", "last_tracking_error")}}
        print(json.dumps(row), flush=True)


def _tracking_tiled_opts(rescue):
    """bench.py's options (:198-215, the phase-split x-only Armijo-only grid
    of width 8, one block) and its rescue (R=10), the scan grid."""
    from altro_tpu.rescue import rescue_options

    opts = SolverOptions(
        iterations_max=10, use_backtracking_linesearch=True, tol_stationarity=1e-3,
        tol_primal_feasibility=1e-3, throw_errors=False, penalty_warm_start=True,
        penalty_warm_start_decay=1.0, parallel_linesearch=True, ls_phase_split=True,
        ls_try_cubic_first=False, ls_parallel_width=8, ls_max_iters=8, ls_armijo_slack=0.0,
        ls_failure_recovery=False, ls_recovery_max_fails=2, ls_best_decrease_fallback=True,
        ls_armijo_only=True, ls_grid_x_only=True, pallas_rollout_tiled=False)
    return (opts, rescue_options(opts, iterations_max=10, recovery_max_fails=0)) if rescue \
        else opts


def _tracking_tiled_setup(lanes, ticks, dt, N=30):
    """The row's problem (the bench's), each lane's start, plant states and
    sliding (q, c) [T+1, B, N+1, ...] (mpc.tracking_tiled_windows)."""
    ref = load_scotty()
    dm = 60 * np.pi / 180.0
    problem = Problem(
        N=N, n=4, m=2, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
        constraints=(ConstraintSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                                    cone=Cone.NEGATIVE_ORTHANT, dim=2,
                                    active=jnp.ones(N + 1, bool), diag_hessian=True,
                                    affine=True),),
        cost=lqr_cost_from_reference(jnp.full((N + 1, 4), 1e-2, dt),
                                     jnp.full((N + 1, 2), 1e-3, dt),
                                     jnp.asarray(ref.x[: N + 1], dt),
                                     jnp.asarray(ref.u[: N + 1], dt)),
        h=jnp.full(N, float(np.float32(ref.tf / ref.N)), dt), x0=jnp.asarray(ref.x[0], dt))
    starts = np.random.default_rng(11).integers(0, 401, size=1024)[:lanes]
    x0 = (np.asarray(ref.x)[starts]
          + 0.05 * np.random.default_rng(12).standard_normal((1024, 4))[:lanes])
    idx = starts[:, None, None] + np.arange(ticks + 1)[None, :, None] + np.arange(N + 1)
    xw = np.moveaxis(np.asarray(ref.x)[idx], 0, 1)  # [T+1, B, N+1, 4]
    Qd = np.full(4, 1e-2)
    qs = -(Qd * xw)
    cs = 0.5 * np.sum(Qd * xw * xw, axis=-1)
    cs[:, :, :N] += 0.5 * float(ref.u[0] @ (np.full(2, 1e-3) * ref.u[0]))
    u0 = np.zeros((lanes, N, 2))
    u0[:, :, 0] = np.asarray(ref.u)[starts, 0][:, None]
    return problem, ref, starts, x0, xw, qs, cs, u0


def tracking_tiled_row(lanes, ticks=20, ref_lanes=256, ref_ticks=5):
    """The port's tracking_tiled_mpc row through JAX's solve_tiled with the
    rescue, q and c per lane through prob_axes, in float32; then f32 against
    f64 over its first ticks through jax.vmap(solve)."""
    from altro_tpu import tile_solver as tsv
    from altro_tpu.ops.tile_iter import tile_vmap
    from altro_tpu.parallel.batch import batch_init_state
    from altro_tpu.rescue import solve_tiled_with_rescue

    jax.config.update("jax_enable_x64", True)  # the f64 run; every f32 array is typed
    problem, ref, starts, x0, xw, qs, cs, u0 = _tracking_tiled_setup(lanes, ticks, F32)
    N = problem.N
    opts, opts_r = _tracking_tiled_opts(True)
    tsv._FORCE_INTERPRET = True  # the Pallas backward off the TPU; the grid is the scan
    axes = dataclasses.replace(
        problem, cost=dataclasses.replace(problem.cost, Q=False, R=False, q=True, r=False,
                                          c=True),
        h=False, x0=True, A=False, B=False, f_aff=False,
        constraints=tuple(dataclasses.replace(s, active=False) for s in problem.constraints))
    h = jnp.asarray(problem.h[0], F32)
    plant = tile_vmap(lambda xk, uk: problem.dynamics(xk, uk, h, 0), (True, True))

    @jax.jit
    def tick(x_t, st_t, q_t, c_t):
        prob = dataclasses.replace(problem, x0=x_t,
                                   cost=dataclasses.replace(problem.cost, q=q_t, c=c_t))
        st_t, stats = solve_tiled_with_rescue(prob, axes, st_t, opts, opts_r)
        return plant(x_t, st_t.u[:, 0]), tsv.shift_trajectory_tiled(st_t), stats

    st_t = tsv.state_to_tiles(dataclasses.replace(
        batch_init_state(problem, lanes), u=jnp.asarray(u0, F32),
        x=jnp.asarray(xw[0], F32)))
    x_t = tsv.batch_to_tiles(jnp.asarray(x0, F32))
    iters, statuses, errs = [], [], []
    t0 = time.perf_counter()
    for t in range(ticks):
        x_t, st_t, stats = tick(x_t, st_t, tsv.batch_to_tiles(jnp.asarray(qs[t], F32)),
                                tsv.batch_to_tiles(jnp.asarray(cs[t], F32)))
        iters.append(np.asarray(tsv.tiles_to_batch(stats.iterations)).reshape(-1))
        statuses.append(np.asarray(tsv.tiles_to_batch(stats.status)).reshape(-1))
        x = np.asarray(tsv.tiles_to_batch(x_t), np.float64)
        errs.append(np.linalg.norm(x - xw[t + 1, :, 0], axis=1))
    status, it = np.stack(statuses), np.stack(iters)
    print(json.dumps({
        "row": "tracking_tiled_mpc", "lanes": lanes, "ticks": ticks,
        "success_rate": float(np.mean(status == 0)),
        "statuses": {str(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))},
        "mean_iterations": float(it.mean()), "max_iterations": int(it.max()),
        "mean_tracking_error": float(np.mean(errs)),
        "cpu_seconds_with_compile": time.perf_counter() - t0}), flush=True)

    def vmapped(dt):
        prob, _, _, x0r, xwr, qsr, csr, u0r = _tracking_tiled_setup(ref_lanes, ref_ticks, dt)
        o, o_r = _tracking_tiled_opts(True)

        @jax.jit
        def tick(x, st, q, c):
            def solve_all(s, op):
                return jax.vmap(lambda x0_, s_, q_, c_: solve(dataclasses.replace(
                    prob, x0=x0_, cost=dataclasses.replace(prob.cost, q=q_, c=c_)), s_, op))(
                    x, s, q, c)

            st1, stats1 = solve_all(st, o)
            failed = stats1.status != 0
            st2, stats2 = solve_all(st1, o_r)
            pick = lambda a, b: jnp.where(failed.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
            st = jax.tree.map(pick, st2, st1)
            status = jnp.where(failed, stats2.status, stats1.status)
            u0_ = st.u[:, 0]
            x = jax.vmap(lambda xi, ui: prob.dynamics(xi, ui, prob.h[0], 0))(x, u0_)
            return x, jax.vmap(shift_trajectory)(st), status

        st = dataclasses.replace(batch_init_state(prob, ref_lanes), u=jnp.asarray(u0r, dt),
                                 x=jnp.asarray(xwr[0], dt))
        x = jnp.asarray(x0r, dt)
        xs, sts = [], []
        for t in range(ref_ticks):
            x, st, stat = tick(x, st, jnp.asarray(qsr[t], dt), jnp.asarray(csr[t], dt))
            xs.append(np.asarray(x, np.float64))
            sts.append(np.asarray(stat))
        return np.stack(xs), np.stack(sts)

    x32, s32 = vmapped(F32)
    x64, s64 = vmapped(jnp.float64)
    dx = np.abs(x32 - x64).max(axis=(0, 2))
    print(json.dumps({
        "row": "tracking_tiled_mpc_f32_vs_f64", "lanes": ref_lanes, "ticks": ref_ticks,
        "status_agreement": float(np.mean(s32 == s64)), "max_state_diff": float(dx.max()),
        "lanes_within_1e-3": float(np.mean(dx <= 1e-3))}), flush=True)


SINGLE_LANE_OPTIONS = {  # variant: overrides of the Scotty window row's options
    "rti_mode": dict(rti_mode=True, ls_phase_split=True, ls_grid_x_only=True),
    "light_grid": dict(parallel_linesearch=True, ls_phase_split=True, ls_grid_x_only=False,
                       ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=24),
    "pallas_backward": dict(pallas_backward=True),
}


def single_lane_options():
    """The Scotty window row under rti_mode, the light-payload grid and
    pallas_backward, in float32 and float64 (see the module docstring)."""
    jax.config.update("jax_enable_x64", True)  # the f64 runs; every f32 array is typed
    for variant, kw in SINGLE_LANE_OPTIONS.items():
        row = {"row": "bicycle_scotty_window_N30", "variant": variant, "options": kw}
        for dt, tag in ((F32, "f32"), (jnp.float64, "f64")):
            problem, state, opts = _single_lane_problems(dt)["bicycle_scotty_window_N30"]
            opts = dataclasses.replace(opts, **kw)
            st, stats = jax.block_until_ready(jax.jit(lambda s: solve(problem, s, opts))(state))
            row[tag] = {"status": int(stats.status), "iterations": int(stats.iterations),
                        "ls_iterations": int(stats.ls_iterations),
                        "x_N": np.asarray(st.x[-1], np.float64).tolist()}
        row["x_N_f32_vs_f64"] = float(np.abs(np.asarray(row["f32"]["x_N"])
                                             - np.asarray(row["f64"]["x_N"])).max())
        print(json.dumps(row), flush=True)


def _module(path, name):
    """A module of the repo loaded from its file (an example or a test's
    problem builders)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _learned_loop(ex, dt, theta0, steps=40):
    import optax

    from altro_tpu.diff import implicit_solve

    def task_loss(lw):
        x, u = implicit_solve(ex.build_problem(lw, dtype=dt))
        return 100.0 * jnp.sum(x[-1] ** 2) + 0.05 * jnp.sum(u ** 2)

    theta = jnp.asarray(theta0, dt)
    loss_and_grad = jax.jit(jax.value_and_grad(task_loss))
    opt = optax.adam(0.1)
    opt_state = opt.init(theta)
    losses, weights = [], []
    for _ in range(steps):
        loss, g = loss_and_grad(theta)
        losses.append(float(loss))
        weights.append(np.exp(np.asarray(theta, np.float64)).tolist())
        updates, opt_state = opt.update(g, opt_state)
        theta = optax.apply_updates(theta, updates)
    losses.append(float(loss_and_grad(theta)[0]))
    weights.append(np.exp(np.asarray(theta, np.float64)).tolist())
    return {"loss_0": losses[0], "loss_20": losses[20], "loss_39": losses[39],
            "loss_final": losses[-1], "weights_39": weights[39], "weights_final": weights[-1]}


def learned_mpc_loops(draws=0):
    """examples/learned_mpc.py's loop in float64 and float32 (see the
    module docstring)."""
    jax.config.update("jax_enable_x64", True)
    ex = _module("examples/learned_mpc.py", "learned_mpc_example")
    runs = {tag: _learned_loop(ex, dt, np.zeros(3)) for dt, tag in ((jnp.float64, "f64"),
                                                                   (F32, "f32"))}

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))

    spread = {k: rel(runs["f32"][k], runs["f64"][k]) for k in runs["f64"]}
    print(json.dumps({"row": "learned_mpc", **runs, "f32_vs_f64_rel": spread}), flush=True)
    if draws:
        rng = np.random.default_rng(5)
        out = [_learned_loop(ex, F32, 1e-6 * rng.standard_normal(3)) for _ in range(draws)]
        print(json.dumps({"row": "learned_mpc_f32_draws", "draws": draws, "scale": 1e-6,
                          "f32_vs_f64_rel": {k: max(rel(o[k], runs["f64"][k]) for o in out)
                                             for k in runs["f64"]},
                          "loss_final": [o["loss_final"] for o in out],
                          "weights_final": [o["weights_final"] for o in out]}), flush=True)


def _diff_problems(td, dt):
    """tests/test_diff.py's three problems in dtype dt, each a function of
    the parameter its gradient is taken in."""
    def lqr(q, x0):
        pb = td._di_problem(dtype=dt)
        c = pb.cost
        return dataclasses.replace(pb, cost=DiagonalCost(c.Q, c.R, c.q.at[0].set(q), c.r, c.c),
                                   x0=x0)

    def pendulum(Qd):
        base = td._pendulum_problem([1.0, 0.1], dtype=dt)
        Q = base.cost.Q.at[: base.N].set(jnp.broadcast_to(Qd, (base.N, 2)))
        xg = jnp.asarray([np.pi, 0.0], dt)
        return dataclasses.replace(base, cost=DiagonalCost(
            Q, base.cost.R, -Q * xg, base.cost.r, 0.5 * jnp.sum(Q * xg * xg, axis=1)))

    def bounded(q):
        pb = lqr(q, td._di_problem(dtype=dt).x0)
        bound = ConstraintSpec(fn=lambda x, u, k: jnp.concatenate([u - 0.5, -0.5 - u]),
                               cone=Cone.NEGATIVE_ORTHANT, dim=4,
                               active=jnp.arange(pb.N + 1) < pb.N)
        return dataclasses.replace(pb, constraints=(bound,))

    return lqr, pendulum, bounded


def implicit_grads(lanes=1024, iterations=200):
    """tests/test_diff.py's four configurations in float64 and float32 (see
    the module docstring)."""
    jax.config.update("jax_enable_x64", True)
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    td = _module("tests/test_diff.py", "test_diff_problems")
    from altro_tpu.diff import implicit_solve

    tight = dict(tol_stationarity=1e-9, tol_primal_feasibility=1e-9, iterations_max=iterations)
    x0_noise = 0.1 * np.random.default_rng(16).standard_normal((lanes, 4))
    out = {}
    for dt, tag in ((jnp.float64, "f64"), (F32, "f32")):
        lqr, pendulum, bounded = _diff_problems(td, dt)
        pb0 = td._di_problem(dtype=dt)

        def loss(pb, opts, method="tvlqr"):
            return td._loss_of_solution(*implicit_solve(pb, opts=opts, method=method))

        g = {}
        for method in ("tvlqr", "cg"):
            gq, gx = jax.jit(jax.grad(lambda q, x0: loss(lqr(q, x0), SolverOptions(), method),
                                      argnums=(0, 1)))(pb0.cost.q[0], pb0.x0)
            g[f"lqr_{method}_q"], g[f"lqr_{method}_x0"] = gq, gx
            g[f"pendulum_{method}"] = jax.jit(jax.grad(
                lambda Qd: loss(pendulum(Qd), SolverOptions(**tight), method)))(
                    jnp.asarray([1.0, 0.1], dt))
        g["bounded_tvlqr"] = jax.jit(jax.grad(lambda q: loss(bounded(q), SolverOptions(
            **tight, penalty_max=1e10))))(pb0.cost.q[0] * 4.0)
        vloss = jax.grad(lambda x0: loss(lqr(pb0.cost.q[0], x0), SolverOptions()))
        x0s = pb0.x0 + jnp.asarray(x0_noise, dt)
        t0 = time.perf_counter()
        vg = jax.block_until_ready(jax.jit(jax.vmap(vloss))(x0s))
        vmap_s = time.perf_counter() - t0
        single = jax.jit(vloss)
        picks = sorted({0, lanes // 2, lanes - 1})
        vs_single = max(float(jnp.max(jnp.abs(vg[b] - single(x0s[b]))) / float(
            jnp.max(jnp.abs(vg[b])))) for b in picks)
        g["vmap_lanes"] = vg
        out[tag] = {k: np.asarray(v, np.float64) for k, v in g.items()}
        out[tag + "_meta"] = {"vmap_vs_single_rel": vs_single, "vmap_seconds": vmap_s}
    rows = {}
    for k, ref in out["f64"].items():
        scale = max(float(np.abs(ref).max()), 1e-300)
        rows[k] = {"f64": ref.tolist() if ref.size <= 8 else None,
                   "f32_vs_f64_rel": float(np.abs(out["f32"][k] - ref).max()) / scale}
    print(json.dumps({"row": "implicit_grad", "lanes": lanes, "iterations": iterations,
                      "grads": rows,
                      "f64": out["f64_meta"], "f32": out["f32_meta"]}), flush=True)


def vmap_rescue_row(lanes=1024):
    """tests/test_rescue.py's problem and batch at B lanes through
    `vmap_solve_with_rescue` in float32 and float64 (see the module
    docstring)."""
    jax.config.update("jax_enable_x64", True)
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    tr = _module("tests/test_rescue.py", "test_rescue_problem")
    from altro_tpu.parallel.batch import batch_init_state
    from altro_tpu.rescue import rescue_options, vmap_solve_with_rescue

    half = lanes // 2
    runs = {}
    for dt, tag in ((jnp.float64, "f64"), (F32, "f32")):
        base = tr._problem()
        problem = jax.tree_util.tree_map(
            lambda a: a.astype(dt) if jnp.issubdtype(a.dtype, jnp.floating) else a, base)
        x0b = jnp.asarray(np.concatenate([np.tile([np.pi, 0.0], (half, 1)),
                                          np.zeros((half, 2))]), dt)
        states = batch_init_state(problem, lanes)
        u0 = np.concatenate([np.zeros((half, tr.N, 1)), np.full((half, tr.N, 1), 0.1)])
        states = dataclasses.replace(states, u=jnp.asarray(u0, dt))

        def one(x0, st):
            return solve(dataclasses.replace(problem, x0=x0), st, tr.OPTS)

        _, stats_p = jax.jit(jax.vmap(one))(x0b, states)
        st, stats = jax.jit(lambda x0, s: vmap_solve_with_rescue(
            problem, x0, s, tr.OPTS, rescue_options(tr.OPTS, iterations_max=40)))(x0b, states)
        status, iters = np.asarray(stats.status), np.asarray(stats.iterations)
        runs[tag] = {"primary_failed_hard": int((np.asarray(stats_p.status)[half:] != 0).sum()),
                     "primary_failed_easy": int((np.asarray(stats_p.status)[:half] != 0).sum()),
                     "status_easy": sorted(set(status[:half].tolist())),
                     "status_hard": sorted(set(status[half:].tolist())),
                     "iterations_easy": sorted(set(iters[:half].tolist())),
                     "iterations_hard": sorted(set(iters[half:].tolist())),
                     "x": np.asarray(st.x, np.float64), "u": np.asarray(st.u, np.float64)}
    diff = {k: float(np.abs(runs["f32"][k] - runs["f64"][k]).max()) for k in ("x", "u")}
    for r in runs.values():
        del r["x"], r["u"]
    print(json.dumps({"row": "vmap_rescue", "lanes": lanes, **runs, "f32_vs_f64_max_abs": diff}),
          flush=True)


def aot_rows(calls=3):
    """The `mpc_latency_aot` row's tick (scripts/bench_all.py:229-279: its
    problem, options and warm-started inputs) through altro_tpu's jitted
    `mpc_step`, `calls` ticks chained state to state from the row's
    inputs, in float64 and float32 at B = 1: per tick u0, iterations and
    status, then the last state's x, u and rho. What chip_smoke.py's
    `export_aot` phase holds the port's f64 artifact to."""
    jax.config.update("jax_enable_x64", True)
    from altro_tpu.mpc import mpc_step

    ref = load_scotty()
    N = 30
    h = float(np.float32(ref.tf / ref.N))
    delta_max = float(np.deg2rad(60.0))  # a weak Python float: the f32 run stays f32
    out = {"row": "mpc_latency_aot", "N": N, "calls": calls}
    for dt, tag in ((jnp.float64, "f64"), (F32, "f32")):
        steering = ConstraintSpec(
            fn=lambda x, u, k: jnp.stack([x[3] - delta_max, -delta_max - x[3]]),
            cone=Cone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
            label="steering", diag_hessian=True)
        problem = Problem(
            N=N, n=4, m=2, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
            constraints=(steering,),
            cost=lqr_cost_from_reference(
                jnp.full((N + 1, 4), 1e-2, dt), jnp.full((N + 1, 2), 1e-3, dt),
                jnp.asarray(ref.x[: N + 1], dt), jnp.asarray(ref.u[: N + 1], dt)),
            h=jnp.full(N, h, dt), x0=jnp.asarray(ref.x[0], dt))
        opts = SolverOptions(
            iterations_max=10, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
            throw_errors=False, use_backtracking_linesearch=True, penalty_warm_start=True,
            parallel_linesearch=True, ls_phase_split=True, ls_armijo_only=True,
            ls_grid_x_only=True, ls_max_iters=8)
        st = dataclasses.replace(
            init_state(problem), u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dt), (N, 1)),
            x=jnp.asarray(ref.x[: N + 1], dt))
        xm = jnp.asarray(ref.x[1], dt)
        xr = jnp.asarray(ref.x[1: N + 2], dt)
        ur = jnp.asarray(ref.u[1: N + 2], dt)
        step = jax.jit(lambda s: mpc_step(problem, s, xm, xr, ur, opts))
        ticks = []
        for _ in range(calls):
            u0, st, stats = step(st)
            ticks.append({"u0": np.asarray(u0, np.float64).tolist(),
                          "iterations": int(stats.iterations), "status": int(stats.status)})
        out[tag] = {"ticks": ticks, "x": np.asarray(st.x, np.float64).tolist(),
                    "u": np.asarray(st.u, np.float64).tolist(), "rho": float(st.rho)}
    out["f32_vs_f64_max_abs"] = {k: float(np.abs(np.asarray(out["f32"][k])
                                               - np.asarray(out["f64"][k])).max())
                                 for k in ("x", "u")}
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tol-stationarity", type=float, default=1e-4)
    ap.add_argument("--quadrotor", action="store_true",
                    help="run the two quadrotor rows instead of the reference solves")
    ap.add_argument("--pendulum", action="store_true",
                    help="run the pendulum swing-up MPC row")
    ap.add_argument("--rocket", action="store_true", help="run the rocket landing row")
    ap.add_argument("--batched-tracking", action="store_true",
                    help="run examples/batched_mpc.py's loop under three searches")
    ap.add_argument("--single-lane-rows", action="store_true",
                    help="run the rocket, the cart-pole and the single-lane BASELINE rows")
    ap.add_argument("--quadrotor-latency", action="store_true",
                    help="run the single-lane quadrotor latency row alone (--ticks, default 100)")
    ap.add_argument("--quadrotor-vmapped", action="store_true",
                    help="run the vmapped quadrotor waypoint row through jax.vmap(solve)")
    ap.add_argument("--ticks", type=int, default=None,
                    help="ticks of the vmapped quadrotor row (default 100) and of the batched "
                         "tracking's sequential backtracking (default 20)")
    ap.add_argument("--facade", action="store_true",
                    help="run the facade's pendulum example, block-step configuration and "
                         "double-integrator cases")
    ap.add_argument("--obstacle", action="store_true",
                    help="run the obstacle-constrained bicycle MPC row under both Hessians")
    ap.add_argument("--start", type=int, default=0,
                    help="the obstacle row's first tick (default 0)")
    ap.add_argument("--hessian", choices=("both", "gauss_newton", "exact"), default="both",
                    help="the obstacle row's AL Hessian (default both)")
    ap.add_argument("--obstacle-loop", action="store_true",
                    help="run tests/test_obstacle_mpc.py's single-lane loop")
    ap.add_argument("--obstacle-loop-draws", type=int, default=0,
                    help="run that loop in float32 from this many starts 1e-6 apart (JAX's "
                         "and the port's plain loop on the CPU)")
    ap.add_argument("--tracking-tiled", action="store_true",
                    help="run the tracking_tiled_mpc row through JAX's solve_tiled with q and c "
                         "per lane")
    ap.add_argument("--single-lane-options", action="store_true",
                    help="run the Scotty window row under rti_mode, the light-payload grid and "
                         "pallas_backward")
    ap.add_argument("--learned-mpc", action="store_true",
                    help="run examples/learned_mpc.py's loop in float64 and float32")
    ap.add_argument("--draws", type=int, default=0,
                    help="float32 learned-MPC loops from log-weights 1e-6 apart")
    ap.add_argument("--implicit-grad", action="store_true",
                    help="run tests/test_diff.py's gradients in float64 and float32")
    ap.add_argument("--iterations", type=int, default=200,
                    help="iterations_max of --implicit-grad's pendulum and bounded solves")
    ap.add_argument("--vmap-rescue", action="store_true",
                    help="run tests/test_rescue.py's batch at --lanes through "
                         "vmap_solve_with_rescue")
    ap.add_argument("--cartpole-depths", type=str, default="",
                    help="the cart-pole swing-up at these iterations_max (comma-separated), "
                         "float32 and float64")
    ap.add_argument("--aot", action="store_true",
                    help="run the mpc_latency_aot row's tick (--ticks calls, default 3) in "
                         "float64 and float32")
    ap.add_argument("--lanes", type=int, default=1024,
                    help="lanes of the batched rows (the tiled quadrotor row: a multiple "
                         "of 1024)")
    args = ap.parse_args()
    if args.quadrotor:
        quadrotor_rows(args.lanes)
    if args.pendulum:
        pendulum_row(args.lanes)
    if args.rocket:
        rocket_row(args.lanes)
    if args.batched_tracking:
        batched_tracking_rows(args.lanes, ticks=args.ticks)
    if args.quadrotor_vmapped:
        quadrotor_vmapped_row(args.lanes, ticks=args.ticks or 100)
    if args.quadrotor_latency:
        quadrotor_latency_row(ticks=args.ticks or 100)
    if args.single_lane_rows:
        single_lane_rows()
    if args.facade:
        facade_runs()
    if args.obstacle:
        obstacle_rows(args.lanes, ticks=args.ticks or 60, start=args.start,
                      hessian=args.hessian)
    if args.obstacle_loop:
        obstacle_loops()
    if args.obstacle_loop_draws:
        obstacle_loop_draws(args.obstacle_loop_draws)
    if args.tracking_tiled:
        tracking_tiled_row(args.lanes, ticks=args.ticks or 20)
    if args.single_lane_options:
        single_lane_options()
    if args.learned_mpc:
        learned_mpc_loops(args.draws)
    if args.implicit_grad:
        implicit_grads(args.lanes, args.iterations)
    if args.vmap_rescue:
        vmap_rescue_row(args.lanes)
    if args.aot:
        aot_rows(args.ticks or 3)
    if args.cartpole_depths:
        cartpole_depths([int(v) for v in args.cartpole_depths.split(",")])
    if (args.aot or args.cartpole_depths or args.learned_mpc or args.implicit_grad or args.vmap_rescue or args.quadrotor or args.pendulum or args.rocket or args.batched_tracking
            or args.single_lane_rows or args.facade or args.quadrotor_vmapped or args.obstacle
            or args.obstacle_loop or args.obstacle_loop_draws or args.tracking_tiled
            or args.single_lane_options or args.quadrotor_latency):
        return
    tol = args.tol_stationarity
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
