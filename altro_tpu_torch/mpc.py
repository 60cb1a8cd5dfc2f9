"""Receding-horizon MPC: the functional MPC API and the port's entry points.

Counterparts: altro_tpu/mpc.py (the MPC layer: `shift_trajectory`,
`set_initial_state`, `update_linear_costs`, `update_tracking_window`,
`mpc_step`, each a pure function on (Problem, SolverState) of one lane,
the reference's UpdateLinearCosts / SetInitialState / ShiftTrajectory
followed by a warm-started solve), the tiled branch of
bench.py's closed loop (`child_main`, its problem, options, rescue and
`tick_tiled`) and the quadrotor waypoint row of scripts/bench_all.py
(:322-512, its non-tiled branch), here as library functions:

* `scotty_problem` builds the bench problem: kinematic bicycle (n=4,
  m=2) with midpoint integration, horizon N, diagonal tracking cost
  (Q = 1e-2, R = 1e-3) on the reference window, one affine steering bound
  |delta| <= 60 deg (NEGATIVE_ORTHANT) with its constant Jacobian given,
  and the column-form and block-form steps that the rollout kernels run.
  The same function builds the N=30 window and the N=500 long horizon
  (scripts/bench_all.py `scotty_long_horizon_N500`, whose unconstrained
  row is `dataclasses.replace(problem, constraints=())`).
* `scotty_reference_problem`, `reference_mpc_options` and
  `run_reference_mpc`: the C++ reference's own Scotty MPC test
  (tests/test_bicycle.py:84-165, bicycle_test.cpp:140-360): one lane,
  N=30, the steering bound as a plain constraint function (dense
  expansions), the default strong-Wolfe search or sequential
  backtracking, 200 warm-started resolves driven by
  `update_linear_costs`, `set_initial_state` and `shift_trajectory`.
* `bench_options` returns the bench's solver and rescue options;
  `long_horizon_options` the single-solve options of the N=500 rows, and
  `long_horizon_state` their warm start.
* `run_closed_loop` runs B lanes for T ticks: each tick slides the cost
  window, solves with the failed-lane rescue, applies u_0 to the true
  plant, and shifts the warm start. The state stays lane-minor for the
  whole run (converted once at each end).
* `quadrotor_waypoint_problem`, `quadrotor_options`,
  `quadrotor_initial_states` and `run_quadrotor_waypoints`: the n=12
  quadrotor (rk4) flying B lanes through four waypoints, switched every
  25 ticks, each tick one vmapped solve (`parallel.batch.solve_lanes`)
  with the dense backward kernel (`pallas_backward=True`).
* `quadrotor_tiled_options` and `run_quadrotor_waypoints_tiled`: the
  same row through `tile_solver.solve_tiled` (bench_all.py's tiled branch,
  `quadrotor_waypoint_mpc_B1024_tiled`): the Armijo-only grid, the
  batched backward kernel and the trial-grid kernel with the quadrotor's
  column step.
* `quadrotor_latency_options` and `run_quadrotor_latency`: one quadrotor
  through the waypoints by the single-lane `solver.solve`
  (`quadrotor_latency_B1`, bench_all.py:514-564) on the single-lane
  backward and trial-rollout kernels.
* `pendulum_swingup_problem`, `pendulum_swingup_options`,
  `pendulum_initial_states` and `run_pendulum_swingup_tiled`: B pendulums
  swung up by closed-loop MPC through `tile_solver.solve_tiled`
  (`pendulum_swingup_mpc_B1024`, bench_all.py:845-980; its f64 oracle
  twin tests/test_pendulum_mpc_trace.py): the batched backward at (2, 1)
  and the trial-grid kernel on the pendulum's midpoint column step with
  the torque bound's two rows on u. `run_pendulum_swingup` is the same
  loop through the vmapped solve, the row's plain reference.
* `rocket_soc_options`, `rocket_initial_states`, `run_rocket_soc_tiled`
  and `run_rocket_soc`: one batched solve of B rocket landings
  (`reference_problems.rocket_landing_problem`: three SOC groups, a
  min-thrust row, the touchdown equality) through `solve_tiled`
  (`rocket_soc_tiled_B1024`, bench_all.py:732-843: dense expansions, the
  batched backward at (6, 3), the plain grid) or through the vmapped
  solve.
* `batched_tracking_problem`, `batched_tracking_options`,
  `batched_tracking_initial_states` and `run_batched_tracking`:
  examples/batched_mpc.py's fleet of B bicycle controllers tracking the
  Scotty path, each tick one `parallel.batch.batched_tracking_solver`
  call with per-lane cost rows, under the sequential backtracking search
  and the dense backward kernel.
* `tracking_tiled_starts`, `tracking_tiled_initial_states`,
  `tracking_tiled_windows` and `run_tracking_tiled`: a fleet of B
  bicycle controllers, each tracking the Scotty path from its own place,
  through `solve_tiled` with the rescue (the bench's options): q and c
  per lane (JAX's `prob_axes`), the trial-grid kernel's per-lane rows.
* `obstacle_problem`, `obstacle_options`, `obstacle_initial_states` and
  `run_obstacle_mpc`: the obstacle-constrained bicycle MPC of
  scripts/bench_all.py (`bicycle_obstacle_mpc_B1024`, :566-730): B lanes
  on the Scotty path past a disc of radius 0.75 centred on it, three
  groups (the steering bound, the input bounds, the nonlinear obstacle
  row with a dense AL Hessian), each tick one vmapped solve
  (`parallel.batch.solve_lanes`) on the dense backward kernel;
  `obstacle_loop_options` and `run_obstacle_loop`: tests/
  test_obstacle_mpc.py's single-lane loop (radius 0.6, 40 ticks) through
  `solver.solve` and the functional MPC API, with or without the disc.
  Both take the Gauss-Newton or the exact AL Hessian.
* The single-lane rows, each one `solver.solve` on the single-lane
  backward kernel (`SingleSolveResult`): `rocket_landing_options` and
  `run_rocket_landing` (examples/rocket_landing.py:114-149, at (6, 3)),
  `cartpole_swingup_options` and `run_cartpole_swingup`
  (tests/test_models_extra.py::test_cartpole_swing_up, at (4, 1)), and
  three single-lane rows of scripts/bench_all.py with its `f32opts`
  (:47-50): `double_integrator_goal_options` / `run_double_integrator_goal`
  (`double_integrator_goal_N100`, (4, 2)), `baseline_f32_options` /
  `run_pendulum_bounded` (`pendulum_swingup_bounded`, (2, 1)) and
  `bicycle_window_options` / `run_bicycle_window`
  (`bicycle_scotty_window_N30`, (4, 2)). Their problems are in
  reference_problems.py (the bicycle row's is `scotty_reference_problem`).
* `run_pendulum_example`: examples/pendulum_swingup.py's `main`, the
  canonical single solve, through the facade (`api.ALTROSolver`, N=50,
  20 iterations, Verbosity.INNER); on the card the (2, 1) backward
  kernel.
* `pendulum_block_step_solver`: tests/test_api.py:250-293's configuration
  through the facade, with or without the pendulum's block step; on the
  card the (2, 1) backward kernel and (with it) the pendulum trial
  kernel. `trial_operands` builds the operands of that kernel (and of the
  bicycle's and the double integrator's) at any N, W and row count.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from altro_tpu_torch import rescue as rsc
from altro_tpu_torch import tile_solver as tsv
from altro_tpu_torch.cones import Cone
from altro_tpu_torch.io.scotty import load_scotty
from altro_tpu_torch.linesearch import Trace
from altro_tpu_torch.models.bicycle import bicycle_continuous
from altro_tpu_torch.models.double_integrator import double_integrator_dynamics
from altro_tpu_torch.models.integrators import midpoint, rk4
from altro_tpu_torch.models.pendulum import pendulum_continuous
from altro_tpu_torch.models.quadrotor import quadrotor_continuous
from altro_tpu_torch.models.tile_steps import (
    bicycle_cols,
    bicycle_tile,
    double_integrator_cols,
    double_integrator_tile,
    midpoint_cols,
    midpoint_tile,
    pendulum_cols,
    pendulum_tile,
    quadrotor_cols,
    quadrotor_tile,
    rk4_cols,
    rk4_tile,
)
from altro_tpu_torch.options import SolverOptions, Verbosity
from altro_tpu_torch.parallel.batch import batch_init_state, batched_tracking_solver, solve_lanes
from altro_tpu_torch.reference_problems import rocket_landing_problem
from altro_tpu_torch.problem import (
    ConstraintSpec,
    DiagonalCost,
    Problem,
    lqr_cost_from_reference,
)
from altro_tpu_torch.solver import SolverState, SolveStats, init_state, solve

__all__ = [
    "shift_trajectory",
    "set_initial_state",
    "update_linear_costs",
    "update_tracking_window",
    "mpc_step",
    "Q_DIAG",
    "R_DIAG",
    "DELTA_MAX",
    "scotty_problem",
    "scotty_reference_problem",
    "reference_mpc_options",
    "ReferenceMPCResult",
    "run_reference_mpc",
    "bench_options",
    "long_horizon_options",
    "long_horizon_state",
    "perturbed_initial_states",
    "ClosedLoopResult",
    "run_closed_loop",
    "QUAD_HOVER",
    "QUAD_WAYPOINTS",
    "quadrotor_waypoint_problem",
    "quadrotor_options",
    "quadrotor_initial_states",
    "WaypointResult",
    "run_quadrotor_waypoints",
    "quadrotor_tiled_options",
    "run_quadrotor_waypoints_tiled",
    "quadrotor_latency_options",
    "run_quadrotor_latency",
    "pendulum_swingup_problem",
    "pendulum_swingup_options",
    "pendulum_initial_states",
    "SwingupResult",
    "run_pendulum_swingup_tiled",
    "run_pendulum_swingup",
    "rocket_soc_options",
    "rocket_initial_states",
    "RocketResult",
    "run_rocket_soc_tiled",
    "run_rocket_soc",
    "batched_tracking_problem",
    "batched_tracking_options",
    "batched_tracking_initial_states",
    "BatchedTrackingResult",
    "run_batched_tracking",
    "SingleSolveResult",
    "run_single_solve",
    "rocket_landing_options",
    "rocket_metrics",
    "run_rocket_landing",
    "cartpole_swingup_options",
    "run_cartpole_swingup",
    "baseline_f32_options",
    "double_integrator_goal_options",
    "run_double_integrator_goal",
    "run_pendulum_bounded",
    "bicycle_window_options",
    "run_bicycle_window",
    "ExampleResult",
    "run_pendulum_example",
    "pendulum_block_step_solver",
    "double_integrator_block_step_solver",
    "trial_operands",
    "double_integrator_grid_operands",
    "obstacle_problem",
    "obstacle_options",
    "obstacle_initial_states",
    "ObstacleResult",
    "run_obstacle_mpc",
    "obstacle_loop_options",
    "ObstacleLoopResult",
    "run_obstacle_loop",
    "tracking_tiled_starts",
    "tracking_tiled_initial_states",
    "tracking_tiled_windows",
    "run_tracking_tiled",
    "closed_loop_metrics",
    "per_lane_rows",
]

Q_DIAG = 1e-2
R_DIAG = 1e-3
DELTA_MAX = 60 * math.pi / 180.0


# ---------------------------------------------------------------------------
# The functional MPC API (one lane; altro_tpu/mpc.py:33-114)
# ---------------------------------------------------------------------------


def shift_trajectory(state: SolverState) -> SolverState:
    """Shift x, u one step forward (the warm start of the next resolve):
    x[k] = x[k+1] for k < N, u[k] = u[k+1] for k < N-1, the last entries
    kept (altro_solver.cpp:283-293). Duals and gains are not shifted."""
    x = torch.cat([state.x[1:], state.x[-1:]], dim=0)
    u = torch.cat([state.u[1:], state.u[-1:]], dim=0)
    return dataclasses.replace(state, x=x, u=u)


def set_initial_state(problem: Problem, x0) -> Problem:
    """Functional SetInitialState (altro_solver.cpp:177-190)."""
    return dataclasses.replace(
        problem, x0=torch.as_tensor(x0, dtype=problem.dtype, device=problem.device))


def update_linear_costs(problem: Problem, q=None, r=None, c=None) -> Problem:
    """Replace the linear cost terms (UpdateLinearCosts, altro_solver.cpp:
    266-281): Q and R stay, q [N+1, n], r [N+1, m] and c [N+1] slide with
    the reference. Arrays or tensors; each is cast to the cost's dtype and
    device."""
    cost = problem.cost
    kw = {name: torch.as_tensor(v, dtype=cost.q.dtype, device=cost.q.device)
          for name, v in (("q", q), ("r", r), ("c", c)) if v is not None}
    return dataclasses.replace(problem, cost=dataclasses.replace(cost, **kw))


def update_tracking_window(problem: Problem, x_ref_window, u_ref_window=None) -> Problem:
    """Point the diagonal tracking cost at a new reference window, (q, r, c)
    rebuilt from Q and R as SetLQRCost does (altro_solver.cpp:138-172).
    x_ref_window [N+1, n]; u_ref_window [N+1, m] (zeros when None)."""
    cost = problem.cost
    if not isinstance(cost, DiagonalCost):
        raise TypeError("update_tracking_window requires a DiagonalCost")
    kw = dict(dtype=cost.Q.dtype, device=cost.Q.device)
    u_ref = (torch.zeros_like(cost.r) if u_ref_window is None
             else torch.as_tensor(u_ref_window, **kw))
    new = lqr_cost_from_reference(cost.Q, cost.R, torch.as_tensor(x_ref_window, **kw), u_ref)
    return dataclasses.replace(problem, cost=new)


def mpc_step(problem: Problem, state: SolverState, x_measured, x_ref_window,
             u_ref_window=None, opts: SolverOptions = SolverOptions()):
    """One warm-started MPC tick: slide the tracking window, set the measured
    initial state, shift the warm start and solve. Returns (u_0, the new
    state, the solve's stats)."""
    problem = update_tracking_window(problem, x_ref_window, u_ref_window)
    problem = set_initial_state(problem, x_measured)
    new_state, stats = solve(problem, shift_trajectory(state), opts)
    return new_state.u[0], new_state, stats


def update_tracking_window_lanes(problem: Problem, x_ref_window, u_ref_window) -> Problem:
    """`update_tracking_window` for lane-minor windows x_ref [N+1, n, B],
    u_ref [N+1, m, B]: Q and R kept, (q, r, c) one row per lane, each entry
    as `lqr_cost_from_reference` forms it (the vmapped `mpc_step`'s cost)."""
    cost = problem.cost
    if not isinstance(cost, DiagonalCost):
        raise TypeError("update_tracking_window_lanes requires a DiagonalCost")
    Q, R = cost.Q[..., None], cost.R[..., None]
    c = 0.5 * torch.sum(Q * x_ref_window * x_ref_window, dim=1)
    cu = 0.5 * torch.sum(R * u_ref_window * u_ref_window, dim=1)
    not_term = (torch.arange(Q.shape[0], device=Q.device) != Q.shape[0] - 1)[:, None]
    return dataclasses.replace(problem, cost=dataclasses.replace(
        cost, q=-Q * x_ref_window, r=-R * u_ref_window, c=c + cu * not_term.to(cu.dtype)))


def mpc_step_lanes(problem: Problem, state: SolverState, x_measured, x_ref_window,
                   u_ref_window, opts: SolverOptions = SolverOptions()):
    """`mpc_step` on B lanes at once, batch-major at its edges (x_measured
    [B, n], x_ref [B, N+1, n], u_ref [B, N+1, m], state [B, ...]): each
    lane's window, measured state and shifted warm start through the
    vmapped solve (`parallel.batch.solve_lanes`), the counterpart of
    `jax.vmap(mpc_step)`. Returns (u0 [B, m], the new state, stats [B])."""
    lanes = tsv.batch_to_lanes
    prob = dataclasses.replace(
        update_tracking_window_lanes(problem, lanes(x_ref_window), lanes(u_ref_window)),
        x0=lanes(x_measured))
    st, stats = solve_lanes(prob, tsv.shift_trajectory_tiled(tsv.state_to_lanes(state)), opts)
    st = tsv.state_from_lanes(st)
    return st.u[:, 0], st, stats


def _steering_fn(x, u, k):
    return torch.stack([x[3] - DELTA_MAX, -DELTA_MAX - x[3]])


def _constant_jacobian(J):
    """jac(x, u, k) of an affine constraint: the constant [p, n+m] rows,
    broadcast (as a view) over the batch dims of x and u."""

    def jac(x, u, k):
        batch = torch.broadcast_shapes(x.shape[1:], u.shape[1:])
        return J.reshape(J.shape + (1,) * len(batch)).expand(J.shape + batch)

    return jac


def scotty_problem(ref, N: int = 30, *, dtype=torch.float32, device="cuda") -> Problem:
    """The bench's Scotty tracking problem over the first reference window
    (N <= 500 for the vendored path's 501 knots), on the card unless
    `device` says otherwise."""
    n, m = 4, 2
    kw = dict(dtype=dtype, device=device)
    h = float(np.float32(ref.tf / ref.N))
    cost = lqr_cost_from_reference(
        torch.full((N + 1, n), Q_DIAG, **kw),
        torch.full((N + 1, m), R_DIAG, **kw),
        torch.as_tensor(ref.x[: N + 1], **kw),
        torch.as_tensor(ref.u[: N + 1], **kw),
    )
    # rows +-e_3 of the steering bound, given rather than differentiated
    J = torch.zeros((2, n + m), **kw)
    J[0, 3], J[1, 3] = 1.0, -1.0
    steering = ConstraintSpec(
        fn=_steering_fn, cone=Cone.NEGATIVE_ORTHANT, dim=2,
        active=torch.ones(N + 1, dtype=torch.bool, device=device),
        jac=_constant_jacobian(J), label="steering bound", diag_hessian=True,
        affine=True,
    )
    return Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
        constraints=(steering,), cost=cost, h=torch.full((N,), h, **kw),
        x0=torch.as_tensor(ref.x[0], **kw),
        dynamics_cols=midpoint_cols(bicycle_cols()),
        dynamics_tile=midpoint_tile(bicycle_tile()),
    )


def scotty_reference_problem(ref, N: int = 30, *, dtype=torch.float32, device="cuda"):
    """The reference's Scotty tracking problem and warm start
    (tests/test_bicycle.py::make_scotty_problem, bicycle_test.cpp:140-245):
    the bench's model, cost and horizon, the steering bound with its
    constant Jacobian given (the rows +-e_3, what forward mode gives
    exactly) but no diagonal-Hessian declaration, so the AL Hessian is
    dense, as the JAX test runs it; the state at the reference window and
    u = (u_ref[0][0], 0). Returns (problem, state), one lane."""
    n, m = 4, 2
    kw = dict(dtype=dtype, device=device)
    cost = lqr_cost_from_reference(
        torch.full((N + 1, n), Q_DIAG, **kw), torch.full((N + 1, m), R_DIAG, **kw),
        torch.as_tensor(ref.x[: N + 1], **kw), torch.as_tensor(ref.u[: N + 1], **kw))
    J = torch.zeros((2, n + m), **kw)
    J[0, 3], J[1, 3] = 1.0, -1.0
    steering = ConstraintSpec(
        fn=_steering_fn, cone=Cone.NEGATIVE_ORTHANT, dim=2,
        active=torch.ones(N + 1, dtype=torch.bool, device=device),
        jac=_constant_jacobian(J), label="steering bound")
    problem = Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
        constraints=(steering,), cost=cost,
        h=torch.full((N,), float(np.float32(ref.tf / ref.N)), **kw),
        x0=torch.as_tensor(ref.x[0], **kw))
    st = init_state(problem)
    u0 = torch.tensor([ref.u[0][0], 0.0], **kw)
    return problem, dataclasses.replace(st, u=u0.expand(N, m).contiguous(),
                                        x=torch.as_tensor(ref.x[: N + 1], **kw))


def reference_mpc_options() -> SolverOptions:
    """The reference MPC test's options: 80 iterations, the sequential
    backtracking search, every other option at its default."""
    return SolverOptions(iterations_max=80, use_backtracking_linesearch=True)


@dataclasses.dataclass
class ReferenceMPCResult:
    iterations: list  # [T] iterations per resolve
    status: list  # [T] SolveStatus per resolve
    tracking_error: np.ndarray  # [T] |x_sim - x_ref| after each tick, float64
    state: SolverState  # the final solver state
    seconds: float  # wall time of the loop (synchronized on CUDA)


def run_reference_mpc(problem: Problem, state: SolverState, ref, *, ticks: int = 200,
                      opts: Optional[SolverOptions] = None) -> ReferenceMPCResult:
    """The reference's closed loop (tests/test_bicycle.py:119-165): each
    tick solves, applies u_0 to the plant (the problem's dynamics, in its
    dtype), slides the tracking terms (q, c) one knot along the path with
    `update_linear_costs`, sets the measured state with
    `set_initial_state` and shifts the warm start with `shift_trajectory`.
    problem, state: from `scotty_reference_problem`; opts default
    `reference_mpc_options()`."""
    opts = reference_mpc_options() if opts is None else opts
    N, n = problem.N, problem.n
    h = problem.h[0]
    Qd = np.full(n, Q_DIAG)
    u0 = np.asarray([ref.u[0][0], 0.0])
    c_u = 0.5 * float(u0 @ (np.full(problem.m, R_DIAG) * u0))
    x_sim = problem.x0
    iters, statuses, x_sims = [], [], []
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)
    t0 = time.perf_counter()
    for t in range(ticks):
        state, stats = solve(problem, state, opts)
        iters.append(stats.iterations)
        statuses.append(stats.status)
        x_sim = problem.dynamics(x_sim, state.u[0], h, 0)
        x_sims.append(x_sim)
        window = ref.x[t + 1: t + N + 2]
        c_new = 0.5 * np.sum(Qd[None, :] * window * window, axis=1)
        c_new[:N] += c_u
        problem = update_linear_costs(problem, q=-(Qd[None, :] * window), c=c_new)
        problem = set_initial_state(problem, x_sim)
        state = shift_trajectory(state)
    iters = torch.stack(iters).tolist()
    statuses = torch.stack(statuses).tolist()
    xs = torch.stack(x_sims).double().cpu().numpy()
    seconds = time.perf_counter() - t0
    errs = np.linalg.norm(xs - ref.x[1: ticks + 1], axis=1)
    return ReferenceMPCResult(iters, statuses, errs, state, seconds)


def bench_options(iterations_max: int = 10, rescue_iterations: int = 10,
                  rti: bool = False):
    """(opts, opts_rescue) of the bench's headline: parallel phase-split
    x-only Armijo-only grid search, width 8, one block, penalty warm
    start, best-decrease fallback; rescue at 10 iterations with unlimited
    line-search recovery. rti=True gives the bench's real-time-iteration
    row instead: one full-step iteration per tick and no rescue tier
    (opts_rescue None)."""
    opts = SolverOptions(
        iterations_max=1 if rti else iterations_max,
        rti_mode=rti,
        use_backtracking_linesearch=True,
        tol_stationarity=1e-3,
        tol_primal_feasibility=1e-3,
        throw_errors=False,
        penalty_warm_start=True,
        penalty_warm_start_decay=1.0,
        parallel_linesearch=True,
        ls_phase_split=True,
        ls_try_cubic_first=False,
        ls_parallel_width=8,
        ls_max_iters=8,
        ls_armijo_slack=0.0,
        ls_failure_recovery=False,
        ls_recovery_max_fails=2,
        ls_best_decrease_fallback=True,
        ls_armijo_only=not rti,
        ls_grid_x_only=True,
    )
    if rti:
        return opts, None
    return opts, rsc.rescue_options(opts, iterations_max=rescue_iterations,
                                    recovery_max_fails=0)


def long_horizon_options() -> SolverOptions:
    """Single-solve options of the N=500 rows (scripts/bench_all.py
    `scotty_long_horizon_N500`, scripts/proto_n500_rollout.py): a fixed
    budget of 20 iterations, the phase-split x-only Armijo-only grid of
    width 8 over 24 trials (3 blocks), the single-lane backward and
    trial-rollout kernels, diagonal expansions."""
    return SolverOptions(
        iterations_max=20,
        tol_stationarity=1e-3,
        tol_primal_feasibility=1e-3,
        throw_errors=False,
        use_backtracking_linesearch=True,
        symmetrize_ctg=True,
        parallel_linesearch=True,
        ls_phase_split=True,
        ls_grid_x_only=True,
        ls_try_cubic_first=False,
        ls_armijo_only=True,
        ls_max_iters=24,
        pallas_latency_backward=True,
        pallas_rollout=True,
        diag_expansion=True,
    )


def long_horizon_state(problem: Problem, ref) -> SolverState:
    """The N=500 rows' warm start: x = the reference path, u = (u_ref[0][0],
    0) at every knot (unbatched, on the problem's device and dtype)."""
    N = problem.N
    kw = dict(dtype=problem.dtype, device=problem.device)
    st = init_state(problem)
    u0 = torch.tensor([ref.u[0][0], 0.0], **kw)
    return dataclasses.replace(st, u=u0.expand(N, problem.m).contiguous(),
                               x=torch.as_tensor(ref.x[: N + 1], **kw))


def perturbed_initial_states(ref, batch: int, *, seed: int = 0, noise: float = 0.02,
                             dtype=torch.float32, device="cuda") -> torch.Tensor:
    """[B, n] initial plant states: the path's start plus Gaussian noise
    drawn from a seeded torch.Generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x0 = torch.as_tensor(ref.x[0], dtype=torch.float64)
    xs = x0[None] + noise * torch.randn((batch, x0.shape[0]), generator=gen,
                                        dtype=torch.float64)
    return xs.to(dtype=dtype, device=device)


@dataclasses.dataclass
class ClosedLoopResult:
    iterations: torch.Tensor  # [T, B] int32, both tiers summed
    tracking_error: torch.Tensor  # [T, B] |x_true - x_ref| after each tick
    status: torch.Tensor  # [T, B] int32
    rescue_ticks: int  # ticks whose rescue ran
    x_true: torch.Tensor  # [B, n] final plant states
    state: SolverState  # final solver state, batch-major
    seconds: float  # wall time of the run (synchronized on CUDA)


def _windows(ref, N: int, ticks: int, problem: Problem, start: int = 0):
    """Sliding tracking windows (q, c) per tick from tick `start`, as
    bench.py builds them."""
    n = problem.n
    # [T+1, N+1, n]
    xw = np.stack([ref.x[t: t + N + 1] for t in range(start, start + ticks + 1)])
    Qd = np.full(n, Q_DIAG)
    Rd = np.full(problem.m, R_DIAG)
    qs = -(Qd[None, None, :] * xw)
    cs = 0.5 * np.sum(Qd[None, None, :] * xw * xw, axis=2)
    cs[:, :N] += 0.5 * float(ref.u[0] @ (Rd * ref.u[0]))
    kw = dict(dtype=problem.dtype, device=problem.device)
    return (torch.as_tensor(xw, **kw), torch.as_tensor(qs, **kw),
            torch.as_tensor(cs, **kw))


def run_closed_loop(problem: Problem, ref, x_true0: torch.Tensor, *, ticks: int,
                    opts: SolverOptions, opts_rescue: Optional[SolverOptions] = None,
                    state0: Optional[SolverState] = None) -> ClosedLoopResult:
    """Closed-loop batched MPC on the reference path.

    problem: from `scotty_problem` (shared data, x0 unused); x_true0
    [B, n] the lanes' initial plant states; opts_rescue None runs without
    the rescue tier. state0 (batch-major) defaults to the bench's warm
    start: the reference window as x, u = (u_ref[0][0], 0).
    """
    N, B = problem.N, x_true0.shape[0]
    dt, dev = problem.dtype, problem.device
    xw, qs, cs = _windows(ref, N, ticks, problem)
    if state0 is None:
        st = batch_init_state(problem, B)
        u0 = torch.tensor([ref.u[0][0], 0.0], dtype=dt, device=dev)
        state0 = dataclasses.replace(
            st, u=u0.expand(B, N, 2).contiguous(),
            x=xw[0].expand(B, N + 1, problem.n).contiguous())
    if torch.cuda.is_available() and x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    t0 = time.perf_counter()
    st = tsv.state_to_lanes(state0)
    x_true = tsv.batch_to_lanes(x_true0)
    iters = torch.empty((ticks, B), dtype=torch.int32, device=dev)
    errs = torch.empty((ticks, B), dtype=dt, device=dev)
    statuses = torch.empty((ticks, B), dtype=torch.int32, device=dev)
    rescue_ticks = 0
    h = problem.h[0]
    for t in range(ticks):
        prob_t = dataclasses.replace(
            problem, cost=dataclasses.replace(problem.cost, q=qs[t], c=cs[t]),
            x0=x_true)
        if opts_rescue is not None:
            info = {}
            st, stats = rsc.solve_tiled_with_rescue(prob_t, st, opts, opts_rescue, info)
            rescue_ticks += int(info["rescued"])
        else:
            st, stats = tsv.solve_tiled(prob_t, st, opts)
        x_true = problem.dynamics(x_true, st.u[0], h, 0)
        st = tsv.shift_trajectory_tiled(st)
        diff = x_true - xw[t + 1, 0][:, None]
        errs[t] = torch.sqrt(torch.sum(diff * diff, dim=0))
        iters[t] = stats.iterations
        statuses[t] = stats.status
    x_true_b = tsv.lanes_to_batch(x_true)
    state_b = tsv.state_from_lanes(st)
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    seconds = time.perf_counter() - t0
    return ClosedLoopResult(iters, errs, statuses, rescue_ticks, x_true_b, state_b,
                            seconds)


# ---------------------------------------------------------------------------
# A fleet tracking its own places on the path through solve_tiled, the cost
# rows per lane (JAX's `prob_axes` on q and c)
# ---------------------------------------------------------------------------

TRACKING_TILED_LAST_START = 400  # lane starts over knots 0 .. 400 of the path's 501


def tracking_tiled_starts(batch: int, *, seed: int = 11) -> np.ndarray:
    """[B] each lane's starting knot on the Scotty path, drawn from numpy's
    default_rng(seed) over knots 0 .. 400: every window of 20 ticks at
    N = 30 fits the path's 501 knots."""
    return np.random.default_rng(seed).integers(0, TRACKING_TILED_LAST_START + 1, size=batch)


def tracking_tiled_initial_states(ref, starts, *, seed: int = 12, noise: float = 0.05,
                                  dtype=torch.float32, device="cuda") -> torch.Tensor:
    """[B, 4] plant states: each lane's reference start ref.x[s_b] plus
    0.05 N(0, 1) from numpy's default_rng(seed)."""
    xs = np.asarray(ref.x)[starts] + noise * np.random.default_rng(seed).standard_normal(
        (len(starts), 4))
    return torch.as_tensor(xs, dtype=dtype, device=device)


def tracking_tiled_windows(ref, starts, N: int, ticks: int, *, dtype=torch.float32,
                           device="cuda"):
    """Each lane's sliding window and its linear cost rows per tick, as
    bench.py's `_windows` builds the shared ones, lane-minor: x_ref
    [T+1, N+1, n, B] (lane b's window at tick t is ref.x[s_b + t ..
    s_b + t + N]), q = -Q x_ref [T+1, N+1, n, B] and c = 0.5 x_ref'Q x_ref
    (+ 0.5 u'R u of ref.u[0] at the stage knots) [T+1, N+1, B]; formed in
    float64, then cast."""
    idx = (np.asarray(starts)[None, None, :] + np.arange(ticks + 1)[:, None, None]
           + np.arange(N + 1)[None, :, None])  # [T+1, N+1, B]
    xw = np.moveaxis(np.asarray(ref.x)[idx], -1, 2)  # [T+1, N+1, n, B]
    Qd = np.full(4, Q_DIAG)[None, None, :, None]
    qs = -(Qd * xw)
    cs = 0.5 * np.sum(Qd * xw * xw, axis=2)
    cs[:, :N] += 0.5 * float(ref.u[0] @ (np.full(2, R_DIAG) * ref.u[0]))
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(xw, **kw), torch.as_tensor(qs, **kw).contiguous(),
            torch.as_tensor(cs, **kw).contiguous())


def run_tracking_tiled(problem: Problem, ref, starts, x_true0: torch.Tensor, *,
                       ticks: int = 20, opts: Optional[SolverOptions] = None,
                       opts_rescue: Optional[SolverOptions] = None,
                       vmapped: bool = False) -> ClosedLoopResult:
    """A fleet of B bicycle controllers, each tracking the Scotty path from
    its own place (`tracking_tiled_starts`), through the natively batched
    solve: every tick each lane's q and c slide with its own window (one
    row per lane, the per-lane rows of `rollout_grid.cu`'s LANE_COST
    instantiations; Q, R, r and h shared), one warm-started
    `rescue.solve_tiled_with_rescue` (the bench's options and rescue by
    default), u_0 steps each lane's plant and the warm start shifts. The
    warm start is each lane's own window as x and u = (ref.u[s_b][0], 0).
    problem: `scotty_problem(ref)` (its q, c and x0 replaced per tick);
    x_true0 [B, 4] (`tracking_tiled_initial_states`). The tracking error
    after tick t is |x_true - ref.x[s_b + t + 1]| over the whole state, as
    `run_closed_loop`'s. vmapped=True runs each tier through the vmapped solve
    (`parallel.batch.solve_lanes`, the same iterates on the plain paths:
    the row's float64 reference on the card) and merges the tiers as
    `rescue.merge_rescue` does."""
    if opts is None:
        opts, opts_rescue = bench_options()
    N, n, m = problem.N, problem.n, problem.m
    B = x_true0.shape[0]
    dt, dev = problem.dtype, problem.device
    kw = dict(dtype=dt, device=dev)
    xw, qs, cs = tracking_tiled_windows(ref, starts, N, ticks, dtype=dt, device=dev)
    u0 = torch.zeros((B, N, m), **kw)
    u0[:, :, 0] = torch.as_tensor(np.asarray(ref.u)[np.asarray(starts), 0], **kw)[:, None]
    state0 = dataclasses.replace(batch_init_state(problem, B), u=u0,
                                 x=xw[0].permute(2, 0, 1).contiguous())
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    t0 = time.perf_counter()
    st = tsv.state_to_lanes(state0)
    x_true = tsv.batch_to_lanes(x_true0)
    iters = torch.empty((ticks, B), dtype=torch.int32, device=dev)
    errs = torch.empty((ticks, B), **kw)
    statuses = torch.empty((ticks, B), dtype=torch.int32, device=dev)
    rescue_ticks = 0
    h = problem.h[0]
    for t in range(ticks):
        prob_t = dataclasses.replace(
            problem, cost=dataclasses.replace(problem.cost, q=qs[t], c=cs[t]), x0=x_true)
        if vmapped:
            st1, stats = solve_lanes(prob_t, st, opts)
            failed = stats.status != 0
            if opts_rescue is not None and bool(torch.any(failed)):
                st_r, stats_r = solve_lanes(prob_t, st1, opts_rescue)
                st1, stats = rsc.merge_rescue(failed, st1, stats, st_r, stats_r)
                rescue_ticks += 1
            st = st1
        elif opts_rescue is not None:
            info = {}
            st, stats = rsc.solve_tiled_with_rescue(prob_t, st, opts, opts_rescue, info)
            rescue_ticks += int(info["rescued"])
        else:
            st, stats = tsv.solve_tiled(prob_t, st, opts)
        x_true = problem.dynamics(x_true, st.u[0], h, 0)
        st = tsv.shift_trajectory_tiled(st)
        diff = x_true - xw[t + 1, 0]
        errs[t] = torch.sqrt(torch.sum(diff * diff, dim=0))
        iters[t] = stats.iterations
        statuses[t] = stats.status
    x_true_b = tsv.lanes_to_batch(x_true)
    state_b = tsv.state_from_lanes(st)
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    seconds = time.perf_counter() - t0
    return ClosedLoopResult(iters, errs, statuses, rescue_ticks, x_true_b, state_b, seconds)


def per_lane_rows(problem: Problem, B: int, *, seed: int = 31) -> Problem:
    """The problem with every DiagonalCost leaf and h one row per lane
    (lane-minor: Q, q [N+1, n, B], R, r [N+1, m, B], c [N+1, B], h [N, B]):
    a tracking cost (`lqr_cost_from_reference`'s form) of each lane's own
    reference, the problem's own (x_ref = -q / Q, u_ref = -r / R) moved by
    0.05 N(0, 1), with its own weights, the problem's scaled by
    1 + 0.5 U(0, 1), and its own steps h scaled by 1 + 0.1 U(0, 1), from
    numpy's default_rng(seed). The operands of the trial-grid kernel's
    LANE_COST instantiations: every row differs per lane, the terminal one
    included, and the merit keeps the cancellation of the problem's own
    cost. Q and R must be positive."""
    rng = np.random.default_rng(seed)
    cost = problem.cost
    N = problem.N

    def np_(t):
        return t.double().cpu().numpy()

    Q, R, q, r = np_(cost.Q), np_(cost.R), np_(cost.q), np_(cost.r)
    xr = -q / Q
    ur = -r / R
    Qb = Q[..., None] * (1.0 + 0.5 * rng.random(Q.shape + (B,)))
    Rb = R[..., None] * (1.0 + 0.5 * rng.random(R.shape + (B,)))
    xb = xr[..., None] + 0.05 * rng.standard_normal(xr.shape + (B,))
    ub = ur[..., None] + 0.05 * rng.standard_normal(ur.shape + (B,))
    cb = 0.5 * np.sum(Qb * xb * xb, axis=1)
    cb[:N] += 0.5 * np.sum(Rb * ub * ub, axis=1)[:N]
    hb = np_(problem.h)[..., None] * (1.0 + 0.1 * rng.random(problem.h.shape + (B,)))
    kw = dict(dtype=problem.dtype, device=problem.device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), **kw)

    new_cost = DiagonalCost(Q=t(Qb), R=t(Rb), q=t(-Qb * xb), r=t(-Rb * ub), c=t(cb))
    return dataclasses.replace(problem, cost=new_cost, h=t(hb))


def closed_loop_metrics(res: ClosedLoopResult) -> dict:
    """A batched closed loop's numbers (unrounded): success, iterations and
    tracking error over every lane and tick, and its times."""
    T, B = res.iterations.shape
    return {
        "success_rate": float((res.status == 0).double().mean()),
        "mean_iterations": float(res.iterations.double().mean()),
        "mean_tracking_error": float(res.tracking_error.double().mean()),
        "rescue_ticks": res.rescue_ticks,
        "ms_per_tick": 1e3 * res.seconds / T,
        "resolves_per_s": B * T / res.seconds,
    }


# ---------------------------------------------------------------------------
# Quadrotor waypoint MPC (scripts/bench_all.py:322-512, non-tiled branch)
# ---------------------------------------------------------------------------

QUAD_HOVER = 0.5 * 9.81 / 4.0  # per-rotor thrust that holds the 0.5 kg body
QUAD_WAYPOINTS = ((1.0, 0.0, 1.0), (1.0, 1.0, 1.5), (0.0, 1.0, 1.0), (0.0, 0.0, 0.5))


def _quadrotor_q_diag(N: int) -> np.ndarray:
    """Q diag (1, 1, 1, 0.1 x 9) at every knot, the terminal knot x 10."""
    Qd = np.tile(np.concatenate([np.full(3, 1.0), np.full(9, 0.1)]), (N + 1, 1))
    Qd[N] *= 10
    return Qd


def quadrotor_waypoint_problem(N: int = 30, *, dtype=torch.float32, device="cuda") -> Problem:
    """The row's problem: rk4 quadrotor (n=12, m=4), h=0.05, no
    constraints, diagonal tracking cost toward the first waypoint with
    R=1e-2 and u_ref = hover, and the column-form and block-form rk4
    steps that the rollout kernels run; on the card unless `device` says
    otherwise."""
    n, m = 12, 4
    kw = dict(dtype=dtype, device=device)
    xf = np.zeros(n)
    xf[:3] = QUAD_WAYPOINTS[0]
    cost = lqr_cost_from_reference(
        torch.as_tensor(_quadrotor_q_diag(N), **kw), torch.full((N + 1, m), 1e-2, **kw),
        torch.as_tensor(np.tile(xf, (N + 1, 1)), **kw), torch.full((N + 1, m), QUAD_HOVER, **kw))
    return Problem(N=N, n=n, m=m, dynamics=rk4(quadrotor_continuous()), dynamics_jac=None,
                   constraints=(), cost=cost, h=torch.full((N,), 0.05, **kw),
                   x0=torch.zeros(n, **kw), dynamics_cols=rk4_cols(quadrotor_cols()),
                   dynamics_tile=rk4_tile(quadrotor_tile()))


def quadrotor_options() -> SolverOptions:
    """The row's options (`qopts` off the tiled branch): 15 iterations,
    the phase-split x-only grid of width 8 in one block with the
    strong-Wolfe test on its first trial, relative stationarity 1e-5,
    Armijo slack 1e-6, penalty warm start, the dense backward kernel."""
    return SolverOptions(
        iterations_max=15,
        tol_stationarity=1e-3,
        tol_primal_feasibility=1e-3,
        throw_errors=False,
        rti_mode=False,
        use_backtracking_linesearch=True,
        parallel_linesearch=True,
        ls_phase_split=True,
        ls_try_cubic_first=False,
        ls_max_iters=8,
        penalty_warm_start=True,
        ls_armijo_only=False,
        tol_stationarity_rel=1e-5,
        pallas_backward=True,
        ls_armijo_slack=1e-6,
    )


def quadrotor_initial_states(batch: int = 1024, *, seed: int = 1, scale: float = 0.05,
                             dtype=torch.float32, device="cuda") -> torch.Tensor:
    """[B, 12] initial plant states scale * N(0, 1) from a seeded
    torch.Generator (the JAX row draws them from jax.random, which gives
    other numbers for the same seed)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    xs = scale * torch.randn((batch, 12), generator=gen, dtype=torch.float64)
    return xs.to(dtype=dtype, device=device)


@dataclasses.dataclass
class WaypointResult:
    iterations: torch.Tensor  # [T, B] int32
    status: torch.Tensor  # [T, B] int32
    x_true: torch.Tensor  # [B, 12] final plant states
    final_waypoint: tuple  # the waypoint of the last tick
    state: SolverState  # final solver state, batch-major
    seconds: float  # wall time of the run (synchronized on CUDA)

    def metrics(self) -> dict:
        """The row's numbers (scripts/bench_all.py:501-510, unrounded)."""
        T, B = self.iterations.shape
        wp = torch.as_tensor(self.final_waypoint, dtype=torch.float64)
        dist = torch.linalg.norm(self.x_true[:, :3].double().cpu() - wp[None], dim=1)
        return {
            "solves_per_s": B * T / self.seconds,
            "ms_per_tick": 1e3 * self.seconds / T,
            "mean_iterations": float(self.iterations.double().mean()),
            "success_rate": float((self.status == 0).double().mean()),
            "mean_final_waypoint_dist": float(dist.mean()),
        }


def _waypoint_costs(problem: Problem, ticks: int, switch_every: int):
    """The waypoints' linear cost rows (q [4, N+1, n], c [4, N+1], shared
    by all lanes) and the waypoint index of each tick."""
    N, n, m = problem.N, problem.n, problem.m
    dt, dev = problem.dtype, problem.device
    wps = np.zeros((len(QUAD_WAYPOINTS), n))
    wps[:, :3] = QUAD_WAYPOINTS
    Qd = _quadrotor_q_diag(N)
    q_wp = torch.as_tensor(-(Qd[None] * wps[:, None]), dtype=dt, device=dev)
    c_wp = 0.5 * np.sum(Qd[None] * wps[:, None] ** 2, axis=2)
    c_wp[:, :N] += 0.5 * float(np.full(m, QUAD_HOVER) @ (np.full(m, 1e-2) * np.full(m, QUAD_HOVER)))
    c_wp = torch.as_tensor(c_wp, dtype=dt, device=dev)
    wp_idx = [(t // switch_every) % len(QUAD_WAYPOINTS) for t in range(ticks)]
    return q_wp, c_wp, wp_idx


def _lanes_closed_loop(problem: Problem, x_true0: torch.Tensor, ticks: int, state0: SolverState,
                      solve_lanes_fn, cost_at=None, observe=None):
    """The batched closed loop of the rows: each tick `solve_lanes_fn(prob_t,
    st)` on the lane-minor state from the plant states (prob_t's cost
    `cost_at(t)` when given), u_0 through the plant (the problem's own
    dynamics), `observe(t, x_true)` (lane-minor, when given), the shift.
    state0 is batch-major. Returns (iterations
    [T, B], statuses [T, B], final plant states [B, n], final state
    batch-major, wall seconds, synchronized on CUDA)."""
    B, dev = x_true0.shape[0], problem.device
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    t0 = time.perf_counter()
    st = tsv.state_to_lanes(state0)
    x_true = tsv.batch_to_lanes(x_true0)
    iters = torch.empty((ticks, B), dtype=torch.int32, device=dev)
    statuses = torch.empty((ticks, B), dtype=torch.int32, device=dev)
    h = problem.h[0]
    for t in range(ticks):
        prob_t = dataclasses.replace(problem, x0=x_true)
        if cost_at is not None:
            prob_t = dataclasses.replace(prob_t, cost=cost_at(t))
        st, stats = solve_lanes_fn(prob_t, st)
        x_true = problem.dynamics(x_true, st.u[0], h, 0)
        if observe is not None:
            observe(t, x_true)
        st = tsv.shift_trajectory_tiled(st)
        iters[t] = stats.iterations
        statuses[t] = stats.status
    x_true_b = tsv.lanes_to_batch(x_true)
    state_b = tsv.state_from_lanes(st)
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    return iters, statuses, x_true_b, state_b, time.perf_counter() - t0


def _waypoint_loop(problem: Problem, x_true0: torch.Tensor, ticks: int, switch_every: int,
                   state0: Optional[SolverState], solve_lanes_fn) -> WaypointResult:
    """The batched waypoint loop: `_lanes_closed_loop` with the waypoint's
    cost rows each tick, through the rk4 plant."""
    N, m, B = problem.N, problem.m, x_true0.shape[0]
    q_wp, c_wp, wp_idx = _waypoint_costs(problem, ticks, switch_every)
    if state0 is None:
        state0 = dataclasses.replace(batch_init_state(problem, B), u=torch.full(
            (B, N, m), QUAD_HOVER, dtype=problem.dtype, device=problem.device))
    out = _lanes_closed_loop(problem, x_true0, ticks, state0, solve_lanes_fn, lambda t: (
        dataclasses.replace(problem.cost, q=q_wp[wp_idx[t]], c=c_wp[wp_idx[t]])))
    iters, statuses, x_true, state, seconds = out
    return WaypointResult(iters, statuses, x_true, QUAD_WAYPOINTS[wp_idx[-1]], state, seconds)


def run_quadrotor_waypoints(problem: Problem, x_true0: torch.Tensor, *, ticks: int = 100,
                            opts: Optional[SolverOptions] = None, switch_every: int = 25,
                            state0: Optional[SolverState] = None,
                            layer_seconds: Optional[dict] = None) -> WaypointResult:
    """Closed-loop waypoint MPC: each tick every lane solves (the vmapped
    solve), applies u_0 through the rk4 plant and shifts its warm start;
    the waypoint's cost rows (shared by all lanes) switch every
    `switch_every` ticks. problem: from `quadrotor_waypoint_problem`;
    x_true0 [B, 12]; opts default `quadrotor_options()`; state0
    (batch-major) defaults to the cold start with the inputs at hover.
    The lanes stay lane-minor for the whole run. layer_seconds: a dict
    that accumulates the solves' host seconds by layer
    (`tile_solver.lane_loop`)."""
    opts = quadrotor_options() if opts is None else opts
    return _waypoint_loop(problem, x_true0, ticks, switch_every, state0,
                          lambda prob, st: solve_lanes(prob, st, opts, layer_seconds))


def quadrotor_tiled_options() -> SolverOptions:
    """The tiled row's options (bench_all.py:371-398 with the tiled
    branch on): `quadrotor_options()` with the Armijo-only grid that
    `solve_tiled` runs and the trial-grid kernel (`pallas_rollout_tiled`);
    `pallas_backward` is not read there."""
    return quadrotor_options().replace(ls_armijo_only=True, pallas_rollout_tiled=True)


def run_quadrotor_waypoints_tiled(problem: Problem, x_true0: torch.Tensor, *,
                                  ticks: int = 100, opts: Optional[SolverOptions] = None,
                                  switch_every: int = 25,
                                  state0: Optional[SolverState] = None,
                                  layer_seconds: Optional[dict] = None) -> WaypointResult:
    """The waypoint loop of `run_quadrotor_waypoints` through
    `tile_solver.solve_tiled` (bench_all.py:433-472): the waypoint's q and
    c shared by every lane, u_0 through the rk4 plant,
    `shift_trajectory_tiled`. On CUDA tensors the batched backward and the
    trial-grid kernels run, or the solve is refused before it starts. On
    every device and dtype, `run_quadrotor_waypoints` with these options
    and `pallas_backward=False` takes the same steps on the plain paths.
    opts default `quadrotor_tiled_options()`; layer_seconds as there."""
    opts = quadrotor_tiled_options() if opts is None else opts
    return _waypoint_loop(problem, x_true0, ticks, switch_every, state0,
                          lambda prob, st: tsv.solve_tiled(prob, st, opts, layer_seconds))


def quadrotor_latency_options() -> SolverOptions:
    """The latency row's options (bench_all.py:527-530): the tiled row's
    search (`quadrotor_options()` with the Armijo-only grid) on the
    single-lane backward kernel (`pallas_latency_backward`) and the
    trial-rollout kernel (`pallas_rollout`), without `pallas_backward`."""
    return quadrotor_options().replace(pallas_backward=False, ls_armijo_only=True,
                                       pallas_latency_backward=True)


def run_quadrotor_latency(problem: Problem, x_true0: torch.Tensor, *, ticks: int = 100,
                          opts: Optional[SolverOptions] = None, switch_every: int = 25,
                          state0: Optional[SolverState] = None,
                          layer_seconds: Optional[dict] = None) -> WaypointResult:
    """One quadrotor through the waypoints, one `solver.solve` a tick
    (bench_all.py:535-556): solve warm, apply u_0 through the rk4 plant,
    `shift_trajectory`. x_true0 [12] (the row takes
    `quadrotor_initial_states(1024, seed=1)[0]`); state0 (one lane)
    defaults to the cold start with the inputs at hover; opts default
    `quadrotor_latency_options()`. Returns a WaypointResult with one lane
    (iterations and status [T, 1], x_true [1, 12]) whose `state` is the
    final one-lane state."""
    opts = quadrotor_latency_options() if opts is None else opts
    N, m = problem.N, problem.m
    q_wp, c_wp, wp_idx = _waypoint_costs(problem, ticks, switch_every)
    if state0 is None:
        state0 = dataclasses.replace(init_state(problem), u=torch.full(
            (N, m), QUAD_HOVER, dtype=problem.dtype, device=problem.device))
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    t0 = time.perf_counter()
    st, x_true = state0, x_true0
    iters, statuses = [], []
    h = problem.h[0]
    for t in range(ticks):
        w = wp_idx[t]
        prob_t = dataclasses.replace(
            problem, cost=dataclasses.replace(problem.cost, q=q_wp[w], c=c_wp[w]), x0=x_true)
        st, stats = solve(prob_t, st, opts, layer_seconds)
        x_true = problem.dynamics(x_true, st.u[0], h, 0)
        st = shift_trajectory(st)
        iters.append(stats.iterations)
        statuses.append(stats.status)
    iters = torch.stack(iters).to(torch.int32)[:, None]
    statuses = torch.stack(statuses).to(torch.int32)[:, None]
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    seconds = time.perf_counter() - t0
    return WaypointResult(iters, statuses, x_true[None], QUAD_WAYPOINTS[wp_idx[-1]], st,
                          seconds)


# ---------------------------------------------------------------------------
# Pendulum swing-up MPC (scripts/bench_all.py:845-980)
# ---------------------------------------------------------------------------

PEND_TORQUE = 6.0  # |u| <= 6
PEND_H = 0.06


def _torque_fn(x, u, k):
    return torch.cat([u - PEND_TORQUE, -PEND_TORQUE - u])


def pendulum_swingup_problem(N: int = 30, *, dtype=torch.float32, device="cuda") -> Problem:
    """The row's problem: the pendulum (n=2, m=1) under the midpoint, h =
    0.06, toward x = (pi, 0) with Q = 0.1 (terminal x 100) and R = 1e-3,
    the torque bound |u| <= 6 as one affine diagonal-Hessian
    NEGATIVE_ORTHANT group of two rows (its constant Jacobian given),
    inactive at the terminal knot, and the column-form step the
    trial-grid kernel runs; on the card unless `device` says otherwise."""
    n, m = 2, 1
    kw = dict(dtype=dtype, device=device)
    Qd = np.tile(np.full(n, 1e-1), (N + 1, 1))
    Qd[N] *= 100.0
    cost = lqr_cost_from_reference(
        torch.as_tensor(Qd, **kw), torch.full((N + 1, m), 1e-3, **kw),
        torch.as_tensor(np.tile([math.pi, 0.0], (N + 1, 1)), **kw), torch.zeros((N + 1, m), **kw))
    active = torch.ones(N + 1, dtype=torch.bool, device=device)
    active[N] = False
    J = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], **kw)
    torque = ConstraintSpec(fn=_torque_fn, cone=Cone.NEGATIVE_ORTHANT, dim=2, active=active,
                            jac=_constant_jacobian(J), label="torque bound", diag_hessian=True,
                            affine=True)
    return Problem(N=N, n=n, m=m, dynamics=midpoint(pendulum_continuous()), dynamics_jac=None,
                   constraints=(torque,), cost=cost, h=torch.full((N,), PEND_H, **kw),
                   x0=torch.zeros(n, **kw), dynamics_cols=midpoint_cols(pendulum_cols()))


def pendulum_swingup_options() -> SolverOptions:
    """The row's options (`f32opts` with bench_all.py:895-902): 10
    iterations, tolerances 1e-3, penalty warm start, the phase-split x-only
    Armijo-only grid of width 8 in one block, line-search failure recovery
    with no failures allowed, the best-decrease fallback, the trial-grid
    kernel (`pallas_rollout_tiled`, the default)."""
    return SolverOptions(
        iterations_max=10, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True, penalty_warm_start=True,
        parallel_linesearch=True, ls_phase_split=True, ls_try_cubic_first=False,
        ls_armijo_only=True, ls_max_iters=8, ls_failure_recovery=True,
        ls_recovery_max_fails=0, ls_best_decrease_fallback=True)


def pendulum_initial_states(batch: int = 1024, *, seed: int = 3, scale: float = 0.05,
                            dtype=torch.float32, device="cuda") -> torch.Tensor:
    """[B, 2] initial plant states scale * N(0, 1) near hanging down, from
    numpy's default_rng(seed) (the JAX row draws them from jax.random)."""
    xs = scale * np.random.default_rng(seed).standard_normal((batch, 2))
    return torch.as_tensor(xs, dtype=dtype, device=device)


@dataclasses.dataclass
class SwingupResult:
    iterations: torch.Tensor  # [T, B] int32
    status: torch.Tensor  # [T, B] int32
    x_true: torch.Tensor  # [B, 2] final plant states
    state: SolverState  # final solver state, batch-major
    seconds: float  # wall time of the run (synchronized on CUDA)

    def up_error(self) -> torch.Tensor:
        """[B] distance from upright, sqrt((theta mod 2 pi - pi)^2 + 0.1
        omega^2), in float64 (bench_all.py:960-962)."""
        x = self.x_true.double().cpu()
        return torch.sqrt((torch.remainder(x[:, 0], 2 * math.pi) - math.pi) ** 2
                          + 0.1 * x[:, 1] ** 2)

    def metrics(self) -> dict:
        """The row's numbers (bench_all.py:963-978, unrounded)."""
        T, B = self.iterations.shape
        up = self.up_error()
        return {
            "solves_per_s": B * T / self.seconds,
            "ms_per_tick": 1e3 * self.seconds / T,
            "success_rate": float((self.status == 0).double().mean()),
            "mean_iterations": float(self.iterations.double().mean()),
            "swingup_rate": float((up < 0.3).double().mean()),
            "mean_up_error": float(up.mean()),
        }


def _swingup_loop(problem: Problem, x_true0: torch.Tensor, ticks: int,
                  state0: Optional[SolverState], solve_lanes_fn) -> SwingupResult:
    """The batched swing-up loop: `_lanes_closed_loop` through the midpoint
    plant, from u = 0.1 unless state0 says otherwise."""
    N, m, B = problem.N, problem.m, x_true0.shape[0]
    if state0 is None:
        state0 = dataclasses.replace(batch_init_state(problem, B), u=torch.full(
            (B, N, m), 0.1, dtype=problem.dtype, device=problem.device))
    return SwingupResult(*_lanes_closed_loop(problem, x_true0, ticks, state0, solve_lanes_fn))


def run_pendulum_swingup_tiled(problem: Problem, x_true0: torch.Tensor, *, ticks: int = 80,
                               opts: Optional[SolverOptions] = None,
                               state0: Optional[SolverState] = None,
                               layer_seconds: Optional[dict] = None) -> SwingupResult:
    """Closed-loop swing-up MPC through `tile_solver.solve_tiled`
    (bench_all.py:918-935): each tick every lane solves warm from its
    plant state, applies u_0 through the midpoint plant and shifts its
    warm start (`shift_trajectory_tiled`). problem: from
    `pendulum_swingup_problem`; x_true0 [B, 2]; opts default
    `pendulum_swingup_options()`; state0 (batch-major) defaults to the
    cold start with u = 0.1. On CUDA tensors the batched backward and the
    trial-grid kernels run, or the solve is refused before it starts; on
    every device and dtype `run_pendulum_swingup` with these options takes
    the same steps on the plain paths. layer_seconds: as
    `tile_solver.lane_loop`'s."""
    opts = pendulum_swingup_options() if opts is None else opts
    return _swingup_loop(problem, x_true0, ticks, state0,
                         lambda prob, st: tsv.solve_tiled(prob, st, opts, layer_seconds))


def run_pendulum_swingup(problem: Problem, x_true0: torch.Tensor, *, ticks: int = 80,
                         opts: Optional[SolverOptions] = None,
                         state0: Optional[SolverState] = None,
                         layer_seconds: Optional[dict] = None) -> SwingupResult:
    """The loop of `run_pendulum_swingup_tiled` through the vmapped solve
    (`parallel.batch.solve_lanes`, bench_all.py:937-947): with the row's
    options (the default) the plain backward and the plain grid, the
    row's float64 reference on any device."""
    opts = pendulum_swingup_options() if opts is None else opts
    return _swingup_loop(problem, x_true0, ticks, state0,
                         lambda prob, st: solve_lanes(prob, st, opts, layer_seconds))


# ---------------------------------------------------------------------------
# Rocket SOC landing (scripts/bench_all.py:732-843)
# ---------------------------------------------------------------------------


def rocket_soc_options() -> SolverOptions:
    """The row's options (`r_opts`, bench_all.py:767-773): 120 iterations,
    penalty 10 scaled by 10, tolerances 1e-3 with relative stationarity
    1e-5, Armijo slack 1e-6, the phase-split x-only Armijo-only grid. The
    trial-grid kernel takes no SOC group, so `pallas_rollout_tiled` is off
    (JAX falls back to its scan grid by itself, altro_tpu/tile_solver.py:
    329-342; the port refuses instead, so the row asks for the plain grid)."""
    return SolverOptions(
        iterations_max=120, penalty_initial=10.0, penalty_scaling=10.0,
        tol_stationarity=1e-3, tol_primal_feasibility=1e-3, tol_stationarity_rel=1e-5,
        ls_armijo_slack=1e-6, use_backtracking_linesearch=True, parallel_linesearch=True,
        ls_phase_split=True, ls_grid_x_only=True, ls_armijo_only=True, throw_errors=False,
        pallas_rollout_tiled=False)


def rocket_initial_states(problem: Problem, batch: int = 1024, *, seed: int = 0) -> torch.Tensor:
    """[B, 6] initial states: the problem's x0 plus 2 N(0, 1) on the position
    and 0.5 N(0, 1) on the velocity, from numpy's default_rng(seed) (the
    JAX row draws them from jax.random), in the problem's dtype and device."""
    rng = np.random.default_rng(seed)
    noise = np.concatenate([2.0 * rng.standard_normal((batch, 3)),
                            0.5 * rng.standard_normal((batch, 3))], axis=1)
    base = problem.x0.double().cpu().numpy()
    return torch.as_tensor(base[None] + noise, dtype=problem.dtype, device=problem.device)


@dataclasses.dataclass
class RocketResult:
    status: torch.Tensor  # [B] int32
    iterations: torch.Tensor  # [B] int32
    state: SolverState  # the solved state, batch-major (x [B, N+1, 6])
    seconds: float  # wall time of the solve (synchronized on CUDA)

    def touchdown(self) -> torch.Tensor:
        """[B] distance of x_N's position from the pad, float64."""
        return torch.linalg.norm(self.state.x[:, -1, :3].double().cpu(), dim=1)

    def metrics(self) -> dict:
        """The row's numbers (bench_all.py:827-837, unrounded)."""
        B = self.status.shape[0]
        return {
            "solves_per_s": B / self.seconds,
            "success_rate": float((self.status == 0).double().mean()),
            "mean_iterations": float(self.iterations.double().mean()),
            "mean_touchdown_m": float(self.touchdown().mean()),
        }


def _rocket_solve(problem: Problem, hover: torch.Tensor, x0s: torch.Tensor,
                  solve_lanes_fn) -> RocketResult:
    B = x0s.shape[0]
    state = dataclasses.replace(batch_init_state(problem, B),
                                u=hover.expand(B, problem.N, problem.m).contiguous())
    if x0s.is_cuda:
        torch.cuda.synchronize(x0s.device)
    t0 = time.perf_counter()
    st, stats = solve_lanes_fn(dataclasses.replace(problem, x0=tsv.batch_to_lanes(x0s)),
                               tsv.state_to_lanes(state))
    state_b = tsv.state_from_lanes(st)
    if x0s.is_cuda:
        torch.cuda.synchronize(x0s.device)
    return RocketResult(stats.status, stats.iterations, state_b, time.perf_counter() - t0)


def run_rocket_soc_tiled(problem: Problem, hover: torch.Tensor, x0s: torch.Tensor, *,
                         opts: Optional[SolverOptions] = None,
                         layer_seconds: Optional[dict] = None) -> RocketResult:
    """One batched solve of the rocket landings from x0s [B, 6] through
    `tile_solver.solve_tiled` (bench_all.py:798-813), each lane cold with
    u = hover. problem, hover: from `reference_problems.rocket_landing_
    problem`; opts default `rocket_soc_options()`. On CUDA tensors the
    batched backward runs at (6, 3) on dense expansions (lux included),
    or the solve is refused before it starts (the trial-grid kernel with
    `pallas_rollout_tiled`: the rocket has no column step and SOC groups).
    layer_seconds: as `tile_solver.lane_loop`'s."""
    opts = rocket_soc_options() if opts is None else opts
    return _rocket_solve(problem, hover, x0s,
                         lambda prob, st: tsv.solve_tiled(prob, st, opts, layer_seconds))


def run_rocket_soc(problem: Problem, hover: torch.Tensor, x0s: torch.Tensor, *,
                   opts: Optional[SolverOptions] = None,
                   layer_seconds: Optional[dict] = None) -> RocketResult:
    """The solve of `run_rocket_soc_tiled` through the vmapped solve
    (`parallel.batch.solve_lanes`, bench_all.py:775-791): with the row's
    options (the default) the plain backward and the plain grid, the same
    steps as `solve_tiled`'s, the row's float64 reference on any device."""
    opts = rocket_soc_options() if opts is None else opts
    return _rocket_solve(problem, hover, x0s,
                         lambda prob, st: solve_lanes(prob, st, opts, layer_seconds))


# ---------------------------------------------------------------------------
# Batched tracking MPC (examples/batched_mpc.py)
# ---------------------------------------------------------------------------


def batched_tracking_problem(*, dtype=torch.float32, device="cuda") -> Problem:
    """examples/batched_mpc.py's problem, the reference's Scotty problem
    (`scotty_reference_problem`) at N = 30: the kinematic bicycle with
    midpoint integration, the diagonal tracking cost (Q = 1e-2,
    R = 1e-3) on the first reference window, and the steering bound
    |delta| <= 60 deg with its constant Jacobian given and no
    diagonal-Hessian declaration, so the expansions are dense, as the
    example's are; on the card unless `device` says otherwise."""
    return scotty_reference_problem(load_scotty(), 30, dtype=dtype, device=device)[0]


def batched_tracking_options(pallas_backward: bool = True) -> SolverOptions:
    """The example's options: 10 iterations, the sequential backtracking
    search (cubic-first, the solver's default), stationarity and
    feasibility 1e-3; with `pallas_backward` (the default here; the
    example leaves it off) the dense backward kernel on the card and its
    plain version on the CPU."""
    return SolverOptions(iterations_max=10, use_backtracking_linesearch=True,
                         tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
                         throw_errors=False, pallas_backward=pallas_backward)


def batched_tracking_initial_states(batch: int, *, dtype=torch.float32,
                                    device="cuda") -> torch.Tensor:
    """[B, 4] plant states: the Scotty path's start plus 0.05 N(0, 1) from
    numpy's default_rng(0) (the example draws them from
    jax.random.PRNGKey(0), which gives other numbers)."""
    x_start = load_scotty().x[0]
    noise = np.random.default_rng(0).standard_normal((batch, x_start.shape[0]))
    return torch.as_tensor(x_start[None] + 0.05 * noise, dtype=dtype, device=device)


@dataclasses.dataclass
class BatchedTrackingResult:
    iterations: torch.Tensor  # [T, B] int32
    status: torch.Tensor  # [T, B] int32
    trials: torch.Tensor  # [T, B] merit evaluations of each lane's searches per solve
    passes: list  # [T] the per-lane machine's loop passes per tick (every lane pays them)
    syncs: list  # [T] host reads per tick
    x_true: torch.Tensor  # [B, 4] final plant states
    final_ref: np.ndarray  # [4] the reference point the example measures against
    state: SolverState  # final solver state, batch-major
    seconds: float  # wall time of the run (synchronized on CUDA)

    def metrics(self) -> dict:
        """The example's numbers (unrounded) and the searches' counts."""
        T, B = self.iterations.shape
        err = torch.linalg.norm(self.x_true[:, :2].double().cpu()
                                - torch.as_tensor(self.final_ref[:2])[None], dim=1)
        trials = self.trials.double()
        return {
            "resolves_per_s": B * T / self.seconds,
            "ms_per_tick": 1e3 * self.seconds / T,
            "mean_iterations": float(self.iterations.double().mean()),
            "last_tick_mean_iterations": float(self.iterations[-1].double().mean()),
            "success_rate": float((self.status == 0).double().mean()),
            "mean_final_tracking_error": float(err.mean()),
            "max_final_tracking_error": float(err.max()),
            "trials_per_solve_mean": float(trials.mean()),
            "trials_per_solve_max": int(trials.max()),
            "passes_per_tick": sum(self.passes) / T,
            "syncs_per_tick": sum(self.syncs) / T,
        }


def run_batched_tracking(problem: Problem, x_true0: torch.Tensor, *, ticks: int = 20,
                         opts: Optional[SolverOptions] = None,
                         layer_seconds: Optional[dict] = None) -> BatchedTrackingResult:
    """examples/batched_mpc.py's closed loop on the Scotty path: each tick
    every lane gets the sliding window's linear cost rows (q = -Q x_ref,
    c = 0.5 x_ref'Q x_ref over ref.x[t : t + N + 1], formed in the
    problem's dtype and given per lane), one warm-started resolve per lane
    through `parallel.batch.batched_tracking_solver`, u_0 steps each
    lane's plant (the problem's own dynamics), and `shift_trajectory`
    shifts the warm start, which begins as the example's (x the reference
    window, u = (u_ref[0][0], 0)). problem: `batched_tracking_problem()`;
    x_true0 [B, 4] (`batched_tracking_initial_states`); opts default
    `batched_tracking_options()`. The final tracking error is
    |x_true[:2] - ref.x[ticks][:2]|, the example's. layer_seconds: as
    `tile_solver.lane_loop`'s."""
    opts = batched_tracking_options() if opts is None else opts
    ref = load_scotty()
    N, n, m = problem.N, problem.n, problem.m
    B = x_true0.shape[0]
    kw = dict(dtype=problem.dtype, device=problem.device)
    u0 = torch.tensor([ref.u[0][0], 0.0], **kw)
    state0 = dataclasses.replace(
        batch_init_state(problem, B), u=u0.expand(B, N, m).contiguous(),
        x=torch.as_tensor(ref.x[: N + 1], **kw).expand(B, N + 1, n).contiguous())
    Qd = torch.full((n,), Q_DIAG, **kw)
    windows = torch.as_tensor(np.stack([ref.x[t: t + N + 1] for t in range(ticks)]), **kw)
    qs = -(Qd * windows)
    cs = 0.5 * torch.sum(Qd * windows * windows, dim=2)
    trace = Trace(layer_seconds)
    runner = batched_tracking_solver(problem, opts, trace=trace)
    h = problem.h[0]
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    t0 = time.perf_counter()
    st, x_true = state0, x_true0
    iters = torch.empty((ticks, B), dtype=torch.int32, device=problem.device)
    statuses = torch.empty_like(iters)
    trials = torch.empty_like(iters)
    passes, syncs = [], []
    for t in range(ticks):
        u_first, st, stats = runner(x_true, qs[t].expand(B, N + 1, n), cs[t].expand(B, N + 1), st)
        x_true = problem.dynamics(x_true.T, u_first.T, h, 0).T
        st = dataclasses.replace(st, x=torch.cat([st.x[:, 1:], st.x[:, -1:]], dim=1),
                                 u=torch.cat([st.u[:, 1:], st.u[:, -1:]], dim=1))
        iters[t] = stats.iterations
        statuses[t] = stats.status
        trials[t] = trace.counts.pop("trials", 0)
        passes.append(trace.counts.pop("passes", 0))
        syncs.append(trace.counts.pop("syncs", 0))
    if x_true0.is_cuda:
        torch.cuda.synchronize(x_true0.device)
    seconds = time.perf_counter() - t0
    return BatchedTrackingResult(iters, statuses, trials, passes, syncs, x_true,
                                 np.asarray(ref.x[ticks]), st, seconds)


# ---------------------------------------------------------------------------
# Single-lane rows: the rocket landing, the cart-pole swing-up and the
# single-lane rows of scripts/bench_all.py (:100-209)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SingleSolveResult:
    state: SolverState  # the solved state, one lane
    stats: SolveStats
    seconds: float  # wall time of the solve (synchronized on CUDA)

    def metrics(self) -> dict:
        """Status, iterations, the solve's own measures and x_N, unrounded."""
        s = self.stats
        return {"status": int(s.status), "iterations": int(s.iterations),
                "ls_iterations": int(s.ls_iterations),
                "objective": float(s.objective_value), "stationarity": float(s.stationarity),
                "primal_feasibility": float(s.primal_feasibility),
                "x_N": self.state.x[-1].double().cpu().tolist(),
                "finite": bool(torch.isfinite(self.state.x).all()
                               and torch.isfinite(self.state.u).all()),
                "ms_per_solve": 1e3 * self.seconds}


def run_single_solve(problem: Problem, state: SolverState, opts: SolverOptions,
                     layer_seconds: Optional[dict] = None) -> SingleSolveResult:
    """One `solver.solve`, timed (synchronized on CUDA)."""
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)
    t0 = time.perf_counter()
    st, stats = solve(problem, state, opts, layer_seconds)
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)
    return SingleSolveResult(st, stats, time.perf_counter() - t0)


def rocket_landing_options(dtype=torch.float32) -> SolverOptions:
    """examples/rocket_landing.py's options (:135-140): 120 iterations,
    penalty 10 scaled by 10, the reference's tolerance 1e-4 in float64 and
    the bench's 1e-3 in float32, relative stationarity 1e-5, the
    sequential backtracking."""
    tol = 1e-4 if dtype == torch.float64 else 1e-3
    return SolverOptions(iterations_max=120, penalty_initial=10.0, penalty_scaling=10.0,
                         tol_stationarity=tol, tol_primal_feasibility=tol,
                         tol_stationarity_rel=1e-5, use_backtracking_linesearch=True,
                         throw_errors=False)


def rocket_metrics(res: SingleSolveResult, *, theta_max_deg: float = 25.0,
                   gamma_deg: float = 45.0, u_max: float = 20.0, u_min: float = 2.0) -> dict:
    """The example's numbers (:151-158) for `reference_problems.
    rocket_landing_problem`'s defaults: |r_N|, |v_N|, the largest thrust
    ball ratio ||u|| / u_max and pointing ratio ||(ux, uy)|| / (tan(theta)
    uz), and the largest excess over any cone (pointing, ball, min thrust,
    glide slope; tests/test_rocket.py holds it to 1e-4)."""
    x = res.state.x.double().cpu()
    u = res.state.u.double().cpu()
    tan_th = math.tan(math.radians(theta_max_deg))
    tan_ga = math.tan(math.radians(gamma_deg))
    uxy = torch.linalg.norm(u[:, :2], dim=1)
    excess = torch.cat([uxy - tan_th * u[:, 2], torch.linalg.norm(u, dim=1) - u_max,
                        u_min - u[:, 2], torch.linalg.norm(x[:, :2], dim=1) - tan_ga * x[:, 2]])
    return {**res.metrics(), "r_N": float(torch.linalg.norm(x[-1, :3])),
            "v_N": float(torch.linalg.norm(x[-1, 3:])),
            "max_thrust_ratio": float((torch.linalg.norm(u, dim=1) / u_max).max()),
            "max_pointing_ratio": float((uxy / (tan_th * u[:, 2])).max()),
            "max_cone_excess": float(excess.max())}


def run_rocket_landing(problem: Problem, hover: torch.Tensor,
                       opts: Optional[SolverOptions] = None,
                       layer_seconds: Optional[dict] = None) -> SingleSolveResult:
    """examples/rocket_landing.py's solve (:142-149): one `solver.solve`
    from the cold start with u = hover. problem, hover: from
    `reference_problems.rocket_landing_problem`; opts default
    `rocket_landing_options(problem.dtype)`. On CUDA tensors in float32 the
    backward runs on riccati_latency.cu at (6, 3) (dense expansions with
    lux: the SOC groups have no diagonal Hessian). `rocket_metrics` reads
    the result."""
    opts = rocket_landing_options(problem.dtype) if opts is None else opts
    st = dataclasses.replace(init_state(problem),
                             u=hover.expand(problem.N, problem.m).contiguous())
    return run_single_solve(problem, st, opts, layer_seconds)


def cartpole_swingup_options(iterations_max: int = 300) -> SolverOptions:
    """The cart-pole oracle's options (tests/test_models_extra.py:63-66):
    300 iterations, the sequential backtracking, every other option at its
    default."""
    return SolverOptions(iterations_max=iterations_max, use_backtracking_linesearch=True)


def run_cartpole_swingup(problem: Problem, state: SolverState,
                         opts: Optional[SolverOptions] = None,
                         layer_seconds: Optional[dict] = None) -> SingleSolveResult:
    """The cart-pole swing-up: one `solver.solve`. problem, state: from
    `reference_problems.cartpole_swingup_problem`; opts default
    `cartpole_swingup_options()`. On CUDA tensors in float32 the backward
    runs on riccati_latency.cu at (4, 1) (diagonal expansions). The oracle
    reads x_N: |theta_N - pi| < 0.05, |x_N| < 0.1."""
    opts = cartpole_swingup_options() if opts is None else opts
    return run_single_solve(problem, state, opts, layer_seconds)


def baseline_f32_options() -> SolverOptions:
    """scripts/bench_all.py's `f32opts` (:47-50): 30 iterations, tolerances
    1e-3, the default strong-Wolfe search."""
    return SolverOptions(iterations_max=30, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
                         throw_errors=False)


def double_integrator_goal_options() -> SolverOptions:
    """`double_integrator_goal_N100`'s options (bench_all.py:117-118):
    `f32opts` with penalty_scaling 100."""
    return baseline_f32_options().replace(penalty_scaling=100.0)


def run_double_integrator_goal(problem: Problem, state: SolverState,
                               opts: Optional[SolverOptions] = None,
                               layer_seconds: Optional[dict] = None) -> SingleSolveResult:
    """`double_integrator_goal_N100`: one `solver.solve` of
    `reference_problems.double_integrator_goal_problem` (on CUDA in
    float32, riccati_latency.cu at (4, 2), dense expansions with lux: the
    ZERO goal has no diagonal Hessian); opts default
    `double_integrator_goal_options()`."""
    opts = double_integrator_goal_options() if opts is None else opts
    return run_single_solve(problem, state, opts, layer_seconds)


def run_pendulum_bounded(problem: Problem, state: SolverState,
                         opts: Optional[SolverOptions] = None,
                         layer_seconds: Optional[dict] = None) -> SingleSolveResult:
    """`pendulum_swingup_bounded`: one `solver.solve` of
    `reference_problems.pendulum_bounded_problem` (on CUDA in float32,
    riccati_latency.cu at (2, 1), dense expansions with lux); opts default
    `baseline_f32_options()`, the row's (bench_all.py:141)."""
    opts = baseline_f32_options() if opts is None else opts
    return run_single_solve(problem, state, opts, layer_seconds)


def bicycle_window_options() -> SolverOptions:
    """`bicycle_scotty_window_N30`'s options (bench_all.py:183-206 at
    N=30): `f32opts` with the sequential backtracking, cubic first, 25
    trials, no grid (parallel_linesearch off, so the trial-rollout grid is
    not run)."""
    return baseline_f32_options().replace(
        use_backtracking_linesearch=True, iterations_max=30, symmetrize_ctg=False,
        parallel_linesearch=False, ls_phase_split=False, ls_try_cubic_first=True,
        ls_armijo_only=False, ls_max_iters=25)


def run_bicycle_window(problem: Problem, state: SolverState,
                       opts: Optional[SolverOptions] = None,
                       layer_seconds: Optional[dict] = None) -> SingleSolveResult:
    """`bicycle_scotty_window_N30`: one `solver.solve` of the Scotty window
    (`scotty_reference_problem(ref, N=30)`: the row's model, cost, steering
    bound and warm start; on CUDA in float32 riccati_latency.cu at (4, 2),
    dense expansions with lux); opts default `bicycle_window_options()`."""
    opts = bicycle_window_options() if opts is None else opts
    return run_single_solve(problem, state, opts, layer_seconds)


class ExampleResult(NamedTuple):
    status: int
    iterations: int
    objective: float
    x_N: list
    ms: float  # the facade's solve time (the device synchronised)


def run_pendulum_example(dtype=torch.float32, device="cuda") -> ExampleResult:
    """examples/pendulum_swingup.py's `main`: one solve of the example's
    facade, the pendulum swing-up (midpoint, N=50, tf=3), Q = 1e-2 (1 at
    the terminal knot), R = 1e-3, 20 iterations, u = 0.1, printing at
    Verbosity.INNER. Returns status, iterations, objective, x_N and the
    solve's ms."""
    from altro_tpu_torch.api import ALTROSolver

    N, n, m = 50, 2, 1
    xf = np.array([np.pi, 0.0])
    solver = ALTROSolver(N, dtype=dtype, device=device)
    solver.set_dimension(n, m)
    solver.set_time_step(3.0 / N)
    solver.set_explicit_dynamics(midpoint(pendulum_continuous()))
    solver.set_lqr_cost(np.full(n, 1e-2), np.full(m, 1e-3), xf, np.zeros(m), 0, N)
    solver.set_lqr_cost(np.ones(n), np.full(m, 1e-3), xf, np.zeros(m), N)
    solver.set_initial_state(np.zeros(n))
    solver.set_options(SolverOptions(iterations_max=20, verbose=Verbosity.INNER))
    solver.initialize()
    solver.set_input([0.1])
    status = solver.solve()
    return ExampleResult(int(status), solver.get_iterations(), solver.get_final_objective(),
                         solver.get_state(solver.N).tolist(), solver.get_solve_time_ms())


BLOCK_STEP_N = 30
U_MAX = 6.0


def pendulum_block_step_solver(with_tile: bool, dtype=torch.float32, device="cuda", **overrides):
    """tests/test_api.py:250-293's configuration through the facade,
    initialized: the pendulum swing-up (midpoint, N=30, h=0.06), Q = 0.1
    toward (pi, 0), R = 1e-3, the input bounds |u| <= 6 (two affine
    NEGATIVE_ORTHANT rows on u), u = 0.1, under the phase-split
    Armijo-only grid of W=8 trials; with `with_tile` the block step
    `midpoint_tile(pendulum_tile())`, so the solve runs the trial rollout
    (on the card csrc/trial_rollout.cu's pendulum kernel). overrides are
    SolverOptions fields."""
    from altro_tpu_torch.api import ALTROSolver

    N, n, m = BLOCK_STEP_N, 2, 1
    s = ALTROSolver(N, dtype=dtype, device=device)
    s.set_dimension(n, m)
    s.set_time_step(0.06)
    s.set_explicit_dynamics(midpoint(pendulum_continuous()))
    s.set_lqr_cost(np.full(n, 1e-1), np.full(m, 1e-3), np.array([np.pi, 0.0]), np.zeros(m))
    s.set_input_bounds(u_lo=[-U_MAX], u_hi=[U_MAX])
    s.set_initial_state(np.zeros(n))
    if with_tile:
        s.set_tile_dynamics(midpoint_tile(pendulum_tile()))
    s.initialize()
    s.set_input(np.full((m,), 0.1), 0, N)
    s.set_options(SolverOptions(**{**dict(
        iterations_max=12, use_backtracking_linesearch=True, parallel_linesearch=True,
        ls_phase_split=True, ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8,
        throw_errors=False), **overrides}))
    return s


# ---------------------------------------------------------------------------
# Obstacle-constrained bicycle MPC (scripts/bench_all.py:566-730 and
# tests/test_obstacle_mpc.py)
# ---------------------------------------------------------------------------

OBS_V_MAX = 8.0  # speed bound (the reference speed is 6.31 m/s)
OBS_SR_MAX = 1.5  # steering-rate bound, rad/s


def _input_bounds_fn(x, u, k):
    return torch.stack([u[0] - OBS_V_MAX, -u[0], u[1] - OBS_SR_MAX, -OBS_SR_MAX - u[1]])


def obstacle_problem(ref, N: int = 30, *, t_obs: int = 25, r_obs: float = 0.75,
                     with_obstacle: bool = True, declared: bool = False,
                     dtype=torch.float32, device="cuda") -> Problem:
    """The obstacle row's problem on the first reference window: the
    bicycle (midpoint), the diagonal tracking cost (Q = 1e-2, R = 1e-3),
    and three NEGATIVE_ORTHANT groups: the steering bound |delta| <= 60
    deg (2 rows), the input bounds 0 <= v <= 8 and |delta_dot| <= 1.5
    (4 rows, off at knot N), and the obstacle r^2 - |p - c|^2 <= 0 (1
    nonlinear row, active at every knot), the disc centred on the path at
    ref.x[t_obs + N // 2]. The first two groups are declared affine;
    `declared` also declares them diagonal-Hessian, as
    tests/test_obstacle_mpc.py does. with_obstacle=False drops the disc
    (the test's twin). On the card unless `device` says otherwise."""
    n, m = 4, 2
    kw = dict(dtype=dtype, device=device)
    c_obs = [float(v) for v in ref.x[t_obs + N // 2][:2]]

    def obstacle_fn(x, u, k):
        dx = x[0] - c_obs[0]
        dy = x[1] - c_obs[1]
        return torch.stack([r_obs * r_obs - dx * dx - dy * dy])

    on = torch.ones(N + 1, dtype=torch.bool, device=device)
    off_n = on.clone()
    off_n[N] = False
    cons = (
        ConstraintSpec(fn=_steering_fn, cone=Cone.NEGATIVE_ORTHANT, dim=2, active=on,
                       label="steering", diag_hessian=declared, affine=True),
        ConstraintSpec(fn=_input_bounds_fn, cone=Cone.NEGATIVE_ORTHANT, dim=4, active=off_n,
                       label="input bounds", diag_hessian=declared, affine=True),
    )
    if with_obstacle:
        cons = cons + (ConstraintSpec(fn=obstacle_fn, cone=Cone.NEGATIVE_ORTHANT, dim=1,
                                      active=on, label="obstacle"),)
    cost = lqr_cost_from_reference(
        torch.full((N + 1, n), Q_DIAG, **kw), torch.full((N + 1, m), R_DIAG, **kw),
        torch.as_tensor(ref.x[: N + 1], **kw), torch.as_tensor(ref.u[: N + 1], **kw))
    return Problem(N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
                   constraints=cons, cost=cost,
                   h=torch.full((N,), float(np.float32(ref.tf / ref.N)), **kw),
                   x0=torch.as_tensor(ref.x[0], **kw))


def obstacle_options(pallas_backward: bool = True, exact: bool = False) -> SolverOptions:
    """The row's options (`o_opts`, bench_all.py:624-643): bench_all.py's
    f32opts (30 iterations, tolerances 1e-3) with a budget of 25, the
    phase-split Armijo-only grid of width 8 in three blocks (24 trials),
    penalty warm start decayed by 0.5 a resolve, line-search failure
    recovery without a cap (ls_recovery_max_fails=0), the best-decrease
    fallback and relative stationarity 1e-5; with `pallas_backward` the
    dense backward kernel on the card (its plain version on the CPU);
    `exact` selects the exact AL Hessian."""
    return SolverOptions(
        iterations_max=25, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True, penalty_warm_start=True,
        penalty_warm_start_decay=0.5, parallel_linesearch=True, ls_phase_split=True,
        ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=24,
        ls_failure_recovery=True, ls_recovery_max_fails=0, ls_best_decrease_fallback=True,
        tol_stationarity_rel=1e-5, pallas_backward=pallas_backward, exact_al_hessian=exact)


def obstacle_initial_states(ref, batch: int, *, seed: int = 7, start: int = 0,
                            dtype=torch.float32, device="cuda") -> torch.Tensor:
    """[B, 4] plant states: the path's point ref.x[start] (its start by
    default) plus 0.02 N(0, 1) from numpy's default_rng(seed) (the JAX row
    draws them from jax.random.PRNGKey(7), which gives other numbers)."""
    noise = np.random.default_rng(seed).standard_normal((batch, 4))
    return torch.as_tensor(np.asarray(ref.x[start])[None] + 0.02 * noise, dtype=dtype,
                           device=device)


@dataclasses.dataclass
class ObstacleResult:
    iterations: torch.Tensor  # [T, B] int32
    status: torch.Tensor  # [T, B] int32
    dist: torch.Tensor  # [T, B] distance of the plant from the disc's centre after each tick
    tracking_error: torch.Tensor  # [T, B] |p - ref.x[t + 1][:2]| after each tick
    x_true: torch.Tensor  # [B, 4] final plant states
    r_obs: float
    state: SolverState  # final solver state, batch-major
    seconds: float  # wall time of the run (synchronized on CUDA)

    def metrics(self) -> dict:
        """The row's numbers (bench_all.py:698-728, unrounded) and its gates."""
        T, B = self.iterations.shape
        success = float((self.status == 0).double().mean())
        clearance = float(self.dist.double().min()) - self.r_obs
        err = float(self.tracking_error.double().mean())
        return {
            "solves_per_s": B * T / self.seconds,
            "ms_per_tick": 1e3 * self.seconds / T,
            "ticks": T,
            "success_rate": success,
            "min_obstacle_clearance": clearance,
            "mean_tracking_error": err,
            "mean_iterations": float(self.iterations.double().mean()),
            "gates_passed": clearance > -0.1 and success > 0.75 and err < 2.0,
        }


def run_obstacle_mpc(problem: Problem, ref, x_true0: torch.Tensor, *, ticks: int = 60,
                     start: int = 0, opts: Optional[SolverOptions] = None,
                     r_obs: float = 0.75, t_obs: int = 25,
                     layer_seconds: Optional[dict] = None) -> ObstacleResult:
    """The obstacle row's closed loop over its ticks start .. start + ticks
    - 1: each tick every lane gets the sliding window's linear cost rows
    (shared by the lanes, as the JAX row broadcasts them), one
    warm-started vmapped solve (`parallel.batch.solve_lanes`), u_0 through
    the plant (the problem's own dynamics) and the shift. The warm start
    is the first tick's reference window as x with u = (u_ref[0][0], 0).
    problem: `obstacle_problem(ref)`; x_true0 [B, 4]
    (`obstacle_initial_states` with the same start); opts default
    `obstacle_options()`. layer_seconds: as `tile_solver.lane_loop`'s."""
    opts = obstacle_options() if opts is None else opts
    N, n, B = problem.N, problem.n, x_true0.shape[0]
    dt, dev = problem.dtype, problem.device
    xw, qs, cs = _windows(ref, N, ticks, problem, start)
    u0 = torch.tensor([ref.u[0][0], 0.0], dtype=dt, device=dev)
    state0 = dataclasses.replace(
        batch_init_state(problem, B), u=u0.expand(B, N, problem.m).contiguous(),
        x=xw[0].expand(B, N + 1, n).contiguous())
    centre = torch.as_tensor(ref.x[t_obs + N // 2][:2], dtype=dt, device=dev)[:, None]
    dist = torch.empty((ticks, B), dtype=dt, device=dev)
    errs = torch.empty((ticks, B), dtype=dt, device=dev)

    def observe(t, x_true):
        dist[t] = torch.linalg.vector_norm(x_true[:2] - centre, dim=0)
        errs[t] = torch.linalg.vector_norm(x_true[:2] - xw[t + 1, 0, :2, None], dim=0)

    out = _lanes_closed_loop(
        problem, x_true0, ticks, state0,
        lambda prob, st: solve_lanes(prob, st, opts, layer_seconds),
        lambda t: dataclasses.replace(problem.cost, q=qs[t], c=cs[t]), observe=observe)
    iters, statuses, x_true, state, seconds = out
    return ObstacleResult(iters, statuses, dist, errs, x_true, r_obs, state, seconds)


def obstacle_loop_options(tol: float = 1e-4) -> SolverOptions:
    """tests/test_obstacle_mpc.py's options: 30 iterations, the sequential
    backtracking search, penalty warm start; stationarity and feasibility
    `tol` (the test's 1e-4; the bench's 1e-3 in float32)."""
    return SolverOptions(iterations_max=30, use_backtracking_linesearch=True,
                         penalty_warm_start=True, throw_errors=False, tol_stationarity=tol,
                         tol_primal_feasibility=tol)


@dataclasses.dataclass
class ObstacleLoopResult:
    status: list  # [T] SolveStatus per resolve
    iterations: list  # [T] iterations per resolve
    dist: np.ndarray  # [T] distance from the disc's centre after each tick, float64
    tracking_error: np.ndarray  # [T] |p - ref.x[t + 1][:2]| after each tick, float64
    r_obs: float
    seconds: float  # wall time of the loop (synchronized on CUDA)

    def metrics(self) -> dict:
        """The test's oracle numbers."""
        return {
            "min_dist": float(self.dist.min()),
            "mean_tracking_error": float(self.tracking_error.mean()),
            "last_tracking_error": float(self.tracking_error[-1]),
            "success_rate": float(np.mean(np.asarray(self.status) == 0)),
            "mean_iterations": float(np.mean(self.iterations)),
            "ms_per_tick": 1e3 * self.seconds / len(self.status),
        }


def run_obstacle_loop(ref, with_obstacle: bool = True, exact: bool = False, *,
                      ticks: int = 40, N: int = 30, t_obs: int = 15, r_obs: float = 0.6,
                      opts: Optional[SolverOptions] = None, dx0=None, dtype=torch.float32,
                      device="cuda") -> ObstacleLoopResult:
    """tests/test_obstacle_mpc.py's loop: one lane, the obstacle problem
    (`obstacle_problem(declared=True)`, the disc at ref.x[t_obs + N // 2]
    of radius r_obs, or without it), warm-started as the test does (x the
    reference window, u = (u_ref[0][0], 0)); each tick `solver.solve`,
    u_0 through the plant (the problem's dynamics, in its dtype), then
    `update_linear_costs` with the next window, `set_initial_state` and
    `shift_trajectory`. exact selects the exact AL Hessian; opts default
    `obstacle_loop_options()`; dx0 (4 numbers) moves the plant's start
    off ref.x[0]. On the card the single-lane backward kernel runs at
    (4, 2) (dense expansions, lux)."""
    opts = (obstacle_loop_options() if opts is None else opts).replace(exact_al_hessian=exact)
    problem = obstacle_problem(ref, N, t_obs=t_obs, r_obs=r_obs, with_obstacle=with_obstacle,
                               declared=True, dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=device)
    u0 = torch.tensor([ref.u[0][0], 0.0], **kw)
    state = dataclasses.replace(init_state(problem), u=u0.expand(N, problem.m).contiguous(),
                                x=torch.as_tensor(ref.x[: N + 1], **kw))
    Qd = np.full(4, Q_DIAG)
    c_u = 0.5 * float(ref.u[0] @ (np.full(2, R_DIAG) * ref.u[0]))
    h = problem.h[0]
    if dx0 is not None:
        problem = set_initial_state(problem, problem.x0 + torch.as_tensor(dx0, **kw))
    x = problem.x0
    statuses, iters, xs = [], [], []
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)
    t0 = time.perf_counter()
    for t in range(ticks):
        state, stats = solve(problem, state, opts)
        statuses.append(stats.status)
        iters.append(stats.iterations)
        x = problem.dynamics(x, state.u[0], h, 0)
        xs.append(x)
        window = ref.x[t + 1: t + N + 2]
        c_new = 0.5 * np.sum(Qd[None, :] * window * window, axis=1)
        c_new[:N] += c_u
        problem = update_linear_costs(problem, q=-(Qd[None, :] * window), c=c_new)
        problem = set_initial_state(problem, x)
        state = shift_trajectory(state)
    statuses = torch.stack(statuses).tolist()
    iters = torch.stack(iters).tolist()
    p = torch.stack(xs).double().cpu().numpy()[:, :2]
    seconds = time.perf_counter() - t0
    c_obs = np.asarray(ref.x[t_obs + N // 2][:2], np.float64)
    dist = np.linalg.norm(p - c_obs[None], axis=1)
    errs = np.linalg.norm(p - np.asarray(ref.x[1: ticks + 1])[:, :2], axis=1)
    return ObstacleLoopResult(statuses, iters, dist, errs, r_obs, seconds)


# ---------------------------------------------------------------------------
# The double integrator's block step through the facade, and trial-rollout
# operands for the bicycle's and the double integrator's kernels
# ---------------------------------------------------------------------------

DI_N = 10


def double_integrator_block_step_solver(with_tile: bool, dtype=torch.float32, device="cuda",
                                        **overrides):
    """tests/test_api.py:54's problem (the double integrator, N=10, h=0.5,
    x0 = (2, 2, 0, 0), Q = 1, R = 1e-2, the input bounds |u| <= 1) with its
    ZERO-cone goal replaced by a terminal cost Q_N = 100 toward the origin
    (no rollout kernel takes a ZERO cone), through the facade and set up as
    `pendulum_block_step_solver` sets up tests/test_api.py:250-293: the
    phase-split Armijo-only grid of W=8 trials, penalty 100 scaled by 100;
    with `with_tile` the block step `double_integrator_tile(2)`, so the
    solve runs the trial rollout (on the card csrc/trial_rollout.cu's
    one-lane-a-trial kernel at P=4). overrides are SolverOptions fields."""
    from altro_tpu_torch.api import ALTROSolver

    N, n, m = DI_N, 4, 2
    s = ALTROSolver(N, dtype=dtype, device=device)
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
    s.set_options(SolverOptions(**{**dict(
        iterations_max=12, penalty_initial=100.0, penalty_scaling=100.0,
        use_backtracking_linesearch=True, parallel_linesearch=True, ls_phase_split=True,
        ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8, throw_errors=False),
        **overrides}))
    return s


def trial_operands(model: str, N: int, W: int, P: int, *, rows: str = "state",
                   seed: Optional[int] = None, dtype=torch.float32, device="cuda"):
    """Operands of one trial rollout (`ops.trial_rollout.trial_rollout`) for
    the block step of the bicycle (model "bicycle"), the double
    integrator ("double_integrator") or the pendulum ("pendulum"): alphas
    0.5^w; x_ref the Scotty path's first N knots (the bicycle), a path to
    the origin (the double integrator) or a swing-up (the pendulum);
    perturbed u_ref (the pendulum's near its torque bound), random gains
    (the bicycle's: 0.1 N(0, 1) up to N=60, as tests/test_pallas_rollout.
    py's fixture, 0.002 beyond), the diagonal cost rows (toward x_ref and
    u_ref; the pendulum's Q = 0.1 toward (pi, 0), R = 1e-3 toward 0) and
    h. With P > 0, AL rows (rho-premultiplied, rho = 2.5, the pendulum's
    3, random duals):
    rows "state" are random affine rows in x and u active at every knot,
    the terminal one included; rows "groups" (P = 4) are two groups as
    tests/test_pallas_rollout.py:259 builds them, the steering bound
    (|delta| <= 0.01, on x) and an input bound (|u_0| <= 0.05, off on the
    second half of the horizon and at the terminal knot, where its rows
    are all zero); rows "bounds" (the pendulum, P = 2) are the ones the
    solve forms from |u| <= U_MAX (state terms zero, off on the first
    third and at the terminal knot). seed defaults to 17 for the pendulum,
    19 for the others. Returns (block step, operands, con), con None at
    P = 0, its rhoi a one-element tensor."""
    rng = np.random.default_rng((17 if model == "pendulum" else 19) if seed is None else seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device).contiguous()

    xg = ug = None  # the cost's target: x_ref and u_ref unless set
    if model == "bicycle":
        ref = load_scotty()
        n, m = 4, 2
        step = midpoint_tile(bicycle_tile())
        xr = np.asarray(ref.x[: N + 1])
        ur = np.asarray(ref.u[:N]) + 0.01 * rng.standard_normal((N, m))
        h = float(np.float32(ref.tf / ref.N))
        # the gains of tests/test_pallas_rollout.py's fixture up to its N=60,
        # smaller beyond (a longer closed loop on these gains is unstable,
        # and f32 roundoff would decide its trajectory)
        K = (0.1 if N <= 60 else 0.002) * rng.standard_normal((N, m, n))
        d = 0.05 * rng.standard_normal((N, m))
        x0 = xr[0]
        Qd, Rd = np.full((N + 1, n), Q_DIAG), np.full((N + 1, m), R_DIAG)
    elif model == "double_integrator":
        n, m = 4, 2
        step = double_integrator_tile(2)
        sw = np.linspace(1.0, 0.0, N + 1)[:, None]
        xr = np.concatenate([2.0 * sw, 2.0 * sw, -0.4 * np.ones((N + 1, 2))], 1) \
            + 0.1 * rng.standard_normal((N + 1, n))
        ur = 0.8 * rng.standard_normal((N, m))
        h = 0.5
        K, d = 0.1 * rng.standard_normal((N, m, n)), 0.2 * rng.standard_normal((N, m))
        x0 = xr[0] + 0.05 * rng.standard_normal(n)
        Qd, Rd = np.ones((N + 1, n)), np.full((N + 1, m), 1e-2)
    elif model == "pendulum":
        n, m = 2, 1
        step = midpoint_tile(pendulum_tile())
        sw = np.linspace(0.0, 1.0, N + 1)
        xr = np.stack([np.pi * sw, 2.0 * np.ones(N + 1)], axis=1) \
            + 0.1 * rng.standard_normal((N + 1, n))
        x0 = 0.05 * rng.standard_normal(n)
        ur = 5.5 + 0.8 * rng.standard_normal((N, m))
        K, d = 0.5 * rng.standard_normal((N, m, n)), 1.5 * rng.standard_normal((N, m))
        h = float(np.float32(0.06))
        Qd, Rd = np.full((N + 1, n), 0.1), np.full((N + 1, m), 1e-3)
        xg, ug = np.tile([np.pi, 0.0], (N + 1, 1)), np.zeros((N + 1, m))
    else:
        raise ValueError(f"model must be 'bicycle', 'double_integrator' or 'pendulum', "
                         f"not {model!r}")
    uc = np.concatenate([ur, np.zeros((1, m))])
    xg = xr if xg is None else xg
    ug = uc if ug is None else ug
    c = 0.5 * np.sum(Qd * xg * xg, 1) + 0.5 * np.sum(Rd * ug * ug, 1)
    args = (t(0.5 ** np.arange(W)), t(x0), t(xr), t(ur), t(K), t(d), t(Qd), t(-Qd * xg), t(Rd),
            t(-Rd * ug), t(c), t(np.full(N, h)))
    con = None
    if P:
        rho = 3.0 if model == "pendulum" else 2.5
        if rows == "state":
            a, b = rng.standard_normal((N + 1, P, n)), rng.standard_normal((N + 1, P, m))
            g = (np.einsum("kpi,ki->kp", a, xr) + np.einsum("kpj,kj->kp", b, uc)
                 + 0.5 * rng.standard_normal((N + 1, P)))
            g[N, : P // 2] -= 50.0  # half the terminal rows bite
            z = 0.1 * rng.standard_normal((N + 1, P))
            wa, wu, wg = rho * a, rho * b, z + rho * g
        elif rows == "groups" and P == 4:
            ax, au, g = np.zeros((N + 1, P, n)), np.zeros((N + 1, P, m)), np.zeros((N + 1, P))
            ax[:, 0, 3], ax[:, 1, 3], g[:, :2] = 1.0, -1.0, -0.01
            au[:, 2, 0], au[:, 3, 0], g[:, 2:] = 1.0, -1.0, -0.05
            act = np.ones((N + 1, P))
            act[N // 2:, 2:] = 0.0
            z = 0.1 * rng.standard_normal((N + 1, P))
            wa, wu = rho * ax * act[..., None], rho * au * act[..., None]
            wg = (z - rho * g) * act
        elif rows == "bounds" and model == "pendulum" and P == 2:
            act = np.ones((N + 1, P))
            act[N] = 0.0
            act[: N // 3] = 0.0
            wa = np.zeros((N + 1, P, n))
            wu = rho * np.array([[1.0], [-1.0]])[None].repeat(N + 1, 0) * act[..., None]
            wg = (np.abs(rng.standard_normal((N + 1, P))) + rho * U_MAX) * act
        else:
            raise ValueError(f"rows must be 'state', (at P=4) 'groups' or (the pendulum at "
                             f"P=2) 'bounds', not {rows!r}")
        con = (t(wa), t(wu), t(wg), t([1.0 / (2.0 * rho)]))
    return step, args, con


def double_integrator_grid_operands(B: int, N: int, W: int, P: int, *, seed: int = 23,
                                    dtype=torch.float32, device="cuda"):
    """A batched problem on the double integrator's column step and the
    operands of one trial grid (`ops.rollout_grid.rollout_grid`): the
    problem (N knots of h = 0.5, Q = 1 and R = 1e-2 toward the origin,
    `dynamics_cols = double_integrator_cols(2)`) with, at P = 2, one affine
    NEGATIVE_ORTHANT group of two random rows in x and u active at every
    knot, the terminal one included, with its constant Jacobian; then
    lane-minor references around a path to the origin, random gains,
    duals and per-lane rho, alphas 0.5^w and starts. Returns (problem,
    (x_ref, u_ref, K, d, z, rho, alphas, x0))."""
    n, m = 4, 2
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a), **kw).contiguous()

    cons = ()
    if P:
        if P != 2:
            raise ValueError("the grid takes P = 0 or 2 rows here")
        J = rng.standard_normal((P, n + m))
        g = 0.5 * rng.standard_normal(P) - 1.0
        Jt, gt = t(J), t(g)

        def rows_fn(x, u, k):
            xu = torch.cat([x, u], dim=0)
            return torch.einsum("pi,i...->p...", Jt, xu) + gt.reshape((P,) + (1,) * (xu.ndim - 1))

        cons = (ConstraintSpec(fn=rows_fn, cone=Cone.NEGATIVE_ORTHANT, dim=P,
                               active=torch.ones(N + 1, dtype=torch.bool, device=device),
                               jac=_constant_jacobian(Jt), label="rows", affine=True),)
    Qd, Rd = np.ones((N + 1, n)), np.full((N + 1, m), 1e-2)
    prob = Problem(N=N, n=n, m=m, dynamics=double_integrator_dynamics(2), dynamics_jac=None,
                   constraints=cons,
                   cost=lqr_cost_from_reference(t(Qd), t(Rd), t(np.zeros((N + 1, n))),
                                                t(np.zeros((N + 1, m)))),
                   h=torch.full((N,), 0.5, **kw), x0=torch.zeros(n, **kw),
                   dynamics_cols=double_integrator_cols(2))
    sw = np.linspace(1.0, 0.0, N + 1)[:, None, None]
    xr = np.concatenate([np.broadcast_to(2.0 * sw, (N + 1, 2, B)), np.full((N + 1, 2, B), -0.4)],
                        1) + 0.1 * rng.standard_normal((N + 1, n, B))
    ur = 0.8 * rng.standard_normal((N, m, B))
    K = 0.1 * rng.standard_normal((N, m, n, B))
    d = 0.2 * rng.standard_normal((N, m, B))
    z = (t(0.3 * np.abs(rng.standard_normal((N + 1, P, B)))),) if P else ()
    rho = 1.0 + 9.0 * rng.random(B)
    x0 = xr[0] + 0.05 * rng.standard_normal((n, B))
    return prob, (t(xr), t(ur), t(K), t(d), z, t(rho), t(0.5 ** np.arange(W)), t(x0))


# ---------------------------------------------------------------------------
# The warm-started controller through the exported artifact (mpc_latency_aot,
# scripts/bench_all.py:212-320)
# ---------------------------------------------------------------------------

AOT_DELTA_MAX = float(np.deg2rad(60.0))  # bench_all.py:149


def _aot_steering_fn(x, u, k):
    return torch.stack([x[3] - AOT_DELTA_MAX, -AOT_DELTA_MAX - x[3]])


def aot_latency_problem(ref, N: int = 30, *, dtype=torch.float32, device="cuda") -> Problem:
    """The `mpc_latency_aot` row's problem as bench_all.py:229-252 builds
    it: the bench's bicycle (4, 2) with midpoint on the Scotty path,
    horizon N, Q = 1e-2, R = 1e-3 on the first window, and the steering
    bound |delta| <= 60 deg as a plain `fn` with `diag_hessian=True` (no
    Jacobian given, not declared affine; no column or block step, so every
    rollout runs through the problem's own dynamics)."""
    n, m = 4, 2
    kw = dict(dtype=dtype, device=device)
    cost = lqr_cost_from_reference(
        torch.full((N + 1, n), Q_DIAG, **kw), torch.full((N + 1, m), R_DIAG, **kw),
        torch.as_tensor(ref.x[: N + 1], **kw), torch.as_tensor(ref.u[: N + 1], **kw))
    steering = ConstraintSpec(
        fn=_aot_steering_fn, cone=Cone.NEGATIVE_ORTHANT, dim=2,
        active=torch.ones(N + 1, dtype=torch.bool, device=device), label="steering",
        diag_hessian=True)
    return Problem(
        N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
        constraints=(steering,), cost=cost,
        h=torch.full((N,), float(np.float32(ref.tf / ref.N)), **kw),
        x0=torch.as_tensor(ref.x[0], **kw))


def aot_latency_options(pallas_backward: bool = False) -> SolverOptions:
    """The row's options (bench_all.py:253-258 on its f32 options :47-50):
    10 iterations at tolerance 1e-3, penalty warm start, the phase-split
    Armijo-only x-only grid of width 8 with 8 trials; the plain grids
    (`pallas_rollout=False`, `pallas_rollout_tiled=False`: the steering
    bound is not declared affine, so no trial kernel takes the problem).
    pallas_backward=True is the `mpc_latency_aot_B8_dense` line's: the
    batch on the dense backward kernel."""
    return SolverOptions(
        iterations_max=10, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True, penalty_warm_start=True,
        parallel_linesearch=True, ls_phase_split=True, ls_armijo_only=True,
        ls_grid_x_only=True, ls_max_iters=8, pallas_rollout=False, pallas_rollout_tiled=False,
        pallas_backward=pallas_backward)


def aot_latency_inputs(problem: Problem, ref, batch: Optional[int]):
    """The row's serving inputs (bench_all.py:265-279): the state at the
    reference window with u = (u_ref[0][0], 0) at every knot, the measured
    state ref.x[1] and the window ref.x[1 : N+2], ref.u[1 : N+2]; each
    repeated on a leading axis of `batch` lanes unless batch is None.
    Returns (x_measured, x_ref, u_ref, state dict)."""
    from altro_tpu_torch.export import state_to_arrays

    N = problem.N
    kw = dict(dtype=problem.dtype, device=problem.device)
    st = dataclasses.replace(
        init_state(problem),
        u=torch.tensor([ref.u[0][0], 0.0], **kw).repeat(N, 1),
        x=torch.as_tensor(ref.x[: N + 1], **kw))
    args = [torch.as_tensor(ref.x[1], **kw), torch.as_tensor(ref.x[1: N + 2], **kw),
            torch.as_tensor(ref.u[1: N + 2], **kw), state_to_arrays(st)]
    if batch is None:
        return tuple(args)

    def tile(a):
        return a.expand((batch,) + a.shape).contiguous()

    return (*(tile(a) for a in args[:3]), {k: tile(v) for k, v in args[3].items()})


def _blocking_ms(fn, reps: int, device) -> np.ndarray:
    """Host milliseconds of `reps` calls, each waited for on the device."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return np.sort(np.asarray(times))


def export_mpc_latency_aot(problem: Problem, opts: SolverOptions, batch: Optional[int],
                           path: str, platform: Optional[str] = None) -> float:
    """Export the row's tick (`export.export_mpc_server`, traced on the
    problem's device, for `platform`, by default that device's) and save
    it to `path`. Returns the export's seconds (tracing, not saving)."""
    from altro_tpu_torch.export import export_mpc_server, save_exported

    t0 = time.perf_counter()
    art = export_mpc_server(problem, opts, batch=batch,
                            platforms=(platform or problem.device.type,))
    seconds = time.perf_counter() - t0
    save_exported(art, path)
    return seconds


def run_mpc_latency_aot(problem: Problem, ref, opts: SolverOptions, batch: Optional[int],
                        path: str, *, calls: int = 60, chained: int = 100, warm: int = 2,
                        export_s: Optional[float] = None) -> dict:
    """The `mpc_latency_aot` row (bench_all.py:259-318) on the port: export
    the tick to `path` (`export_mpc_latency_aot`; with `export_s` given, the
    artifact at `path` was exported elsewhere, in that many seconds), load
    it, converge the warm start with `warm` calls, then time `calls`
    blocking calls (p50, p90), a chain of `chained` calls fed state to state
    with one wait at the end, and the transport floor: a trivial exported
    add over the same state dict, blocking. The calls run on the problem's
    device. Returns the row's numbers (milliseconds and seconds
    unrounded), its `iterations` (the largest of the last call's lanes),
    `inputs`: the blocking calls' (x_measured, x_ref, u_ref, state dict),
    `result`: the last blocking call's (u0, state dict, stats dict) and
    `server`: the loaded artifact."""
    from altro_tpu_torch.export import call_exported, load_exported

    dev = problem.device
    if export_s is None:
        export_s = export_mpc_latency_aot(problem, opts, batch, path)
    t0 = time.perf_counter()
    srv = load_exported(path)
    xm, xr, ur, st = aot_latency_inputs(problem, ref, batch)
    call_exported(srv, xm, xr, ur, st)  # builds the module (and the kernels) once
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    for _ in range(warm):
        _, st, _ = call_exported(srv, xm, xr, ur, st)
    out = []

    def one():
        out[:] = [call_exported(srv, xm, xr, ur, st)]

    times = _blocking_ms(one, calls, dev)
    t0 = time.perf_counter()
    st_c = st
    for _ in range(chained):
        u0, st_c, _ = call_exported(srv, xm, xr, ur, st_c)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    chained_ms = (time.perf_counter() - t0) / chained * 1e3

    class _Floor(torch.nn.Module):
        def forward(self, a, s):
            return a + 1.0, {k: v + 1.0 for k, v in s.items()}

    floor = torch.export.export(_Floor(), (xm, st), strict=False).module()
    floor(xm, st)
    ftimes = _blocking_ms(lambda: floor(xm, st), calls, dev)
    u0, st_last, stats = out[0]
    return {
        "p50_call_ms": float(times[len(times) // 2]),
        "p90_call_ms": float(times[int(len(times) * 0.9)]),
        "chained_call_ms": chained_ms,
        "dispatch_floor_p50_ms": float(ftimes[len(ftimes) // 2]),
        "iterations": int(stats["iterations"].max()),
        "export_s": export_s,
        "load_s": load_s,
        "inputs": (xm, xr, ur, st),
        "result": (u0, st_last, stats),
        "server": srv,
    }
