"""Batched receding-horizon MPC on the Scotty path: the port's main entry.

Counterparts: altro_tpu/mpc.py (the MPC layer) and the tiled branch of
bench.py's closed loop (`child_main`, its problem, options, rescue and
`tick_tiled`), here as library functions:

* `scotty_problem` builds the bench problem: kinematic bicycle (n=4,
  m=2) with midpoint integration, horizon N, diagonal tracking cost
  (Q = 1e-2, R = 1e-3) on the reference window, one affine steering bound
  |delta| <= 60 deg (NEGATIVE_ORTHANT) with its constant Jacobian given,
  and the column-form step that the rollout kernel runs.
* `bench_options` returns the bench's solver and rescue options.
* `run_closed_loop` runs B lanes for T ticks: each tick slides the cost
  window, solves with the failed-lane rescue, applies u_0 to the true
  plant, and shifts the warm start. The state stays lane-minor for the
  whole run (converted once at each end).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from altro_tpu_torch import rescue as rsc
from altro_tpu_torch import tile_solver as tsv
from altro_tpu_torch.cones import Cone
from altro_tpu_torch.models.bicycle import bicycle_continuous
from altro_tpu_torch.models.integrators import midpoint
from altro_tpu_torch.models.tile_steps import bicycle_cols, midpoint_cols
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.parallel.batch import batch_init_state
from altro_tpu_torch.problem import ConstraintSpec, Problem, lqr_cost_from_reference
from altro_tpu_torch.solver import SolverState

__all__ = [
    "Q_DIAG",
    "R_DIAG",
    "DELTA_MAX",
    "scotty_problem",
    "bench_options",
    "perturbed_initial_states",
    "ClosedLoopResult",
    "run_closed_loop",
]

Q_DIAG = 1e-2
R_DIAG = 1e-3
DELTA_MAX = 60 * math.pi / 180.0


def _steering_fn(x, u, k):
    return torch.stack([x[3] - DELTA_MAX, -DELTA_MAX - x[3]])


def _constant_jacobian(J):
    """jac(x, u, k) of an affine constraint: the constant [p, n+m] rows,
    broadcast (as a view) over the batch dims of x and u."""

    def jac(x, u, k):
        batch = torch.broadcast_shapes(x.shape[1:], u.shape[1:])
        return J.reshape(J.shape + (1,) * len(batch)).expand(J.shape + batch)

    return jac


def scotty_problem(ref, N: int = 30, *, dtype=torch.float32, device="cpu") -> Problem:
    """The bench's Scotty tracking problem over the first reference window."""
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
    )


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


def perturbed_initial_states(ref, batch: int, *, seed: int = 0, noise: float = 0.02,
                             dtype=torch.float32, device="cpu") -> torch.Tensor:
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


def _windows(ref, N: int, ticks: int, problem: Problem):
    """Sliding tracking windows (q, c) per tick, as bench.py builds them."""
    n = problem.n
    xw = np.stack([ref.x[t: t + N + 1] for t in range(ticks + 1)])  # [T+1, N+1, n]
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
