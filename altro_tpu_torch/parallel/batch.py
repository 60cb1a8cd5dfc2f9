"""Batched solves over lanes (PyTorch port).

Counterpart: altro_tpu/parallel/batch.py (`batch_init_state`,
`vmap_solve`, `batched_tracking_solver`). JAX vmapped the one-lane
`solve`; here the batch is written out: `vmap_solve` runs the
lane-minor iteration that tile_solver.solve_tiled also runs
(`tile_solver.lane_loop`), with the per-lane semantics of
`jax.vmap(solve)`, every line search included (the light-payload grid
too), every backward pass (`parallel_riccati` too), and reports per lane
at every verbosity tier (Verbosity.LINE_SEARCH's per-trial lines too) and
through `iteration_callback`, as JAX's vmapped solve does. `batched_tracking_solver`
gives each lane its own linear cost terms q and c (Q, R and r shared),
as lane-minor rows of the `DiagonalCost`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from altro_tpu_torch import tile_solver as tsv
from altro_tpu_torch.linesearch import Trace
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import DiagonalCost, Problem
from altro_tpu_torch.solver import (
    SolverState,
    check_pallas_backward,
    init_state,
)

__all__ = ["batch_init_state", "solve_lanes", "vmap_solve", "batched_tracking_solver",
           "check_options"]


def batch_init_state(problem: Problem, batch: int) -> SolverState:
    """SolverState with a leading lane axis [B, ...] (batch-major)."""
    s = init_state(problem)
    return s.map(lambda a: a.expand((batch,) + a.shape).contiguous())


def check_options(opts: SolverOptions) -> None:
    """JAX's option errors (ValueError)."""
    check_pallas_backward(opts)
    if opts.ls_armijo_only and not (opts.rti_mode or opts.ls_phase_split):
        raise ValueError(
            "ls_armijo_only requires ls_phase_split (or rti_mode): without the phase-split "
            "line search the directional derivative is computed inside the merit rollout "
            "and cannot be skipped")
    if not opts.rti_mode and opts.parallel_linesearch and not opts.use_backtracking_linesearch:
        raise ValueError("parallel_linesearch requires use_backtracking_linesearch")


def solve_lanes(problem: Problem, state: SolverState, opts: SolverOptions = SolverOptions(),
                layer_seconds: Optional[dict] = None):
    """The vmapped solve on lane-minor data: problem.x0 [n, B], any other
    leaf shared or one row per lane (`tile_solver.solve_tiled`'s
    contract), state lane-minor; returns (state lane-minor, stats [B]). Closed loops call
    this to keep their lanes lane-minor across ticks. layer_seconds: a
    dict that gains host seconds by layer (`tile_solver.lane_loop`)."""
    check_options(opts)
    tsv.refuse_on_card("solve_lanes", problem, opts, vmapped=True)
    return tsv.lane_loop(problem, state, opts, vmapped=True, trace=Trace(layer_seconds))


def vmap_solve(problem: Problem, opts: SolverOptions = SolverOptions()):
    """The vmapped solve over (x0 batch, state batch); the problem's other
    leaves are shared or hold one row per lane, lane-minor
    (`tile_solver.solve_tiled`'s contract).

    Returns a callable (x0 [B, n], state [B, ...]) -> (state', stats),
    batch-major at its edges and per-lane stats [B]. Under the default
    options each lane runs the strong-Wolfe cubic search, with
    `use_backtracking_linesearch` the sequential backtracking (the
    per-lane machine, `linesearch.wolfe_line_search_lanes`), with
    `parallel_linesearch` the non-split or the phase-split grid. With
    `pallas_backward` the backward pass is the dense kernel
    (ops/riccati_dense.py) on CUDA float32 and its plain version on the
    CPU; with `parallel_riccati` the associative pass
    (`tvlqr.tvlqr_backward_associative`, plain PyTorch on any device);
    else the plain recursion. The trial rollouts are always
    the plain ones through the problem's own dynamics: `pallas_rollout`
    is not read, since it selects the single-lane trial-rollout kernel,
    which JAX's vmapped solve never runs either
    (altro_tpu/ops/pallas_rollout.py falls back to the scan under vmap).
    Options JAX rejects raise its ValueError; on CUDA a problem the dense
    kernel cannot take raises NotImplementedError with its reason
    (`tile_solver.kernel_refusal`) when called, before anything runs.
    """
    check_options(opts)

    def run(x0, state: SolverState):
        tsv.refuse_on_card("vmap_solve", dataclasses.replace(problem, x0=x0), opts, vmapped=True)
        prob = dataclasses.replace(problem, x0=tsv.batch_to_lanes(x0))
        st, stats = tsv.lane_loop(prob, tsv.state_to_lanes(state), opts, vmapped=True)
        return tsv.state_from_lanes(st), stats

    return run


def batched_tracking_solver(problem: Problem, opts: SolverOptions = SolverOptions(), *,
                            trace: Optional[Trace] = None):
    """The batched-MPC workhorse: each lane has its own initial state and
    its own tracking reference (linear cost terms q, c per lane; Q, R and
    r shared). Returns a callable

        (x0 [B, n], q [B, N+1, n], c [B, N+1], state [B, ...]) ->
        (u0 [B, m], state', stats)

    batch-major at its edges: one warm-started resolve per lane per call,
    the vmapped solve (`vmap_solve`'s searches and kernels) on the
    lane-minor rows q [N+1, n, B], c [N+1, B]. Raises TypeError for a
    cost that is not a DiagonalCost, as JAX does. trace: a
    `linesearch.Trace` that accumulates over calls (its layers and counts
    are `tile_solver.lane_loop`'s).
    """
    if not isinstance(problem.cost, DiagonalCost):
        raise TypeError("batched_tracking_solver requires a DiagonalCost")
    check_options(opts)

    def run(x0, q, c, state: SolverState):
        tsv.refuse_on_card("batched_tracking_solver", dataclasses.replace(problem, x0=x0), opts,
                           vmapped=True)
        cost = dataclasses.replace(problem.cost, q=tsv.batch_to_lanes(q),
                                   c=tsv.batch_to_lanes(c))
        prob = dataclasses.replace(problem, x0=tsv.batch_to_lanes(x0), cost=cost)
        st, stats = tsv.lane_loop(prob, tsv.state_to_lanes(state), opts, vmapped=True,
                                  trace=trace)
        state_b = tsv.state_from_lanes(st)
        return state_b.u[:, 0], state_b, stats

    return run
