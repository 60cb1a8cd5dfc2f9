"""Batched solves over lanes (PyTorch port).

Counterpart: altro_tpu/parallel/batch.py (`batch_init_state`,
`vmap_solve`). JAX vmapped the one-lane `solve`; here the batch is
written out: `vmap_solve` runs the lane-minor iteration that
tile_solver.solve_tiled also runs (`tile_solver.lane_loop`), with the
per-lane semantics of `jax.vmap(solve)`. `batched_tracking_solver` (per-lane
q and c) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from altro_tpu_torch import tile_solver as tsv
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import Problem
from altro_tpu_torch.solver import SolverState, grid_search_refusal, init_state

__all__ = ["batch_init_state", "solve_lanes", "vmap_solve"]


def batch_init_state(problem: Problem, batch: int) -> SolverState:
    """SolverState with a leading lane axis [B, ...] (batch-major)."""
    s = init_state(problem)
    return s.map(lambda a: a.expand((batch,) + a.shape).contiguous())


def _check(who: str, opts: SolverOptions) -> None:
    if opts.pallas_backward and (opts.parallel_riccati or opts.symmetrize_ctg):
        raise ValueError(
            "pallas_backward is mutually exclusive with parallel_riccati and "
            "symmetrize_ctg (the fused kernel implements the plain serial "
            "recursion); disable one of them")
    why = grid_search_refusal(opts)
    if why is not None:
        raise NotImplementedError(f"{who}: {why}")


def solve_lanes(problem: Problem, state: SolverState, opts: SolverOptions = SolverOptions(),
                layer_seconds: Optional[dict] = None):
    """The vmapped solve on lane-minor data: problem.x0 [n, B], state
    lane-minor; returns (state lane-minor, stats [B]). Closed loops call
    this to keep their lanes lane-minor across ticks. layer_seconds: see
    `tile_solver.lane_loop`."""
    _check("solve_lanes", opts)
    tsv.refuse_on_card("solve_lanes", problem, opts, vmapped=True)
    return tsv.lane_loop(problem, state, opts, vmapped=True, layer_seconds=layer_seconds)


def vmap_solve(problem: Problem, opts: SolverOptions = SolverOptions()):
    """The vmapped solve over (x0 batch, state batch); problem is shared.

    Returns a callable (x0 [B, n], state [B, ...]) -> (state', stats),
    batch-major at its edges and per-lane stats [B]. With
    `pallas_backward` the backward pass is the dense kernel
    (ops/riccati_dense.py) on CUDA float32 and its plain version on the
    CPU; without it, the plain recursion. The trial grid is always the
    plain one through the problem's own dynamics: `pallas_rollout` is not
    read, since it selects the single-lane trial-rollout kernel, which
    JAX's vmapped solve never runs either (altro_tpu/ops/pallas_rollout.py
    falls back to the scan under vmap). Options the port does not
    implement raise NotImplementedError naming the option; on CUDA a
    problem the dense kernel cannot take raises with its reason
    (`tile_solver.kernel_refusal`) when called, before anything runs.
    """
    _check("vmap_solve", opts)

    def run(x0, state: SolverState):
        tsv.refuse_on_card("vmap_solve", dataclasses.replace(problem, x0=x0), opts, vmapped=True)
        prob = dataclasses.replace(problem, x0=tsv.batch_to_lanes(x0))
        st, stats = tsv.lane_loop(prob, tsv.state_to_lanes(state), opts, vmapped=True)
        return tsv.state_from_lanes(st), stats

    return run
