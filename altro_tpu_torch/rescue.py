"""Two-tier failed-lane rescue for batched MPC resolves (PyTorch port).

Counterpart: altro_tpu/rescue.py (`rescue_options`,
`solve_tiled_with_rescue`). After the standard-budget batched solve,
lanes whose status is not SUCCESS are solved again from their post-solve
state with the rescue options; healthy lanes keep their primary state
bit for bit. The JAX `lax.cond` on any-lane-failed becomes one host sync
per call: a batch with no failure pays nothing more.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from altro_tpu_torch import tile_solver as tsv
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import Problem
from altro_tpu_torch.solver import SolverState, SolveStats

__all__ = ["rescue_options", "solve_tiled_with_rescue"]


def rescue_options(opts: SolverOptions,
                   iterations_max: int = 10,
                   recovery_max_fails: int = 0) -> SolverOptions:
    """Second-tier options: bigger budget, unlimited line-search failure
    recovery, widened final-step acceptance, warm-started penalty."""
    return opts.replace(
        iterations_max=iterations_max,
        ls_failure_recovery=True,
        ls_recovery_max_fails=recovery_max_fails,
        ls_best_decrease_fallback=True,
        penalty_warm_start=True,
    )


def solve_tiled_with_rescue(
    problem: Problem,
    state: SolverState,
    opts: SolverOptions,
    opts_rescue: SolverOptions,
    info: Optional[dict] = None,
) -> Tuple[SolverState, SolveStats]:
    """`tile_solver.solve_tiled` plus the conditional failed-lane rescue.

    Same layout contract as `solve_tiled`. Rescued lanes take the rescue's
    state and stats, with iterations summed over both tiers. When `info`
    is a dict, info["rescued"] records whether the rescue ran.
    """
    st, stats = tsv.solve_tiled(problem, state, opts)
    failed = stats.status != 0
    rescued = bool(torch.any(failed))
    if info is not None:
        info["rescued"] = rescued
    if not rescued:
        return st, stats
    st_r, stats_r = tsv.solve_tiled(problem, st, opts_rescue)
    fields = dataclasses.fields(SolverState)
    merged = {}
    for f in fields:
        r, m = getattr(st_r, f.name), getattr(st, f.name)
        if f.name == "z":
            merged[f.name] = tuple(torch.where(failed, a, b) for a, b in zip(r, m))
        else:
            merged[f.name] = torch.where(failed, r, m)
    stats_m = SolveStats(**{
        f.name: torch.where(failed, getattr(stats_r, f.name), getattr(stats, f.name))
        for f in dataclasses.fields(SolveStats)
    })
    stats_m = dataclasses.replace(
        stats_m,
        iterations=stats.iterations + torch.where(
            failed, stats_r.iterations, torch.zeros_like(stats_r.iterations)))
    return SolverState(**merged), stats_m
