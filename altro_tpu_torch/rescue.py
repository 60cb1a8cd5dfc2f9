"""Two-tier failed-lane rescue for batched MPC resolves (PyTorch port).

Counterpart: altro_tpu/rescue.py (`rescue_options`,
`solve_tiled_with_rescue`, `vmap_solve_with_rescue`). After the
standard-budget batched solve,
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
from altro_tpu_torch.parallel.batch import check_options
from altro_tpu_torch.problem import Problem
from altro_tpu_torch.solver import SolverState, SolveStats

__all__ = ["rescue_options", "solve_tiled_with_rescue", "vmap_solve_with_rescue",
           "merge_rescue"]


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

    Same layout contract as `solve_tiled`: any leaf of the problem may
    hold one row per lane, and both tiers take them as the problem
    carries them (altro_tpu/rescue.py:57-77). Rescued lanes take
    the rescue's state and stats, with iterations summed over both tiers
    (`merge_rescue`). When `info` is a dict, info["rescued"] records
    whether the rescue ran. On CUDA tensors both tiers' options are
    checked against the kernels' reach (`tile_solver.kernel_refusal`)
    before either tier runs.
    """
    for o in (opts, opts_rescue):
        tsv.refuse_on_card("solve_tiled_with_rescue", problem, o, vmapped=False)
    return _with_rescue(lambda st, o: tsv.solve_tiled(problem, st, o), state, opts,
                        opts_rescue, info)


def vmap_solve_with_rescue(
    problem: Problem,
    x0_batch: torch.Tensor,
    state_batch: SolverState,
    opts: SolverOptions,
    opts_rescue: SolverOptions,
    info: Optional[dict] = None,
) -> Tuple[SolverState, SolveStats]:
    """The vmapped solve (`parallel.batch.vmap_solve`'s lane loop) plus the
    conditional failed-lane rescue, batch-major at its edges: `problem`
    holds the other leaves, shared or one row per lane lane-minor,
    x0_batch [B, n] and state_batch (leaves [B, ...]) the lanes'. Returns (state [B, ...], stats [B]): rescued
    lanes take the rescue's state and stats, iterations summed over both
    tiers (`merge_rescue`); the others keep the primary tier's bit for
    bit. The rescue runs only when a lane failed (one host read). When
    `info` is a dict, info["rescued"] records whether it ran. Options and
    kernels are checked for both tiers before either runs
    (`parallel.batch.check_options`, `tile_solver.refuse_on_card`)."""
    for o in (opts, opts_rescue):
        check_options(o)
        tsv.refuse_on_card("vmap_solve_with_rescue", dataclasses.replace(problem, x0=x0_batch),
                           o, vmapped=True)
    prob = dataclasses.replace(problem, x0=tsv.batch_to_lanes(x0_batch))
    st, stats = _with_rescue(lambda st, o: tsv.lane_loop(prob, st, o, vmapped=True),
                             tsv.state_to_lanes(state_batch), opts, opts_rescue, info)
    return tsv.state_from_lanes(st), stats


def _with_rescue(run, state, opts, opts_rescue, info) -> Tuple[SolverState, SolveStats]:
    """run(state, opts) (a lane-minor batched solve), then, when a lane
    failed (one host read), run(its state, opts_rescue) merged into the
    failed lanes (`merge_rescue`); info["rescued"] records whether it ran."""
    st, stats = run(state, opts)
    failed = stats.status != 0
    rescued = bool(torch.any(failed))
    if info is not None:
        info["rescued"] = rescued
    if not rescued:
        return st, stats
    st_r, stats_r = run(st, opts_rescue)
    return merge_rescue(failed, st, stats, st_r, stats_r)


def merge_rescue(failed, st, stats, st_r, stats_r) -> Tuple[SolverState, SolveStats]:
    """The rescue's merge, lane-minor: the failed lanes [B] take the
    rescue's state and stats, iterations summed over both tiers; the other
    lanes keep the primary tier's bit for bit."""
    merged = {}
    for f in dataclasses.fields(SolverState):
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
