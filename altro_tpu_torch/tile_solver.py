"""Natively batched AL-iLQR solve on lane-minor stacks (PyTorch port).

Counterpart: altro_tpu/tile_solver.py (`solve_tiled`,
`shift_trajectory_tiled`, `supported_options`, and `state_to_tiles` /
`state_from_tiles`, whose twins here are `state_to_lanes` /
`state_from_lanes`). Every array of the iteration keeps the lanes on its
last axis ([N(+1), entry..., B]); callers convert once per closed-loop
run with `batch_to_lanes` / `lanes_to_batch`.

Semantics contract (as in JAX): `solve_tiled` computes the same per-lane
iterates as `jax.vmap(solve)` with the supported options: the parallel
phase-split x-only Armijo-only grid line search or the real-time
iteration (`rti_mode`, a full step through the same rollout with W=1),
the Riccati backward
with adaptive regularization retry, the status chain, the dual/penalty
update, and the per-lane freeze of lanes that stopped.

The JAX `lax.while_loop`s become Python `while` loops on a device-side
`any(...)`: one host sync per solver trip (and one per retry or extra
line-search block). The trip count is not fixed: a tick whose lanes all
converge after one trip pays one trip.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from altro_tpu_torch import al
from altro_tpu_torch.ops import tile_iter as ti
from altro_tpu_torch.ops.riccati_backward import riccati_backward
from altro_tpu_torch.ops.rollout_grid import affine_constraint_stacks, rollout_grid
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import Problem
from altro_tpu_torch.solver import (
    SolverState,
    SolveStats,
    complementarity,
    feasibility,
    stationarity,
    total_cost,
)
from altro_tpu_torch.status import SolveStatus

__all__ = [
    "solve_tiled",
    "batch_to_lanes",
    "lanes_to_batch",
    "state_to_lanes",
    "state_from_lanes",
    "shift_trajectory_tiled",
    "supported_options",
]

_UNSOLVED = int(SolveStatus.UNSOLVED)


def batch_to_lanes(t: torch.Tensor) -> torch.Tensor:
    """[B, *rest] -> [*rest, B] (contiguous)."""
    return t.movedim(0, -1).contiguous()


def lanes_to_batch(t: torch.Tensor) -> torch.Tensor:
    """[*rest, B] -> [B, *rest] (contiguous)."""
    return t.movedim(-1, 0).contiguous()


def state_to_lanes(state: SolverState) -> SolverState:
    """Batch-major SolverState -> lane-minor."""
    return state.map(batch_to_lanes)


def state_from_lanes(state: SolverState) -> SolverState:
    """Lane-minor SolverState -> batch-major."""
    return state.map(lanes_to_batch)


def shift_trajectory_tiled(state: SolverState) -> SolverState:
    """mpc.shift_trajectory on a lane-minor state (knot axis leads)."""
    x = torch.cat([state.x[1:], state.x[-1:]], dim=0)
    u = torch.cat([state.u[1:], state.u[-1:]], dim=0)
    return dataclasses.replace(state, x=x, u=u)


def supported_options(opts: SolverOptions) -> bool:
    """True when `solve_tiled` implements this configuration."""
    ls_ok = opts.rti_mode or (
        opts.parallel_linesearch
        and opts.use_backtracking_linesearch
        and opts.ls_phase_split
        and opts.ls_grid_x_only
        and opts.ls_armijo_only
    )
    return (
        ls_ok
        and not opts.parallel_riccati
        and not opts.symmetrize_ctg
        and not opts.exact_al_hessian
        and opts.iteration_callback is None
    )


def open_loop_rollout_tiled(problem: Problem, u, x0):
    """x_{k+1} = f(x_k, u_k) from x0 [n, B]; returns [N+1, n, B]."""
    xs = [x0]
    for k in range(problem.N):
        xs.append(problem.dyn_step(k, xs[-1], u[k]))
    return torch.stack(xs)


def _trajectory_convals_tiled(problem: Problem, x, u):
    N = problem.N
    ks = torch.arange(N, device=x.device)
    kN = torch.full((1,), N, dtype=torch.long, device=x.device)
    stage = al.constraint_values(problem, ks, x[:N], u)
    term = al.constraint_values(problem, kN, x[N:], x.new_zeros((1, problem.m, x.shape[-1])))
    return tuple(torch.cat([s, t], dim=0) for s, t in zip(stage, term))


_CARRY = ("x", "u", "y", "z", "rho", "K", "d", "P", "p", "reg", "convals", "A",
          "B", "iter", "status", "stop", "phi", "alpha", "stat", "feas",
          "ls_iters", "ls_fails", "bp_fail_index")


def _freeze(active, new: dict, old: dict) -> dict:
    """Per-lane freeze: inactive lanes keep every carried value."""
    out = {}
    for name in _CARRY:
        a, b = new[name], old[name]
        if isinstance(a, tuple):
            out[name] = tuple(torch.where(active, x, y) for x, y in zip(a, b))
        else:
            out[name] = torch.where(active, a, b)
    return out


def solve_tiled(problem: Problem, state: SolverState,
                opts: SolverOptions = SolverOptions()):
    """Lane-minor batched solve. Returns (SolverState, SolveStats), the
    state lane-minor and the stats [B] per lane.

    problem.x0 is [n, B]; the cost, the constraints and h are shared by
    all lanes. On CUDA tensors the backward pass and the line-search
    rollout run the CUDA kernels (or raise); on CPU tensors their plain
    versions.
    """
    if not supported_options(opts):
        raise ValueError(
            "solve_tiled supports the phase-split x-only armijo-only grid "
            "line search or rti_mode; other configurations are not ported")
    N = problem.N
    dtype, dev = state.x.dtype, state.x.device
    Bsz = state.x.shape[-1]
    lane = dict(dtype=dtype, device=dev)
    diag = opts.diag_expansion and al.diag_expansion_eligible(problem)

    def full(v, dt=None):
        return torch.full((Bsz,), v, dtype=dt or dtype, device=dev)

    rho0 = full(opts.penalty_initial)
    if opts.penalty_warm_start:
        rho0 = torch.clamp(state.rho * opts.penalty_warm_start_decay,
                           min=opts.penalty_initial, max=opts.penalty_max)
    x0 = problem.x0
    x_init = open_loop_rollout_tiled(problem, state.u, x0)
    convals0 = _trajectory_convals_tiled(problem, x_init, state.u)
    A0, B0, _, _ = ti.completion_tiled(problem, x_init, state.u, state.z, rho0)

    W = int(opts.ls_parallel_width)
    n_blocks = max(1, -(-int(opts.ls_max_iters) // W))
    beta = opts.ls_beta_decrease
    c1 = opts.ls_c1
    slack = opts.ls_armijo_slack
    fallback = opts.ls_best_decrease_fallback
    stacks = affine_constraint_stacks(problem) if x0.is_cuda else None

    c = dict(
        x=x_init, u=state.u, y=state.y, z=state.z, rho=rho0, K=state.K,
        d=state.d, P=state.P, p=state.p, reg=full(opts.reg_initial),
        convals=convals0, A=A0, B=B0,
        iter=full(0, torch.int32), status=full(_UNSOLVED, torch.int32),
        stop=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        phi=full(0.0), alpha=full(0.0), stat=full(math.inf),
        feas=full(math.inf), ls_iters=full(0, torch.int32),
        ls_fails=full(0, torch.int32), bp_fail_index=full(N, torch.int32),
    )

    def lane_active(c):
        return torch.logical_and(~c["stop"], c["iter"] < opts.iterations_max)

    def grid(alphas, c, g):
        # the kernels take contiguous operands (a no-op copy when they are)
        return rollout_grid(problem, c["x"].contiguous(), c["u"].contiguous(),
                            g.K, g.d, c["z"], c["rho"].contiguous(), alphas,
                            x0.contiguous(), stacks=stacks)

    active = lane_active(c)
    while bool(torch.any(active)):
        # 1-2. expansions + backward pass with adaptive reg retry
        lx, lu, lxx, luu, lux, phi0 = ti.cost_expansions_tiled(
            problem, c["x"], c["u"], c["z"], c["rho"], diag=diag)

        ops = [t.contiguous() for t in (c["A"], c["B"], lxx, luu, lx, lu)]

        def attempt(reg):
            return riccati_backward(*ops, reg.contiguous(), lux=lux, diag_cost=diag,
                                    symmetrize=opts.symmetrize_ctg)

        g, reg_used = ti.retry_tiled(opts, attempt, c["reg"])
        bp_failed = ~g.ok

        # 3. dphi(0) from the expected-decrease identity
        dphi0 = g.delta_V[0]
        grad_small = torch.abs(dphi0) < opts.tol_meritfun_gradient

        # 4. line search: parallel x-only grid, or the RTI full step
        if opts.rti_mode:
            # one trial at alpha = 1 through the same rollout (W = 1)
            phi1, xs1 = grid(torch.ones(1, **lane), c, g)
            phi_acc, xsel = phi1[0], xs1[0]
            alpha_acc = full(1.0)
            use_ls = torch.ones(Bsz, dtype=torch.bool, device=dev)
            ls_failed = ~use_ls
            ls_iters = full(1, torch.int32)
        else:
            def eval_block(block):
                ks = block * W + torch.arange(W, device=dev)
                alphas = torch.full((W,), beta, **lane) ** ks.to(dtype)
                phis, xstacks = grid(alphas, c, g)
                armijo = phis <= (phi0[None] + c1 * alphas[:, None] * dphi0[None]
                                  + slack * torch.abs(phi0)[None])
                sel = ti.select_trial_tiled(armijo, alphas, phis, xstacks)
                best = ti.select_best_tiled(alphas, phis, xstacks) if fallback else ()
                return sel, best

            (found, k_acc, alpha_acc, phi_acc, xsel), best = eval_block(0)
            if fallback:
                balpha, bphi, bx = best
            blk = 1
            while blk < n_blocks and bool(torch.any(~found)):
                (f2, idx2, a2, p2, x2), best2 = eval_block(blk)
                take = torch.logical_and(~found, f2)
                k_acc = torch.where(take, blk * W + idx2, k_acc)
                alpha_acc = torch.where(take, a2, alpha_acc)
                phi_acc = torch.where(take, p2, phi_acc)
                xsel = torch.where(take, x2, xsel)
                found = torch.logical_or(found, f2)
                if fallback:
                    ba2, bp2, bx2 = best2
                    tb = bp2 < bphi
                    balpha = torch.where(tb, ba2, balpha)
                    bphi = torch.where(tb, bp2, bphi)
                    bx = torch.where(tb, bx2, bx)
                blk += 1

            not_descent = dphi0 >= 0
            ls_ok = torch.logical_and(found, ~not_descent)
            ls_failed = torch.logical_and(~grad_small, ~ls_ok)
            if fallback:
                fb = torch.logical_and(~ls_ok, bphi < phi0)
                alpha_acc = torch.where(fb, balpha, alpha_acc)
                phi_acc = torch.where(fb, bphi, phi_acc)
                xsel = torch.where(fb, bx, xsel)
            else:
                fb = torch.zeros_like(ls_ok)
            use_ls = torch.logical_and(torch.logical_or(ls_ok, fb), ~grad_small)
            ls_iters = torch.where(ls_ok, k_acc + 1,
                                   torch.full_like(k_acc, opts.ls_max_iters)).to(torch.int32)
            zero_alpha = torch.logical_and(
                torch.logical_or(grad_small, not_descent),
                ~torch.logical_and(fb, ~grad_small))
            alpha_acc = torch.where(zero_alpha, torch.zeros_like(alpha_acc), alpha_acc)

        # 5. accepted payload on the blended trajectory (failed lanes at
        #    alpha = 0, x = reference)
        x_m = torch.where(use_ls, xsel, c["x"])
        alpha_m = torch.where(use_ls, alpha_acc, torch.zeros_like(alpha_acc))
        phi_m = torch.where(use_ls, phi_acc, phi0)
        u_m, y_m, convals_m, zproj_m = ti.light_from_xstack_tiled(
            problem, x_m, c["x"], c["u"], g.K, g.d, g.P, g.p, c["z"], c["rho"], alpha_m)
        A_m, B_m, lx_m, lu_m = ti.completion_tiled(problem, x_m, u_m, c["z"], c["rho"])

        # 6. optimality criteria
        stat = stationarity(A_m, B_m, lx_m, lu_m, y_m)
        feas = feasibility(problem, convals_m)
        stat_tol = full(opts.tol_stationarity)
        if opts.tol_stationarity_rel > 0:
            scale = torch.maximum(
                torch.maximum(torch.abs(lx_m).flatten(0, -2).amax(0),
                              torch.abs(lu_m).flatten(0, -2).amax(0)),
                torch.abs(y_m).flatten(0, -2).amax(0))
            stat_tol = torch.maximum(stat_tol, opts.tol_stationarity_rel * scale)
        no = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        x_oob, u_oob, obj_exceeded = no, no, no
        if math.isfinite(opts.max_state_value):
            x_oob = torch.abs(x_m).flatten(0, -2).amax(0) > opts.max_state_value
        if math.isfinite(opts.max_input_value):
            u_oob = torch.abs(u_m).flatten(0, -2).amax(0) > opts.max_input_value
        if math.isfinite(opts.max_objective_value):
            obj_exceeded = torch.logical_or(~torch.isfinite(phi_m),
                                            phi_m > opts.max_objective_value)
        diverged = obj_exceeded | x_oob | u_oob

        converged = torch.logical_and(torch.abs(stat) < stat_tol,
                                      feas < opts.tol_primal_feasibility)
        if opts.enable_cost_tolerance:
            cost_converged = (c["iter"] > 0) & (torch.abs(c["phi"] - phi_m) < opts.tol_cost) \
                & (feas < opts.tol_primal_feasibility)
            converged = converged | cost_converged

        # 7. adaptive dual/penalty update
        do_dual = stat < torch.sqrt(torch.tensor(opts.tol_stationarity, **lane))
        z_new = tuple(
            torch.where(do_dual & spec.active[:, None, None], zp, zj)
            for spec, zp, zj in zip(problem.constraints, zproj_m, c["z"]))
        do_penalty = do_dual & (feas > opts.tol_primal_feasibility)
        rho_new = torch.where(
            do_penalty, torch.clamp(c["rho"] * opts.penalty_scaling, max=opts.penalty_max),
            c["rho"])

        # status chain (MERIT_FUN_GRADIENT_TOO_SMALL sticky only while small)
        def code(s):
            return torch.full((Bsz,), int(s), dtype=torch.int32, device=dev)

        prev_status = torch.where(
            c["status"] == int(SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL),
            code(SolveStatus.UNSOLVED), c["status"])
        status = prev_status
        grad_small_stat = no if opts.rti_mode else grad_small
        for cond_, s in ((grad_small_stat, SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL),
                         (u_oob, SolveStatus.INPUT_OUT_OF_BOUNDS),
                         (x_oob, SolveStatus.STATE_OUT_OF_BOUNDS),
                         (obj_exceeded, SolveStatus.MAX_OBJECTIVE_EXCEEDED),
                         (bp_failed, SolveStatus.BACKWARD_PASS_FAILED),
                         (ls_failed, SolveStatus.LINE_SEARCH_FAILED),
                         (converged, SolveStatus.SUCCESS)):
            status = torch.where(cond_, code(s), status)
        ls_fails_new = c["ls_fails"] + ls_failed.to(torch.int32)
        if opts.ls_failure_recovery:
            reg_cap = opts.reg_min * opts.reg_scaling ** opts.reg_max_retries
            escalated = torch.clamp(
                torch.where(reg_used <= 0, torch.full_like(reg_used, opts.reg_min),
                            reg_used * opts.reg_scaling), max=reg_cap)
            reg_used = torch.where(ls_failed, escalated, reg_used)
            cleared = ~ls_failed & ~converged & (
                c["status"] == int(SolveStatus.LINE_SEARCH_FAILED))
            status = torch.where(cleared, code(SolveStatus.UNSOLVED), status)
            cap = opts.ls_recovery_max_fails
            exhausted = (ls_failed & (ls_fails_new > cap)) if cap > 0 else no
            stop = converged | bp_failed | exhausted
        else:
            stop = converged | ls_failed | bp_failed
        stop = stop | diverged

        new = dict(
            x=x_m, u=u_m, y=y_m, z=z_new, rho=rho_new, K=g.K, d=g.d, P=g.P,
            p=g.p, reg=reg_used, convals=convals_m, A=A_m, B=B_m,
            iter=c["iter"] + 1, status=status, stop=stop, phi=phi_m,
            alpha=alpha_m, stat=stat, feas=feas, ls_iters=ls_iters,
            ls_fails=ls_fails_new, bp_fail_index=g.fail_index.to(torch.int32),
        )
        c = _freeze(active, new, c)
        active = lane_active(c)

    status = torch.where(
        (c["status"] == _UNSOLVED) & (c["iter"] >= opts.iterations_max),
        torch.full_like(c["status"], int(SolveStatus.MAX_ITERATIONS)), c["status"])
    new_state = SolverState(
        x=c["x"], u=c["u"], y=c["y"], z=c["z"], rho=c["rho"], K=c["K"],
        d=c["d"], P=c["P"], p=c["p"], reg=c["reg"])
    stats = SolveStats(
        status=status,
        iterations=c["iter"],
        objective_value=total_cost(problem, c["x"], c["u"]),
        merit_value=c["phi"],
        stationarity=c["stat"],
        primal_feasibility=c["feas"],
        complementarity=complementarity(problem, c["convals"], c["z"]),
        rho=c["rho"],
        alpha=c["alpha"],
        ls_iterations=c["ls_iters"],
        dphi=torch.full((Bsz,), math.nan, **lane),
        bp_fail_index=c["bp_fail_index"],
    )
    return new_state, stats
