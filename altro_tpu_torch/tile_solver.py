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

The iteration itself is `lane_loop`, shared with the vmapped solve of
parallel/batch.py (`vmap_solve`), which adds what `jax.vmap(solve)` has
and `solve_tiled` lacks: dense expansions, the dense backward kernel
(`pallas_backward`), the strong-Wolfe test on the grid's first trial,
the strong-Wolfe cubic search and the sequential backtracking as a
per-lane machine, the non-split grid and per-lane cost rows.
On CUDA tensors the loop runs kernels or is refused before it starts:
`kernel_refusal` names every kernel it would launch that cannot take the
problem, and the entry points raise with that reason.

The JAX `lax.while_loop`s become Python `while` loops on a device-side
`any(...)`: one host sync per solver trip (and one per retry or extra
line-search block). The trip count is not fixed: a tick whose lanes all
converge after one trip pays one trip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from altro_tpu_torch import al
from altro_tpu_torch.linesearch import LineSearchOptions, Trace, _where, wolfe_line_search_lanes
from altro_tpu_torch.ops import tile_iter as ti
from altro_tpu_torch.ops.riccati_backward import (
    KERNEL_SHAPES,
    riccati_backward,
    riccati_backward_ref,
)
from altro_tpu_torch.ops.riccati_dense import riccati_backward_dense
from altro_tpu_torch.ops.rollout_grid import (
    affine_constraint_stacks,
    ineligibility,
    lane_rows,
    rollout_grid,
    rollout_grid_ref,
)
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import Problem
from altro_tpu_torch.options import Verbosity
from altro_tpu_torch.solver import (
    SolverState,
    SolveStats,
    al_total_cost_lanes,
    banner_end,
    banner_start,
    complementarity,
    emit,
    iteration_update,
    reports,
    total_cost,
)
from altro_tpu_torch.status import LineSearchCode, SolveStatus

__all__ = [
    "solve_tiled",
    "lane_loop",
    "batch_to_lanes",
    "lanes_to_batch",
    "state_to_lanes",
    "state_from_lanes",
    "shift_trajectory_tiled",
    "supported_options",
    "kernel_refusal",
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
        and opts.iteration_callback is None
    )


def kernel_refusal(problem: Problem, opts: SolverOptions, *, vmapped: bool) -> Optional[str]:
    """Why the lane loop's CUDA kernels cannot take this problem with these
    options, or None. One message names every kernel the loop would launch
    (vmapped=False: `solve_tiled`; True: the vmapped solve) and what that
    kernel cannot take:

    * the backward pass (`riccati_backward`, or `riccati_dense` for the
      vmapped solve with `pallas_backward`; without it the vmapped solve
      runs the plain recursion): (n, m) outside KERNEL_SHAPES, a dtype
      other than float32;
    * the trial grid of `solve_tiled` when `pallas_rollout_tiled` (the
      vmapped solve always runs the plain grid):
      `rollout_grid.ineligibility`, a dtype other than float32.

    Shapes and options only, so it runs before anything launches.
    """
    shape = (problem.n, problem.m)
    dtype = problem.dtype
    f32 = dtype == torch.float32
    why = []
    if not vmapped or opts.pallas_backward:
        bad = []
        if shape not in KERNEL_SHAPES:
            bad.append(f"no instantiation for n={shape[0]}, m={shape[1]} (it has "
                       f"{', '.join(map(str, KERNEL_SHAPES))})")
        if not f32:
            bad.append(f"{dtype} (it takes float32)")
        if bad:
            name = "riccati_dense" if vmapped else "riccati_backward"
            why.append(f"the backward kernel ({name}): {', '.join(bad)}")
    if not vmapped and opts.pallas_rollout_tiled:
        grid_why = ineligibility(problem) or (None if f32 else f"{dtype} (it takes float32)")
        if grid_why is not None:
            why.append(f"the trial-grid kernel (rollout_grid): {grid_why}; "
                       "pallas_rollout_tiled=False selects the plain grid")
    return "; ".join(why) or None


def refuse_on_card(who: str, problem: Problem, opts: SolverOptions, *, vmapped: bool) -> None:
    """Raise NotImplementedError(f"{who}: ...") when the problem lies on a
    CUDA device and `kernel_refusal` names a reason."""
    if problem.x0.is_cuda:
        why = kernel_refusal(problem, opts, vmapped=vmapped)
        if why is not None:
            raise NotImplementedError(f"{who}: {why}")


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
          "B", "iter", "status", "stop", "phi", "dphi", "alpha", "stat", "feas",
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


def search_kind(opts: SolverOptions, vmapped: bool) -> str:
    """The line search `lane_loop` runs: "rti" (the full step), and for the
    vmapped solve "sequential" (parallel_linesearch=False: the strong-Wolfe
    cubic search, or with use_backtracking_linesearch the sequential
    backtracking) or "grid" (the non-split grid, ls_phase_split=False);
    else "split" (the phase-split x-only grid, the only one `solve_tiled`
    takes)."""
    if opts.rti_mode:
        return "rti"
    if vmapped and not opts.parallel_linesearch:
        return "sequential"
    if vmapped and not opts.ls_phase_split:
        return "grid"
    return "split"


def solve_tiled(problem: Problem, state: SolverState,
                opts: SolverOptions = SolverOptions(), layer_seconds: Optional[dict] = None):
    """Lane-minor batched solve. Returns (SolverState, SolveStats), the
    state lane-minor and the stats [B] per lane.

    problem.x0 is [n, B]. Each leaf of the DiagonalCost (Q, q, R, r, c)
    and h is shared by all lanes or holds one row per lane on a trailing
    lane axis, leaf by leaf, as JAX's `prob_axes` batches them; the
    constraints are shared. The backward kernel (csrc/riccati_dense.cu)
    takes the expansions per lane whatever the cost's leaves are; the
    trial-grid kernel reads per-lane rows in its LANE_COST
    instantiations (`rollout_grid.lane_rows`, once a solve). On CUDA
    tensors the backward pass runs its kernel and the line-search rollout
    its kernel when `pallas_rollout_tiled` (the plain grid otherwise, on
    any device); a problem they cannot take is refused before anything
    runs (`kernel_refusal`). On CPU tensors the plain
    versions run. `pallas_backward` is not read (as in JAX) and
    stats.dphi is NaN. layer_seconds: as `lane_loop`'s.
    """
    if not supported_options(opts):
        raise ValueError(
            "solve_tiled supports the phase-split x-only armijo-only grid "
            "line search or rti_mode; other configurations are not ported")
    refuse_on_card("solve_tiled", problem, opts, vmapped=False)
    return lane_loop(problem, state, opts, vmapped=False, trace=Trace(layer_seconds))


def lane_loop(problem: Problem, state: SolverState, opts: SolverOptions, *,
              vmapped: bool, trace: Optional[Trace] = None):
    """The lane-minor AL-iLQR iteration shared by `solve_tiled`
    (vmapped=False) and parallel.batch's vmapped solve (vmapped=True).

    vmapped=True gives the per-lane semantics of `jax.vmap(solve)`:
    dense expansions whenever `pallas_backward`, `exact_al_hessian` (the
    exact AL Hessian), `not diag_expansion` or the problem is not
    diag-eligible (altro_tpu/solver.py:747-753, 832-837); the
    backward pass through ops/riccati_dense.py (the kernel on CUDA, its
    plain version on the CPU) when `pallas_backward`, else the plain
    recursion on any device; every line search of `jax.vmap(solve)`
    but the light-payload grid (`search_kind`): the strong-Wolfe cubic
    search or the sequential backtracking as a per-lane machine
    (`linesearch.wolfe_line_search_lanes` over `tile_iter.merit_tiled`,
    each lane at its own alpha), the non-split grid (trial 0 held to
    strong Wolfe, altro_tpu/linesearch.py:546-668), the phase-split grid
    (trial 0 held to strong Wolfe unless `ls_armijo_only`), each grid
    through the plain trial rollout; a lane takes its search's payload
    or, failing, merit(0) (`tile_iter.alpha0_payload_tiled`), and
    stats.dphi from it. vmapped=False runs the phase-split grid or RTI,
    the trial-grid kernel (`rollout_grid`) when `pallas_rollout_tiled`,
    else the plain grid, as altro_tpu/tile_solver.py:329-342 does, and
    completes the blended trajectory. The caller checks the options and
    the kernels' reach (`kernel_refusal`).

    trace: a `linesearch.Trace` to accumulate into. Its seconds, by layer,
    each exclusive of the others: open_loop_rollout, expansions, backward
    (with its retry syncs), grid (the trial rollouts, with the syncs of
    extra blocks), wolfe_completion (trial 0's payload and dphi),
    sequential_search (the per-lane machine: its merit evaluations and
    one host read a pass), select, completion (the accepted payload),
    update and sync (the wait on the loop condition).

    Its counts: "syncs" (host reads: the loop condition, retries, grid
    blocks, machine passes), "passes" (the machine's loop passes) and,
    when vmapped, "trials" ([B], each lane's ls_iterations summed over the
    iterations it ran).

    vmapped=True also reports as `jax.vmap(solve)` does through its debug
    callbacks (altro_tpu/solver.py:790, :1176-1200, :1232): at a non-silent
    verbosity each lane's first line (its initial AL cost); every trip,
    for every lane in lane order, the frozen ones included (a batched
    while loop runs its body for every lane), `iteration_callback(iter,
    phi, stat, feas, alpha, rho)` and the INNER line, or at OUTER the
    outer line; and each lane's last line. One host read a trip; nothing
    at SILENT without a callback. JAX prints the lanes' lines unordered
    within a trip; the port prints them in lane order.
    """
    trace = trace or Trace()
    trace.start()
    lap = trace.lap
    N = problem.N
    dtype, dev = state.x.dtype, state.x.device
    Bsz = state.x.shape[-1]
    lane = dict(dtype=dtype, device=dev)
    fused = vmapped and opts.pallas_backward
    # the exact AL Hessian (dense) in the vmapped solve; JAX's solve_tiled
    # accepts the option and does not read it
    exact = vmapped and opts.exact_al_hessian
    diag = (opts.diag_expansion and al.diag_expansion_eligible(problem) and not fused
            and not exact)
    search = search_kind(opts, vmapped)
    # trial 0 of a grid passes on Armijo and strong Wolfe: the non-split grid
    # always, the phase-split one in the vmapped solve unless ls_armijo_only
    wolfe_first = search == "grid" or (search == "split" and vmapped
                                       and not opts.ls_armijo_only)
    # the payload's dphi is NaN where JAX skips the sensitivity scan
    # (ls_armijo_only on a phase-split path) and in solve_tiled's stats
    skip_dphi = opts.ls_armijo_only and (
        search == "split" or (search == "rti" and opts.ls_phase_split))
    with_dphi = vmapped and not skip_dphi
    fallback = search == "split" and opts.ls_best_decrease_fallback
    ls_opts = LineSearchOptions(
        c1=opts.ls_c1, c2=opts.ls_c2, max_iters=opts.ls_max_iters,
        alpha_max=opts.ls_alpha_max, beta_increase=opts.ls_beta_increase,
        beta_decrease=opts.ls_beta_decrease, min_interval_size=opts.ls_min_interval_size,
        try_cubic_first=opts.ls_try_cubic_first,
        use_backtracking=opts.use_backtracking_linesearch, armijo_slack=opts.ls_armijo_slack)

    def full(v, dt=None):
        return torch.full((Bsz,), v, dtype=dt or dtype, device=dev)

    rho0 = full(opts.penalty_initial)
    if opts.penalty_warm_start:
        rho0 = torch.clamp(state.rho * opts.penalty_warm_start_decay,
                           min=opts.penalty_initial, max=opts.penalty_max)
    x0 = problem.x0
    x_init = open_loop_rollout_tiled(problem, state.u, x0)
    lap("open_loop_rollout")
    convals0 = _trajectory_convals_tiled(problem, x_init, state.u)
    A0, B0, _, _ = ti.completion_tiled(problem, x_init, state.u, state.z, rho0)

    W = int(opts.ls_parallel_width)
    n_blocks = max(1, -(-int(opts.ls_max_iters) // W))
    beta = opts.ls_beta_decrease
    c1 = opts.ls_c1
    c2 = opts.ls_c2
    slack = opts.ls_armijo_slack
    kernel_grid = not vmapped and opts.pallas_rollout_tiled
    stacks = rows = None
    if x0.is_cuda and kernel_grid:  # the kernel's constraint stacks and cost rows, once
        stacks = affine_constraint_stacks(problem)
        rows = lane_rows(problem, Bsz)

    report = vmapped and reports(opts)
    if vmapped and opts.verbose > Verbosity.SILENT:  # each lane's first line
        for cost in al_total_cost_lanes(problem, x_init, state.u, state.z, rho0).tolist():
            banner_start(cost)

    c = dict(
        x=x_init, u=state.u, y=state.y, z=state.z, rho=rho0, K=state.K,
        d=state.d, P=state.P, p=state.p, reg=full(opts.reg_initial),
        convals=convals0, A=A0, B=B0,
        iter=full(0, torch.int32), status=full(_UNSOLVED, torch.int32),
        stop=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        phi=full(0.0), dphi=full(0.0), alpha=full(0.0), stat=full(math.inf),
        feas=full(math.inf), ls_iters=full(0, torch.int32),
        ls_fails=full(0, torch.int32), bp_fail_index=full(N, torch.int32),
    )

    def lane_active(c):
        return torch.logical_and(~c["stop"], c["iter"] < opts.iterations_max)

    def grid(alphas, c, g):
        if not kernel_grid:  # as jax.vmap(solve) and pallas_rollout_tiled=False: the scan grid
            return rollout_grid_ref(problem, c["x"], c["u"], g.K, g.d, c["z"], c["rho"],
                                    alphas, x0)
        # the kernels take contiguous operands (a no-op copy when they are)
        return rollout_grid(problem, c["x"].contiguous(), c["u"].contiguous(),
                            g.K, g.d, tuple(zj.contiguous() for zj in c["z"]),
                            c["rho"].contiguous(), alphas,
                            x0.contiguous(), stacks=stacks, rows=rows)

    def dphi_at(x, alpha, c, g):
        """The merit derivative along the trial rolled out to x: its
        payload completed, then the forward-sensitivity recurrence."""
        u = ti.light_from_xstack_tiled(problem, x, c["x"], c["u"], g.K, g.d, g.P, g.p,
                                       c["z"], c["rho"], alpha)[0]
        A, B, lx, lu = ti.completion_tiled(problem, x, u, c["z"], c["rho"])
        return ti.merit0_derivative_tiled(A, B, g.K, g.d, lx, lu)

    active = lane_active(c)
    lap("expansions")
    while trace.read(torch.any(active)):
        lap("sync")
        # 1-2. expansions + backward pass with adaptive reg retry
        lx, lu, lxx, luu, lux, phi0 = ti.cost_expansions_tiled(
            problem, c["x"], c["u"], c["z"], c["rho"], diag=diag, exact=exact)
        lap("expansions")

        ops = [t.contiguous() for t in (c["A"], c["B"], lxx, luu, lx, lu)]
        lux = None if lux is None else lux.contiguous()

        if fused:
            def attempt(reg):
                A, B, lxx_, luu_, lx_, lu_ = ops
                return riccati_backward_dense(A, B, None, lxx_, luu_, lux, lx_, lu_,
                                              reg.contiguous())
        elif vmapped:
            def attempt(reg):
                return riccati_backward_ref(*ops, reg, lux=lux)
        else:
            def attempt(reg):
                # symmetrize_ctg is not passed: P is symmetric by construction,
                # as JAX's tiled kernel accepts and ignores it
                return riccati_backward(*ops, reg.contiguous(), lux=lux, diag_cost=diag)

        g, reg_used = ti.retry_tiled(opts, attempt, c["reg"], trace)
        bp_failed = ~g.ok
        lap("backward")

        # 3. dphi(0) from the expected-decrease identity
        dphi0 = g.delta_V[0]
        grad_small = torch.abs(dphi0) < opts.tol_meritfun_gradient

        def payload_at(x, alpha, phi, with_dphi=with_dphi):
            return ti.payload_tiled(problem, x, alpha, phi, c["x"], c["u"], g.K, g.d, g.P,
                                    g.p, c["z"], c["rho"], with_dphi)

        payload0 = None
        if vmapped:  # merit(0) from the cached data, the payload of failed searches
            payload0 = ti.alpha0_payload_tiled(problem, c["x"], c["u"], g.p, c["z"], c["rho"],
                                               c["convals"], c["A"], c["B"], lx, lu, phi0,
                                               dphi0)

        # 4. line search: the sequential machine, a grid, or the RTI full step;
        #    each gives per lane (alpha, code, n_iters, aux_alpha) and the trial
        #    it took (x_sel, alpha_sel, phi_sel), or the machine its payload
        payload_ls = None
        if search == "rti":
            # one trial at alpha = 1 through the same rollout (W = 1)
            phi1, xs1 = grid(torch.ones(1, **lane), c, g)
            lap("grid")
            x_sel, alpha_sel, phi_sel = xs1[0], full(1.0), phi1[0]
            ls_alpha, code = alpha_sel, full(int(LineSearchCode.MINIMUM_FOUND), torch.int32)
            n_iters, aux_alpha = full(1, torch.int32), alpha_sel
        elif search == "sequential":
            def merit_full(alpha):
                return ti.merit_tiled(problem, c["x"], c["u"], g.K, g.d, g.P, g.p, c["z"],
                                      c["rho"], alpha, x0)

            # a reporting solve searches every lane, as JAX's batched body does
            # (the frozen lanes' reports show that search; _freeze drops it)
            ls = wolfe_line_search_lanes(merit_full, phi0, dphi0, 1.0, ls_opts, aux0=payload0,
                                         active=torch.ones_like(active) if report else active,
                                         trace=trace)
            lap("sequential_search")
            payload_ls = ls.aux
            ls_alpha, code, n_iters, aux_alpha = ls.alpha, ls.code, ls.n_iters, ls.aux_alpha
        else:
            def eval_block(block):
                ks = block * W + torch.arange(W, device=dev)
                alphas = torch.full((W,), beta, **lane) ** ks.to(dtype)
                phis, xstacks = grid(alphas, c, g)
                lap("grid")
                armijo = phis <= (phi0[None] + c1 * alphas[:, None] * dphi0[None]
                                  + slack * torch.abs(phi0)[None])
                if block == 0 and wolfe_first:
                    # trial 0 passes on Armijo and strong Wolfe, the rest on Armijo
                    dphi_first = dphi_at(xstacks[0], alphas[0], c, g)
                    armijo[0] &= torch.abs(dphi_first) <= -c2 * dphi0
                    lap("wolfe_completion")
                sel = ti.select_trial_tiled(armijo, alphas, phis, xstacks)
                best = ti.select_best_tiled(alphas, phis, xstacks) if fallback else ()
                return sel, best

            (found, k_acc, alpha_sel, phi_sel, x_sel), best = eval_block(0)
            if fallback:
                balpha, bphi, bx = best
            blk = 1
            while blk < n_blocks and trace.read(torch.any(~found & active)):
                (f2, idx2, a2, p2, x2), best2 = eval_block(blk)
                # a lane still searching takes this block's first passing trial,
                # or its first trial (the JAX loop's body runs for it)
                upd = ~found
                k_acc = torch.where(upd, blk * W + idx2, k_acc)
                alpha_sel = torch.where(upd, a2, alpha_sel)
                phi_sel = torch.where(upd, p2, phi_sel)
                x_sel = torch.where(upd, x2, x_sel)
                found = torch.logical_or(found, f2)
                if fallback:
                    ba2, bp2, bx2 = best2
                    tb = bp2 < bphi
                    balpha = torch.where(tb, ba2, balpha)
                    bphi = torch.where(tb, bp2, bphi)
                    bx = torch.where(tb, bx2, bx)
                blk += 1

            not_descent = dphi0 >= 0
            ok = torch.logical_and(found, ~not_descent)
            fb = torch.zeros_like(ok)
            if fallback:  # the lowest-merit trial when it decreases the merit
                fb = torch.logical_and(~ok, bphi < phi0)
                alpha_sel = torch.where(fb, balpha, alpha_sel)
                phi_sel = torch.where(fb, bphi, phi_sel)
                x_sel = torch.where(fb, bx, x_sel)
            def code_of(c):
                return full(int(c), torch.int32)

            code = torch.where(ok, code_of(LineSearchCode.MINIMUM_FOUND),
                               torch.where(fb, code_of(LineSearchCode.BEST_DECREASE),
                                           torch.where(not_descent,
                                                       code_of(LineSearchCode.NOT_DESCENT_DIRECTION),
                                                       code_of(LineSearchCode.NO_ERROR))))
            take = ok | fb
            if search == "grid":  # no trial passes: the first of the last block
                ls_alpha = torch.where(not_descent, torch.zeros_like(alpha_sel), alpha_sel)
            else:
                ls_alpha = torch.where(take, alpha_sel, torch.zeros_like(alpha_sel))
            aux_alpha = torch.where(take, alpha_sel, full(math.nan))
            n_iters = torch.where(ok, k_acc + 1,
                                  torch.full_like(k_acc, opts.ls_max_iters)).to(torch.int32)

        # acceptance (altro_tpu/solver.py:986-1019): MINIMUM_FOUND or
        # HIT_MAX_STEPSIZE pass; BEST_DECREASE is taken but fails the status;
        # a lane takes its search's payload only at the alpha it returns
        if search == "rti":
            alpha_st = ls_alpha
            use_ls = torch.ones(Bsz, dtype=torch.bool, device=dev)
            ls_failed = ~use_ls
        else:
            alpha_st = torch.where(grad_small, torch.zeros_like(ls_alpha), ls_alpha)
            ls_ok = (code == int(LineSearchCode.MINIMUM_FOUND)) | (
                code == int(LineSearchCode.HIT_MAX_STEPSIZE))
            ls_failed = ~grad_small & (torch.isnan(alpha_st) | ~ls_ok)
            accepted = ls_ok | (code == int(LineSearchCode.BEST_DECREASE))
            use_ls = accepted & ~grad_small & (aux_alpha == alpha_st)
        ls_iters = n_iters
        lap("select")

        # 5. the accepted payload, else merit(0); solve_tiled completes the
        #    blended trajectory (failed lanes at alpha = 0, x = reference), as
        #    altro_tpu/tile_solver.py:517-529 does
        if vmapped:
            if payload_ls is None:
                payload_ls = payload_at(x_sel, alpha_sel, phi_sel)
            m = ti.Payload(*_where(use_ls, tuple(payload_ls), tuple(payload0)))
        else:
            m = payload_at(torch.where(use_ls, x_sel, c["x"]),
                           torch.where(use_ls, alpha_sel, torch.zeros_like(alpha_sel)),
                           torch.where(use_ls, phi_sel, phi0), with_dphi=False)
            m = m._replace(dphi=torch.where(use_ls, m.dphi, dphi0))
        lap("completion")

        # 6-7. criteria, dual/penalty update and status chain
        upd = iteration_update(
            problem, opts, m, z=c["z"], rho=c["rho"], status=c["status"],
            ls_fails=c["ls_fails"], reg_used=reg_used, phi_prev=c["phi"], it=c["iter"],
            grad_small=grad_small, bp_failed=bp_failed, ls_failed=ls_failed)
        stat, feas, rho_new, do_dual = upd.stat, upd.feas, upd.rho, upd.do_dual

        if report:  # every lane, the frozen ones included, from one host read
            rows = torch.stack([t.to(dtype) for t in (
                c["iter"], phi0, m.phi, dphi0, m.dphi, alpha_st, ls_iters, stat, feas,
                c["rho"], rho_new, do_dual)]).T.tolist()
            for it, *vals in rows:
                emit(opts, int(it), *vals)

        new = dict(
            x=m.x, u=m.u, y=m.y, z=upd.z, rho=rho_new, K=g.K, d=g.d, P=g.P,
            p=g.p, reg=upd.reg, convals=m.convals, A=m.A, B=m.B,
            iter=c["iter"] + 1, status=upd.status, stop=upd.stop, phi=m.phi, dphi=m.dphi,
            alpha=alpha_st, stat=stat, feas=feas, ls_iters=ls_iters,
            ls_fails=upd.ls_fails, bp_fail_index=g.fail_index.to(torch.int32),
        )
        if vmapped:
            trace.add("trials", torch.where(active, ls_iters, torch.zeros_like(ls_iters)))
        c = _freeze(active, new, c)
        active = lane_active(c)
        lap("update")

    if vmapped and opts.verbose > Verbosity.SILENT:  # each lane's last line
        for it, st in zip(c["iter"].tolist(), c["status"].tolist()):
            banner_end(it, st)
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
        dphi=c["dphi"] if vmapped else full(math.nan),
        bp_fail_index=c["bp_fail_index"],
    )
    return new_state, stats
