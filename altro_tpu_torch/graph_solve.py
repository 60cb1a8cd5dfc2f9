"""The AL-iLQR solve as one traceable graph, for export.py.

Counterpart: altro_tpu/solver.py::solve as `jax.export` serializes it,
one lane or under `jax.vmap` (its `lax.while_loop`s lowered into the
artifact). The port's live solves (`solver.solve`, `tile_solver.
lane_loop`) are host loops: a host read a trip on `stop`, one an attempt
of the backward retry, and the line searches' own. `torch.export`
records none of that, so this module runs the same iteration in the form
an exported graph keeps:

* **The trips in torch's while_loop operator, masked per lane.** The
  loop runs while any lane is active (not stopped, under
  `iterations_max`), the lane loop's condition; each lane's carried
  tensors are frozen by `torch.where` once it stops (the lane loop's
  `_freeze`, as JAX's vmapped while loop selects), so `iterations`,
  `status` and `ls_iterations` count each lane's live trips and the
  results equal the live loops' bit for bit in exact arithmetic. A call
  runs the trips its slowest lane needs. Run eagerly (as a loaded
  program is), the operator reads its condition on the host once a trip,
  as the live solve reads `stop`. (A scan of a fixed `iterations_max`
  trips has no host read of its own, but ran 10 trips a call where the
  row's ticks need 1, 576 ms a call on an H100; PERF.md.)
* **The setup and one trip traced once** (`trace_solve`,
  `graph_solve(graphs=...)`). `make_fx` records `initial_carry` and one
  trip below autograd, where the forward-mode Jacobians
  (`problem.lane_jacobian`) become their primal and tangent operators
  (inside a loop operator's body they do not trace; traced by
  `torch.export` itself they leave dual-level calls a loaded program
  cannot replay); the loop runs the trip's graph. An exported program
  holds one trip's operators, not `iterations_max` copies: its tracing,
  saving and loading take a tenth of the time an unrolled graph's took.
  Without `graphs` the trips run as a Python loop (eagerly, the same
  operators in the same order).
* **The backward pass with its retry inside one operator** (ops/
  library.py): one lane runs `altro_tpu_torch::riccati_latency` (the
  latency kernel on CUDA under `pallas_latency_backward`, as
  `solver.backward_adaptive` chooses), a batch
  `altro_tpu_torch::riccati_dense` (the dense kernel under
  `pallas_backward`, else the plain recursion, as the vmapped solve
  chooses). The operator's read of `ok` an attempt and the loop's
  condition are the program's only host reads.
* **The rollouts' knot loop as torch's `scan` operator** (one body in
  the graph, not N), through the problem's own dynamics, with the same
  arithmetic as `rollout_grid.plain_rollout`.
* **The line searches at fixed shapes.** The phase-split x-only grid
  evaluates all its blocks and takes each lane's first passing trial
  (`lane_loop`'s search; the one `mpc_latency_aot` runs). The sequential
  backtracking (`use_backtracking_linesearch` without
  `parallel_linesearch`) evaluates its trials in three stages: alpha = 1
  (strong Wolfe), the one-shot cubic step when `ls_try_cubic_first` asks
  for it (strong Wolfe), then the `max(1, ls_max_iters - 1)` backtracking
  alphas as one batched rollout, first Armijo pass wins; the same
  accepted step, count and code as the per-lane machine
  (`linesearch.wolfe_line_search_lanes`) takes.

One lane is the lane-minor layout with B = 1, so the single-lane and the
batched artifact share every line but the backward's choice. The per-
iteration math after the search (criteria, duals, penalty, status) is
`solver.iteration_update`, which both live solves run too.

What the form does not carry is refused before tracing
(`graph_refusal`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch._higher_order_ops.scan import scan_op
from torch._higher_order_ops.while_loop import while_loop_op
from torch.fx.experimental.proxy_tensor import make_fx

from altro_tpu_torch import al
from altro_tpu_torch.linesearch import _where, cubic_argmin_lanes, cubic_fit_lanes
from altro_tpu_torch.ops import library  # noqa: F401  registers the operators
from altro_tpu_torch.ops import tile_iter as ti
from altro_tpu_torch.ops.riccati_backward import KERNEL_SHAPES as DENSE_SHAPES, Gains
from altro_tpu_torch.ops.riccati_latency import KERNEL_SHAPES as LATENCY_SHAPES
from altro_tpu_torch.ops.rollout_grid import rollout_grid_ref
from altro_tpu_torch.options import SolverOptions, Verbosity
from altro_tpu_torch.problem import Problem, problem_leaves, problem_with_leaves
from altro_tpu_torch.solver import (
    SolverState,
    SolveStats,
    _kernel_grid,
    complementarity,
    iteration_update,
    total_cost,
)
from altro_tpu_torch.status import LineSearchCode, SolveStatus
from altro_tpu_torch.tile_solver import (
    _freeze,
    _trajectory_convals_tiled,
    open_loop_rollout_tiled,
)

__all__ = ["graph_refusal", "graph_solve", "trace_solve", "SolveGraphs", "Traced",
           "initial_carry", "trip", "finish", "scan_rollout"]

_UNSOLVED = int(SolveStatus.UNSOLVED)


def graph_refusal(problem: Problem, opts: SolverOptions, *, single: bool,
                  cuda: bool) -> Optional[str]:
    """Why `graph_solve` cannot carry this configuration, or None: an
    option the graph form does not implement, or, with `cuda` (an
    artifact meant to run on the card), a kernel the options select that
    cannot take the problem. Options and shapes only."""
    checks = (
        (not opts.parallel_linesearch and not opts.use_backtracking_linesearch,
         "the strong-Wolfe search (use_backtracking_linesearch=False)"),
        (opts.parallel_linesearch and not opts.ls_phase_split,
         "the non-split grid (parallel_linesearch without ls_phase_split)"),
        (opts.parallel_linesearch and not opts.ls_grid_x_only,
         "the light-payload grid (ls_grid_x_only=False)"),
        (opts.ls_best_decrease_fallback, "ls_best_decrease_fallback"),
        (opts.rti_mode, "rti_mode"),
        (opts.exact_al_hessian, "exact_al_hessian"),
        (opts.verbose > Verbosity.SILENT, "a verbosity above Verbosity.SILENT"),
        (opts.iteration_callback is not None, "iteration_callback"),
        (opts.parallel_riccati, "parallel_riccati"),
        (single and _kernel_grid(opts),
         "pallas_rollout on one lane (the trial-rollout kernel is not an operator yet; "
         "pallas_rollout=False selects the problem's own grid)"),
    )
    why = [reason for bad, reason in checks if bad]
    if why:
        return "not carried by the exported graph: " + "; ".join(why)
    if not cuda:
        return None
    shape = (problem.n, problem.m)
    if single and opts.pallas_latency_backward and not opts.pallas_backward:
        kernel, shapes, flag = "riccati_latency", LATENCY_SHAPES, "pallas_latency_backward"
    elif not single and opts.pallas_backward:
        kernel, shapes, flag = "riccati_dense", DENSE_SHAPES, "pallas_backward"
    else:
        return None
    bad = []
    if shape not in shapes:
        bad.append(f"no instantiation for n={shape[0]}, m={shape[1]}")
    if problem.dtype != torch.float32:
        bad.append(f"{problem.dtype} (it takes float32)")
    if bad:
        return (f"{flag}: the backward kernel ({kernel}): {', '.join(bad)}; "
                f"{flag}=False selects the plain backward")
    return None


def _standard(t):
    """t with row-major strides (a copy only when it has others): the scan
    operator holds the carry's strides fixed from trip to trip."""
    stride, acc = [], 1
    for size in reversed(t.shape):
        stride.append(acc)
        acc *= size
    return t if t.stride() == tuple(reversed(stride)) else t.clone(
        memory_format=torch.contiguous_format)


def scan(body, init, xs, consts=()):
    """torch's scan operator over the leading axis of the tensors xs:
    body(carry, x_slices, consts) -> (carry', y) with carry one tensor and
    y a tensor or a tuple of tensors; returns (carry, ys stacked). Every
    tensor the body reads comes in through xs or consts (a tensor closed
    over would be a constant of the body's graph, which `torch.export.save`
    does not serialize). The operator itself, not `torch._higher_order_ops.
    scan.scan`: that one compiles each call with dynamo before tracing it
    (seconds a call under `torch.export`), this one is traced by `make_fx`
    alone and runs eagerly as a loop."""
    n_x = len(xs)
    single = []

    def flat(carry, *rest):
        c, y = body(carry, rest[:n_x], rest[n_x:])
        single[:] = [not isinstance(y, tuple)]
        return [c, *((y,) if single[0] else y)]

    out = scan_op(flat, [init], list(xs), tuple(consts))
    return out[0], (out[1] if single[0] else tuple(out[1:]))


def _scan_states(problem: Problem, step_inputs, x_init, policy, consts=()):
    """x_{k+1} = f(x_k, u_k) over the knots with torch's scan operator, the
    state carried in the dynamics' layout [n, W, B]: step_inputs a tuple
    of knot stacks [N, ...] scanned with h and the knot index; policy(x
    [W, n, B], inputs, consts) -> u [W, m, B]; x_init [n, W, B]. Returns
    (xs [W, N+1, n, B], us [W, N, m, B])."""
    ks = torch.arange(problem.N, device=x_init.device)

    def body(x, xs, consts):
        *knot, h_k, k = xs
        u = policy(x.movedim(0, 1), knot, consts)
        x_next = problem.dynamics(x, u.movedim(1, 0), h_k, k)
        return _standard(x_next), (x.clone(), u)

    x_last, (xs, us) = scan(body, _standard(x_init), (*step_inputs, problem.h, ks), consts)
    return torch.cat([xs, x_last[None]], dim=0).permute(2, 0, 1, 3), us.movedim(0, 1)


def scan_rollout(problem: Problem):
    """The W-trial rollout `rollout_grid.plain_rollout` computes, with the
    knot loop as torch's scan operator (the problem's own nonlinear
    dynamics; linear dynamics arrays keep the Python loop). Returns a
    `states` function for `rollout_grid_ref`, or None."""
    if problem.dynamics is None:
        return None

    def states(ref_x, ref_u, K, d, alphas, x0):
        N = problem.N
        W, (n, Bsz) = alphas.shape[0], x0.shape
        a = (alphas[:, None, None] if alphas.ndim == 1 else alphas[:, None, :]).to(x0.dtype)

        def policy(x, knot, consts):
            rx, ru, Kk, dk = knot
            return ru - torch.einsum("jib,wib->wjb", Kk, x - rx) + consts[0] * dk

        x_init = x0[:, None].expand(n, W, Bsz)
        return _scan_states(problem, (ref_x[:N], ref_u, K, d), x_init, policy, (a,))

    return states


def _scan_derivative(A, B, K, d, lx, lu):
    """`tile_iter.merit0_derivative_tiled` with the knot loop as torch's
    scan operator (the same steps, `tile_iter.sensitivity_step`)."""
    N = A.shape[0]

    def body(dx, knot, consts):
        dx_next, contrib = ti.sensitivity_step(dx, knot)
        return _standard(dx_next), contrib

    dx0 = A.new_zeros(A.shape[1:2] + A.shape[3:])
    dx, contribs = scan(body, dx0, (A, B, K, d, lx[:N], lu))
    return torch.sum(contribs, dim=0) + torch.sum(lx[N] * dx, dim=0)


def _open_loop(problem: Problem, u, x0):
    """`tile_solver.open_loop_rollout_tiled` through the scan: [N+1, n, B]."""
    if problem.dynamics is None:
        return open_loop_rollout_tiled(problem, u, x0)
    xs, _ = _scan_states(problem, (u,), x0[:, None],
                         lambda x, knot, consts: knot[0][None].clone())
    return xs[0]


def _alphas(alpha0: float, beta: float, count: int, np_dtype):
    """alpha0 * beta, then times beta again, `count` times, rounded in the
    solve's dtype at every product as the sequential search rounds."""
    out, a = [], np_dtype(alpha0)
    for _ in range(count):
        a = np_dtype(a * np_dtype(beta))
        out.append(float(a))
    return out


_CARRY = ("x", "u", "y", "z", "rho", "K", "d", "P", "p", "reg", "convals", "A", "B", "iter",
          "status", "stop", "phi", "dphi", "alpha", "stat", "feas", "ls_iters", "ls_fails",
          "bp_fail_index")


def initial_carry(problem: Problem, state: SolverState, opts: SolverOptions) -> dict:
    """The loop's carried values before the first trip (the lane loop's):
    the open-loop rollout of the warm start, its constraint values and
    dynamics expansions, the penalty (warm-started or initial) and the
    counters."""
    N = problem.N
    dtype, dev = state.x.dtype, state.x.device
    Bsz = state.x.shape[-1]

    def full(v, dt=None):
        return torch.full((Bsz,), v, dtype=dt or dtype, device=dev)

    rho0 = full(opts.penalty_initial)
    if opts.penalty_warm_start:
        rho0 = torch.clamp(state.rho * opts.penalty_warm_start_decay,
                           min=opts.penalty_initial, max=opts.penalty_max)
    x_init = _open_loop(problem, state.u, problem.x0)
    convals0 = _trajectory_convals_tiled(problem, x_init, state.u)
    A0, B0, _, _ = ti.completion_tiled(problem, x_init, state.u, state.z, rho0)
    return dict(
        x=x_init, u=state.u, y=state.y, z=state.z, rho=rho0, K=state.K,
        d=state.d, P=state.P, p=state.p, reg=full(opts.reg_initial),
        convals=convals0, A=A0, B=B0,
        iter=full(0, torch.int32), status=full(_UNSOLVED, torch.int32),
        stop=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        phi=full(0.0), dphi=full(0.0), alpha=full(0.0), stat=full(math.inf),
        feas=full(math.inf), ls_iters=full(0, torch.int32),
        ls_fails=full(0, torch.int32), bp_fail_index=full(N, torch.int32),
    )


def trip(problem: Problem, opts: SolverOptions, single: bool, c: dict) -> dict:
    """One trip of the loop for every lane: expansions, the backward
    operator with its retry, the line search at fixed shapes, the payload
    taken or merit(0), `solver.iteration_update`; lanes that had stopped
    keep every carried value (`tile_solver._freeze`)."""
    dtype, dev = c["x"].dtype, c["x"].device
    Bsz = c["x"].shape[-1]
    lane = dict(dtype=dtype, device=dev)
    diag = (opts.diag_expansion and al.diag_expansion_eligible(problem)
            and not opts.pallas_backward)
    sequential = not opts.parallel_linesearch
    armijo_only = opts.ls_armijo_only and not sequential
    with_dphi = not armijo_only
    states = scan_rollout(problem)
    schedule = (opts.reg_min, opts.reg_scaling, opts.reg_max_retries)

    def full(v, dt=None):
        return torch.full((Bsz,), v, dtype=dt or dtype, device=dev)

    def T(v):
        return torch.tensor(v, **lane)

    c1, c2, slack = T(opts.ls_c1), T(opts.ls_c2), T(opts.ls_armijo_slack)
    x0 = problem.x0

    def backward(ops, lux, reg):
        if single:  # one lane: its own layout on the latency operator
            kernel = opts.pallas_latency_backward and not opts.pallas_backward
            one = [t[..., 0] for t in ops]
            out = torch.ops.altro_tpu_torch.riccati_latency(
                one[0], one[1], one[2], one[3], None if lux is None else lux[..., 0], None,
                one[4], one[5], reg[0], *schedule, kernel)
            return Gains(*(t[..., None] for t in out[:7])), out[7].reshape(1)
        out = torch.ops.altro_tpu_torch.riccati_dense(*ops[:4], lux, *ops[4:], reg, *schedule,
                                                     bool(opts.pallas_backward))
        return Gains(*out[:7]), out[7]

    def grid(alphas, c, g):
        return rollout_grid_ref(problem, c["x"], c["u"], g.K, g.d, c["z"], c["rho"], alphas, x0,
                                states=states)

    def armijo(alpha, phi, phi0, dphi0):
        return phi <= phi0 + c1 * alpha * dphi0 + slack * torch.abs(phi0)

    def code_of(v):
        return full(int(v), torch.int32)

    active = ~c["stop"] & (c["iter"] < opts.iterations_max)
    lx, lu, lxx, luu, lux, phi0 = ti.cost_expansions_tiled(
        problem, c["x"], c["u"], c["z"], c["rho"], diag=diag)
    g, reg_used = backward((c["A"], c["B"], lxx, luu, lx, lu), lux, c["reg"])
    bp_failed = ~g.ok
    dphi0 = g.delta_V[0]
    grad_small = torch.abs(dphi0) < opts.tol_meritfun_gradient
    not_descent = dphi0 >= 0
    payload0 = ti.alpha0_payload_tiled(problem, c["x"], c["u"], g.p, c["z"], c["rho"],
                                       c["convals"], c["A"], c["B"], lx, lu, phi0, dphi0)

    def payload_at(x, alpha, phi, with_dphi=with_dphi):
        return ti.payload_tiled(problem, x, alpha, phi, c["x"], c["u"], g.K, g.d, g.P,
                                g.p, c["z"], c["rho"], with_dphi, _scan_derivative)

    if sequential:
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        ls_alpha, code, n_iters, payload_ls = _backtracking(
            opts, grid, payload_at, armijo, phi0, dphi0, c, g, full, code_of, np_dtype,
            c2, not_descent)
        aux_alpha = torch.where(code == int(LineSearchCode.MINIMUM_FOUND), ls_alpha,
                                full(math.nan))
    else:
        W = int(opts.ls_parallel_width)
        n_blocks = max(1, -(-int(opts.ls_max_iters) // W))
        found = None
        for block in range(n_blocks):
            ks = block * W + torch.arange(W, device=dev)
            alphas = torch.full((W,), opts.ls_beta_decrease, **lane) ** ks.to(dtype)
            phis, xstacks = grid(alphas, c, g)
            passes = armijo(alphas[:, None], phis, phi0[None], dphi0[None])
            if block == 0 and not armijo_only:
                # trial 0 passes on Armijo and strong Wolfe
                u0 = ti.light_from_xstack_tiled(problem, xstacks[0], c["x"], c["u"], g.K,
                                                g.d, g.P, g.p, c["z"], c["rho"],
                                                alphas[0])[0]
                A1, B1, lx1, lu1 = ti.completion_tiled(problem, xstacks[0], u0, c["z"],
                                                       c["rho"])
                dphi_first = _scan_derivative(A1, B1, g.K, g.d, lx1, lu1)
                passes[0] &= torch.abs(dphi_first) <= -c2 * dphi0
            f2, idx2, a2, p2, x2 = ti.select_trial_tiled(passes, alphas, phis, xstacks)
            if found is None:
                found, k_acc, alpha_sel, phi_sel, x_sel = f2, idx2, a2, p2, x2
                continue
            upd = ~found
            k_acc = torch.where(upd, block * W + idx2, k_acc)
            alpha_sel = torch.where(upd, a2, alpha_sel)
            phi_sel = torch.where(upd, p2, phi_sel)
            x_sel = torch.where(upd, x2, x_sel)
            found = found | f2
        ok = found & ~not_descent
        code = torch.where(ok, code_of(LineSearchCode.MINIMUM_FOUND),
                           torch.where(not_descent,
                                       code_of(LineSearchCode.NOT_DESCENT_DIRECTION),
                                       code_of(LineSearchCode.NO_ERROR)))
        ls_alpha = torch.where(ok, alpha_sel, torch.zeros_like(alpha_sel))
        aux_alpha = torch.where(ok, alpha_sel, full(math.nan))
        n_iters = torch.where(ok, k_acc + 1,
                              torch.full_like(k_acc, opts.ls_max_iters)).to(torch.int32)
        payload_ls = payload_at(x_sel, alpha_sel, phi_sel)

    # acceptance (altro_tpu/solver.py:986-1019), as the lane loop takes it
    alpha_st = torch.where(grad_small, torch.zeros_like(ls_alpha), ls_alpha)
    ls_ok = (code == int(LineSearchCode.MINIMUM_FOUND)) | (
        code == int(LineSearchCode.HIT_MAX_STEPSIZE))
    ls_failed = ~grad_small & (torch.isnan(alpha_st) | ~ls_ok)
    use_ls = ls_ok & ~grad_small & (aux_alpha == alpha_st)
    m = ti.Payload(*_where(use_ls, tuple(payload_ls), tuple(payload0)))

    upd = iteration_update(
        problem, opts, m, z=c["z"], rho=c["rho"], status=c["status"],
        ls_fails=c["ls_fails"], reg_used=reg_used, phi_prev=c["phi"], it=c["iter"],
        grad_small=grad_small, bp_failed=bp_failed, ls_failed=ls_failed)
    new = dict(
        x=m.x, u=m.u, y=m.y, z=upd.z, rho=upd.rho, K=g.K, d=g.d, P=g.P,
        p=g.p, reg=upd.reg, convals=m.convals, A=m.A, B=m.B,
        iter=c["iter"] + 1, status=upd.status, stop=upd.stop, phi=m.phi, dphi=m.dphi,
        alpha=alpha_st, stat=upd.stat, feas=upd.feas, ls_iters=n_iters,
        ls_fails=upd.ls_fails, bp_fail_index=g.fail_index.to(torch.int32),
    )
    return _freeze(active, new, c)


def finish(problem: Problem, opts: SolverOptions, c: dict):
    """(SolverState, SolveStats) from the carried values after the last
    trip: MAX_ITERATIONS where a lane ran out of trips unsolved."""
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
        dphi=c["dphi"],
        bp_fail_index=c["bp_fail_index"],
    )
    return new_state, stats


def _flatten(c: dict) -> list:
    return [t for name in _CARRY for t in (c[name] if isinstance(c[name], tuple) else (c[name],))]


def _unflatten(flat, groups: int) -> dict:
    it = iter(flat)
    return {name: (tuple(next(it) for _ in range(groups)) if name in ("z", "convals")
                   else next(it)) for name in _CARRY}


def _state_flat(state: SolverState) -> list:
    return [state.x, state.u, state.y, *state.z, state.rho, state.K, state.d, state.P,
            state.p, state.reg]


def _state_unflat(flat, groups: int) -> SolverState:
    x, u, y = flat[:3]
    rho, K, d, P, p, reg = flat[3 + groups:]
    return SolverState(x=x, u=u, y=y, z=tuple(flat[3:3 + groups]), rho=rho, K=K, d=d, P=P,
                       p=p, reg=reg)


class Traced(NamedTuple):
    """A function of flat tensors traced by `make_fx`: graph(*inputs,
    *constants), every tensor it closed over lifted to an input of its own
    (`constants`, in order)."""

    graph: torch.fx.GraphModule
    constants: tuple


class SolveGraphs(NamedTuple):
    """The solve's two traced pieces (`trace_solve`): `setup`
    (*state, *problem leaves) -> carry, `initial_carry`; and `trip`
    (*carry, *problem leaves) -> carry, one `trip`."""

    setup: Traced
    trip: Traced


def _trace(fn, example) -> Traced:
    # fake tensors for the inputs; the tensors fn closes over stay real
    gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*example)
    return Traced(gm, _lift_constants(gm))


def trace_solve(problem: Problem, state: SolverState, opts: SolverOptions, *,
                single: bool) -> SolveGraphs:
    """`initial_carry` and one `trip` traced by `make_fx` on the shapes of
    (problem, state) (real tensors; the trip is traced from the carry the
    setup computes from them), with the state, the carry and the problem's
    data leaves (`problem.problem_leaves`: the window's q, r, c and x0
    among them) as inputs. `make_fx` traces below autograd, so the
    forward-mode Jacobians (`problem.lane_jacobian`) become their primal
    and tangent operators: inside a loop operator's body they would not
    trace, and traced by `torch.export` itself they would leave dual-level
    calls that a loaded program cannot replay."""
    leaves = [t for _, t in problem_leaves(problem)]
    groups = len(problem.constraints)
    n_state = len(_state_flat(state))

    def setup(*args):
        prob = problem_with_leaves(problem, args[n_state:])
        c = initial_carry(prob, _state_unflat(args[:n_state], groups), opts)
        return [_standard(t) for t in _flatten(c)]

    def one(*args):
        prob = problem_with_leaves(problem, args[n_carry:])
        c = trip(prob, opts, single, _unflatten(args[:n_carry], groups))
        return [_standard(t) for t in _flatten(c)]

    flat0 = [_standard(t) for t in _flatten(initial_carry(problem, state, opts))]
    n_carry = len(flat0)
    return SolveGraphs(_trace(setup, _state_flat(state) + leaves),
                       _trace(one, flat0 + leaves))


def _lift_constants(gm: torch.fx.GraphModule) -> tuple:
    """Turn every tensor attribute the graph reads (`get_attr`) into a
    placeholder after the existing ones; returns their values in order."""
    graph = gm.graph
    last = [n for n in graph.nodes if n.op == "placeholder"][-1]
    values = []
    for node in list(graph.nodes):
        if node.op != "get_attr":
            continue
        value = getattr(gm, node.target)
        if not torch.is_tensor(value):
            continue
        with graph.inserting_after(last):
            ph = graph.placeholder(f"lifted_{len(values)}")
        ph.meta = dict(node.meta)
        node.replace_all_uses_with(ph)
        graph.erase_node(node)
        last = ph
        values.append(value)
    graph.lint()
    gm.recompile()
    return tuple(values)


def graph_solve(problem: Problem, state: SolverState, opts: SolverOptions, *, single: bool,
                graphs: Optional[SolveGraphs] = None):
    """The solve on lane-minor stacks in a form `torch.export` records: no
    host read but the backward operator's and the loop's condition.
    problem.x0 [n, B]; state lane-minor (`tile_solver.state_to_lanes`).
    single=True runs one lane (B = 1) on the latency
    operator, as `solver.solve` does; False runs B lanes as the vmapped
    solve (`parallel.batch.solve_lanes`) does. Returns (SolverState,
    SolveStats) lane-minor, the stats [B]. The caller has checked
    `graph_refusal`.

    Without `graphs`, `initial_carry` and `iterations_max` trips of `trip`
    in a Python loop (eagerly, or unrolled by a tracer). With `graphs`
    (`trace_solve` on these shapes), the setup graph and torch's
    while_loop operator over the trip graph while any lane is active:
    one trip's operators in an exported program."""
    if graphs is None:
        c = initial_carry(problem, state, opts)
        for _ in range(opts.iterations_max):
            c = trip(problem, opts, single, c)
        return finish(problem, opts, c)
    leaves = [t for _, t in problem_leaves(problem)]
    groups = len(problem.constraints)
    setup, one = graphs
    flat = tuple(setup.graph(*_state_flat(state), *leaves, *setup.constants))
    count = len(flat)
    position = _unflatten(range(count), groups)  # each carried name's place in flat
    i_stop, i_iter = position["stop"], position["iter"]

    def running(*args):  # any lane still active (`lane_loop`'s condition)
        return torch.any(~args[i_stop] & (args[i_iter] < opts.iterations_max))

    # the functions take (*carry, *leaves, *constants), each cloned into the
    # graph (a tracer hands the operator tensors of its own, never a
    # constant such as Q that the problem holds)
    consts = tuple(t.clone() for t in (*leaves, *one.constants))
    out = while_loop_op(running, lambda *args: tuple(one.graph(*args)), flat, consts)
    return finish(problem, opts, _unflatten(out, groups))


def _backtracking(opts, grid, payload_at, armijo, phi0, dphi0, c, g, full, code_of, np_dtype,
                  c2, not_descent):
    """The sequential backtracking search (`linesearch.
    wolfe_line_search_lanes` with use_backtracking) at fixed shapes, every
    lane at once: trial 1 at alpha = 1 and, where it fails strong Wolfe
    and `ls_try_cubic_first` finds a cubic minimum, trial 2 at that
    minimum, each on its full payload; then the backtracking alphas
    alpha = beta, beta^2, ... (max(1, ls_max_iters - 1) of them) as one
    batched rollout, the first Armijo pass taken and its payload
    completed. Returns per lane (alpha, code, n_iters, payload): the
    machine's alpha, code and count; the payload valid where the code is
    MINIMUM_FOUND."""
    one = full(1.0)

    def merit(alpha):
        phis, xs = grid(alpha[None], c, g)
        out = payload_at(xs[0], alpha, phis[0], True)
        return out.phi, out.dphi, out

    def wolfe(dphi):
        return torch.abs(dphi) <= -c2 * dphi0

    phi1, dphi1, pay1 = merit(one)
    ok1 = armijo(one, phi1, phi0, dphi0) & wolfe(dphi1)
    tried = torch.zeros_like(ok1)
    ok2 = torch.zeros_like(ok1)
    alpha_c = one
    pay2 = pay1
    if opts.ls_try_cubic_first:
        spline, fit_ok = cubic_fit_lanes(torch.zeros_like(one), phi0, dphi0, one, phi1, dphi1)
        amin, found = cubic_argmin_lanes(spline)
        tried = ~ok1 & fit_ok & found & torch.isfinite(amin)
        alpha_c = torch.where(tried, amin, one)
        phi2, dphi2, pay2 = merit(alpha_c)
        ok2 = tried & armijo(alpha_c, phi2, phi0, dphi0) & wolfe(dphi2)

    count = max(1, int(opts.ls_max_iters) - 1)
    steps = _alphas(1.0, opts.ls_beta_decrease, count + 1, np_dtype)
    alphas = torch.tensor(steps[:count], dtype=phi0.dtype, device=phi0.device)
    phis, xstacks = grid(alphas, c, g)
    passes = armijo(alphas[:, None], phis, phi0[None], dphi0[None])
    found3, idx3, alpha3, phi3, x3 = ti.select_trial_tiled(passes, alphas, phis, xstacks)
    pay3 = payload_at(x3, alpha3, phi3, True)

    before = 1 + tried.to(torch.int32)
    accepted = ok1 | ok2 | found3
    alpha = torch.where(ok1, one, torch.where(ok2, alpha_c, torch.where(
        found3, alpha3, full(steps[count]))))
    n_iters = torch.where(ok1, full(1, torch.int32), torch.where(
        ok2, full(2, torch.int32), before + torch.where(found3, idx3 + 1, full(count,
                                                                              torch.int32))))
    code = torch.where(accepted, code_of(LineSearchCode.MINIMUM_FOUND),
                       code_of(LineSearchCode.NO_ERROR))
    payload = ti.Payload(*_where(ok1, tuple(pay1), _where(ok2, tuple(pay2), tuple(pay3))))
    # not a descent direction: no trial, alpha = 0 (linesearch.cpp:49-52)
    alpha = torch.where(not_descent, torch.zeros_like(alpha), alpha)
    n_iters = torch.where(not_descent, torch.zeros_like(n_iters), n_iters).to(torch.int32)
    code = torch.where(not_descent, code_of(LineSearchCode.NOT_DESCENT_DIRECTION), code)
    return alpha, code, n_iters, payload
