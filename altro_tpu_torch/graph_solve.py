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
  chooses); under `parallel_riccati` either runs the associative pass,
  in JAX's precedence (`pallas_backward`, then `parallel_riccati`, then
  the latency kernel). The expansions are diagonal, Gauss-Newton or
  exact (`exact_al_hessian`) as the live solves choose.
* **The rollouts' knot loop as torch's `scan` operator** (one body in
  the graph, not N), through the problem's own dynamics, with the same
  arithmetic as `rollout_grid.plain_rollout`; on one lane where the live
  solve runs the trial-rollout kernel (`pallas_rollout` on a problem it
  takes), the `altro_tpu_torch::trial_rollout` operator instead.
* **Every line search of the live solves.** The strong-Wolfe search
  (the default options) and the sequential backtracking run the live
  per-lane machine's own pass (`linesearch.lanes_pass`) in a second
  while_loop operator inside the trip, while any lane is still
  searching: each pass evaluates every lane's merit at its own alpha and
  selects every lane's transition by its mode; a lane's last payload is
  carried. The pass is traced on its own first (`trace_solve`), since a
  loop operator's body cannot run the forward-mode Jacobians. The grids
  (phase-split x-only or light payload, non-split, the best-decrease
  fallback) evaluate all their blocks and take each lane's first passing
  trial (`tile_solver.merge_block`, `grid_outcome`); `rti_mode` takes
  the full step.

One lane is the lane-minor layout with B = 1, so the single-lane and the
batched artifact share every line but the backward's choice. The per-
iteration math after the search (criteria, duals, penalty, status) is
`solver.iteration_update`, which both live solves run too.

What JAX's export refuses too (the host callbacks of a verbosity above
SILENT and of `iteration_callback`), and a kernel on the card that
cannot take the problem, are refused before tracing (`graph_refusal`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch._higher_order_ops.scan import scan_op
from torch._higher_order_ops.while_loop import while_loop_op
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._pytree import tree_flatten, tree_unflatten

from altro_tpu_torch import al
from altro_tpu_torch.linesearch import (
    _DONE,
    _where,
    lane_constants,
    lanes_pass,
    lanes_result,
    lanes_start,
    search_options,
)
from altro_tpu_torch.ops import library  # noqa: F401  registers the operators
from altro_tpu_torch.ops import tile_iter as ti
from altro_tpu_torch.ops.riccati_backward import Gains
from altro_tpu_torch.ops.rollout_grid import affine_constraint_stacks, rollout_grid_ref
from altro_tpu_torch.options import SolverOptions, Verbosity
from altro_tpu_torch.problem import Problem, problem_leaves, problem_with_leaves
from altro_tpu_torch.solver import (
    SolverState,
    SolveStats,
    _trial_grid,
    complementarity,
    iteration_update,
    single_lane_refusal,
    total_cost,
)
from altro_tpu_torch.status import SolveStatus
from altro_tpu_torch.tile_solver import (
    _freeze,
    _trajectory_convals_tiled,
    acceptance,
    grid_outcome,
    kernel_refusal,
    merge_block,
    open_loop_rollout_tiled,
    search_kind,
)

__all__ = ["graph_refusal", "graph_solve", "trace_solve", "SolveGraphs", "Traced",
           "initial_carry", "trip", "finish", "scan_rollout"]

_UNSOLVED = int(SolveStatus.UNSOLVED)


# JAX's own export refuses what reports from inside the solve: its debug
# prints and callbacks are host callbacks, which `jax.export` does not
# serialize.
JAX_EXPORT_REFUSAL = "serialization of host_callbacks is not yet implemented"


def graph_refusal(problem: Problem, opts: SolverOptions, *, single: bool,
                  cuda: bool) -> Optional[str]:
    """Why `graph_solve` cannot carry this configuration, or None. What
    JAX's `export_mpc_server` refuses too: a verbosity above SILENT and an
    `iteration_callback`, which report through host callbacks (JAX:
    NotImplementedError, JAX_EXPORT_REFUSAL). With `cuda` (an artifact
    meant to run on the card), a kernel the options select that cannot
    take the problem, as the live solve on the card refuses it
    (`solver.single_lane_refusal` for one lane, `tile_solver.
    kernel_refusal` for the vmapped solve's). Options and shapes only."""
    checks = (
        (opts.verbose > Verbosity.SILENT, "a verbosity above Verbosity.SILENT"),
        (opts.iteration_callback is not None, "iteration_callback"),
    )
    why = [reason for bad, reason in checks if bad]
    if why:
        return (f"not carried by the exported graph: {'; '.join(why)} (they report through "
                f"host callbacks, which JAX's export refuses too: \"{JAX_EXPORT_REFUSAL}\")")
    if not cuda:
        return None
    if single:
        return single_lane_refusal(problem, opts, cuda=True)
    why = kernel_refusal(problem, opts, vmapped=True)
    return None if why is None else f"pallas_backward: {why}; pallas_backward=False selects " \
        "the plain backward"


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


def _one(t, ndim):
    """A one-lane operand of the trial rollout: t without its lane axis
    when it has one (a row per lane), contiguous."""
    return (t[..., 0] if t.ndim > ndim else t).contiguous()


class _Merits(NamedTuple):
    """A trip's merit evaluations at its reference trajectory and gains:
    grid(alphas [W] or [W, B]) -> (phis [W, B], xstacks [W, N+1, n, B]);
    payload(x, alpha, phi, with_dphi) -> Payload; full(alpha [B]) ->
    (phi, dphi, Payload), the merit with its derivative at one alpha per
    lane."""

    grid: object
    payload: object
    full: object


def _merits(problem: Problem, opts: SolverOptions, single: bool, c: dict, g) -> _Merits:
    """The trip's merits: the trials through the problem's own dynamics
    (the knot loop a scan) and AL cost, or, on one lane where the live
    solve runs the trial rollout (`solver._trial_grid`: the phase-split
    x-only grid with `pallas_rollout` on a problem with a block step, a
    diagonal cost and affine NEGATIVE_ORTHANT groups), the
    `altro_tpu_torch::trial_rollout` operator."""
    states = scan_rollout(problem)
    x0 = problem.x0

    def payload(x, alpha, phi, with_dphi=True):
        return ti.payload_tiled(problem, x, alpha, phi, c["x"], c["u"], g.K, g.d, g.P, g.p,
                                c["z"], c["rho"], with_dphi, _scan_derivative)

    def grid(alphas):
        return rollout_grid_ref(problem, c["x"], c["u"], g.K, g.d, c["z"], c["rho"], alphas, x0,
                                states=states)

    if single and _trial_grid(problem, opts):
        grid = _trial_operator_grid(problem, c, g)

    def full(alpha):
        phis, xs = grid(alpha[None])
        out = payload(xs[0], alpha, phis[0])
        return out.phi, out.dphi, out

    return _Merits(grid, payload, full)


def _trial_operator_grid(problem: Problem, c: dict, g):
    """The one-lane grid through `altro_tpu_torch::trial_rollout`, on the
    operands the live solve hands `trial_rollout.trial_rollout`: the
    lane's reference trajectory and gains, the cost rows, and the affine
    rows premultiplied by rho as `solver.solve` forms them."""
    cost, rho = problem.cost, c["rho"]
    con = (None,) * 4
    if problem.constraints:
        ax, au, g_raw, act = affine_constraint_stacks(problem)
        cz = _one(torch.cat(c["z"], dim=1), 2)
        con = (_one(rho * (ax * act[..., None])[..., None], 3),
               _one(rho * (au * act[..., None])[..., None], 3),
               _one((cz - rho * g_raw) * act, 2), (1.0 / (2.0 * rho)).contiguous())
    ds = problem.dynamics_tile.device_step
    operands = (_one(problem.x0, 1), _one(c["x"], 2), _one(c["u"], 2), _one(g.K, 3),
                _one(g.d, 2), _one(cost.Q, 2), _one(cost.q, 2), _one(cost.R, 2),
                _one(cost.r, 2), _one(cost.c, 1), _one(problem.h, 1))

    def grid(alphas):
        phis, xs = torch.ops.altro_tpu_torch.trial_rollout(
            alphas.contiguous(), *operands, *con, ds.model, ds.integrator,
            [float(v) for v in ds.params])
        return phis[:, None], xs[..., None]

    return grid


def _head(problem: Problem, opts: SolverOptions, single: bool, c: dict) -> dict:
    """A trip up to its line search: the AL expansions (diagonal, Gauss-
    Newton or exact, as the live solves choose), the backward operator
    with its retry, dphi(0) and merit(0)'s payload."""
    diag = (opts.diag_expansion and al.diag_expansion_eligible(problem)
            and not opts.pallas_backward and not opts.exact_al_hessian
            and not opts.parallel_riccati)
    schedule = (opts.reg_min, opts.reg_scaling, opts.reg_max_retries)
    # JAX's precedence: pallas_backward, then parallel_riccati, then the
    # latency kernel (one lane) (altro_tpu/solver.py:514-526, :596)
    assoc = opts.parallel_riccati and not opts.pallas_backward
    chunk = int(opts.parallel_riccati_chunk)
    lx, lu, lxx, luu, lux, phi0 = ti.cost_expansions_tiled(
        problem, c["x"], c["u"], c["z"], c["rho"], diag=diag, exact=opts.exact_al_hessian)
    if single:  # one lane: its own layout on the latency operator
        kernel = opts.pallas_latency_backward and not opts.pallas_backward and not assoc
        one = [t[..., 0] for t in (c["A"], c["B"], lxx, luu, lx, lu)]
        out = torch.ops.altro_tpu_torch.riccati_latency(
            one[0], one[1], one[2], one[3], None if lux is None else lux[..., 0], None,
            one[4], one[5], c["reg"][0], *schedule, kernel, assoc, chunk)
        g, reg_used = Gains(*(t[..., None] for t in out[:7])), out[7].reshape(1)
    else:
        out = torch.ops.altro_tpu_torch.riccati_dense(
            c["A"], c["B"], lxx, luu, lux, lx, lu, c["reg"], *schedule,
            bool(opts.pallas_backward), assoc, chunk)
        g, reg_used = Gains(*out[:7]), out[7]
    dphi0 = g.delta_V[0]
    payload0 = ti.alpha0_payload_tiled(problem, c["x"], c["u"], g.p, c["z"], c["rho"],
                                       c["convals"], c["A"], c["B"], lx, lu, phi0, dphi0)
    return dict(active=~c["stop"] & (c["iter"] < opts.iterations_max), g=g, reg_used=reg_used,
                phi0=phi0, dphi0=dphi0, grad_small=torch.abs(dphi0) < opts.tol_meritfun_gradient,
                payload0=payload0)


def _closure(c: dict, h: dict) -> list:
    """What a machine pass reads of its trip, flat: the reference
    trajectory, duals, penalty, gains and merit(0)'s value and slope."""
    g = h["g"]
    return [c["x"], c["u"], *c["z"], c["rho"], g.K, g.d, g.P, g.p, h["phi0"], h["dphi0"]]


class _SearchPass(NamedTuple):
    """One pass of the strong-Wolfe machine (`linesearch.lanes_pass` after
    the merit at every lane's alpha_next) as a function of flat tensors
    (*machine state, *closure, *problem leaves, *constants): `fn`, its
    Python form, and `traced`, the same traced by `make_fx` (None to run
    `fn`). A loop operator's body cannot run the forward-mode Jacobians
    itself, so the trip's loop runs the traced pass."""

    fn: object
    spec: object
    traced: Optional[Traced]


def _search_pass(problem: Problem, opts: SolverOptions, single: bool, s0: dict,
                 groups: int) -> _SearchPass:
    """The machine's pass on the structure of its state s0, untraced."""
    flat, spec = tree_flatten(s0)
    n_s = len(flat)
    ls_opts = search_options(opts)
    n_leaves = len(problem_leaves(problem))

    def fn(*args):
        s = tree_unflatten(list(args[:n_s]), spec)
        x, u, *rest = args[n_s:]
        z, (rho, K, d, P, p, phi0, dphi0) = tuple(rest[:groups]), rest[groups:groups + 7]
        prob = problem_with_leaves(problem, rest[groups + 7:groups + 7 + n_leaves])
        c = dict(x=x, u=u, z=z, rho=rho)
        merits = _merits(prob, opts, single, c, Gains(K, d, P, p, None, None, None))
        phi_t, dphi_t, aux_t = merits.full(s["alpha_next"])
        new = lanes_pass(s, phi_t, dphi_t, aux_t, phi0, dphi0,
                         lane_constants(phi0, 1.0, ls_opts), ls_opts)
        inputs = {id(t) for t in args}
        # a loop's body returns tensors of its own, with the carry's strides
        return [t.clone() if id(t) in inputs else _standard(t) for t in tree_flatten(new)[0]]

    return _SearchPass(fn, spec, None)


def _strong_wolfe(problem: Problem, opts: SolverOptions, single: bool, c: dict, h: dict,
                  search: Optional[_SearchPass]):
    """The strong-Wolfe machine (or, with use_backtracking_linesearch, the
    sequential backtracking) for every lane, in torch's while_loop
    operator while any lane is still searching: each pass evaluates every
    lane's merit at its own alpha_next and selects each lane's transition
    by its mode (`linesearch.lanes_pass`, the live machine's own). Lanes
    that are not active start finished. Run eagerly (no traced pass), the
    same passes in a Python loop. Returns its `LineSearchResult`."""
    groups = len(problem.constraints)
    s0 = lanes_start(h["phi0"], h["dphi0"], lane_constants(h["phi0"], 1.0, search_options(opts)),
                     aux0=h["payload0"], active=h["active"])
    if search is None:
        search = _search_pass(problem, opts, single, s0, groups)
    flat, _ = tree_flatten(s0)  # its first leaf: the lanes' modes
    consts = [*_closure(c, h), *(t for _, t in problem_leaves(problem))]
    out = tuple(_standard(t) for t in flat)
    if search.traced is None:  # eagerly: the same passes in a Python loop
        while bool(torch.any(out[0] != _DONE)):
            out = tuple(search.fn(*out, *consts))
    else:
        consts += [t.clone() for t in search.traced.constants]
        out = while_loop_op(lambda *args: torch.any(args[0] != _DONE),
                            lambda *args: tuple(search.traced.graph(*args)), out, tuple(consts))
    return lanes_result(tree_unflatten(list(out), search.spec))


def trip(problem: Problem, opts: SolverOptions, single: bool, c: dict,
         search: Optional[_SearchPass] = None) -> dict:
    """One trip of the loop for every lane: `_head` (expansions, the
    backward operator with its retry), the line search (the strong-Wolfe
    machine in a loop operator, a grid at fixed shapes, or the RTI full
    step), the payload taken or merit(0), `solver.iteration_update`;
    lanes that had stopped keep every carried value (`tile_solver.
    _freeze`). search: the machine's pass as `trace_solve` traced it."""
    dtype, dev = c["x"].dtype, c["x"].device
    Bsz = c["x"].shape[-1]
    lane = dict(dtype=dtype, device=dev)
    kind = search_kind(opts, vmapped=True)
    h = _head(problem, opts, single, c)
    g, phi0, dphi0 = h["g"], h["phi0"], h["dphi0"]
    merits = _merits(problem, opts, single, c, g)
    # the payload's dphi is NaN where JAX skips the sensitivity scan
    skip_dphi = opts.ls_armijo_only and opts.ls_phase_split and kind in ("split", "rti")

    def full(v, dt=None):
        return torch.full((Bsz,), v, dtype=dt or dtype, device=dev)

    if kind == "rti":  # the full step (altro_tpu/solver.py:865-893)
        phis, xs = merits.grid(torch.ones(1, **lane))
        m = merits.payload(xs[0], full(1.0), phis[0], not skip_dphi)
        alpha_st = full(1.0)
        ls_failed = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        n_iters = full(1, torch.int32)
    else:
        if kind == "sequential":
            ls = _strong_wolfe(problem, opts, single, c, h, search)
            ls_alpha, code, n_iters, aux_alpha = ls.alpha, ls.code, ls.n_iters, ls.aux_alpha
            payload_ls = ls.aux
        else:
            ls_alpha, code, n_iters, aux_alpha, (alpha_sel, phi_sel, x_sel) = _grid_search(
                opts, kind, merits, c, g, phi0, dphi0, lane)
            payload_ls = merits.payload(x_sel, alpha_sel, phi_sel, not skip_dphi)
        alpha_st, ls_failed, use_ls = acceptance(code, ls_alpha, aux_alpha, h["grad_small"])
        m = ti.Payload(*_where(use_ls, tuple(payload_ls), tuple(h["payload0"])))

    upd = iteration_update(
        problem, opts, m, z=c["z"], rho=c["rho"], status=c["status"],
        ls_fails=c["ls_fails"], reg_used=h["reg_used"], phi_prev=c["phi"], it=c["iter"],
        grad_small=h["grad_small"], bp_failed=~g.ok, ls_failed=ls_failed)
    new = dict(
        x=m.x, u=m.u, y=m.y, z=upd.z, rho=upd.rho, K=g.K, d=g.d, P=g.P,
        p=g.p, reg=upd.reg, convals=m.convals, A=m.A, B=m.B,
        iter=c["iter"] + 1, status=upd.status, stop=upd.stop, phi=m.phi, dphi=m.dphi,
        alpha=alpha_st, stat=upd.stat, feas=upd.feas, ls_iters=n_iters,
        ls_fails=upd.ls_fails, bp_fail_index=g.fail_index.to(torch.int32),
    )
    return _freeze(h["active"], new, c)


def _grid_search(opts: SolverOptions, kind: str, merits: _Merits, c: dict, g, phi0, dphi0,
                 lane: dict):
    """The grid searches at fixed shapes, every block evaluated: the
    phase-split grid ("split", x-only or light payload: the same values)
    and the non-split grid ("grid"), trial 0 held to strong Wolfe unless
    `ls_armijo_only`, the best-decrease fallback on the phase-split
    grid; each lane takes its first passing trial (`tile_solver.
    merge_block`, `grid_outcome`, the vmapped solve's own), so the
    result is the live searches' that stop at the first block any lane
    needs."""
    W = int(opts.ls_parallel_width)
    n_blocks = max(1, -(-int(opts.ls_max_iters) // W))
    wolfe_first = kind == "grid" or not opts.ls_armijo_only
    fallback = kind == "split" and opts.ls_best_decrease_fallback
    c1, c2, slack = (torch.tensor(v, **lane) for v in (opts.ls_c1, opts.ls_c2,
                                                        opts.ls_armijo_slack))
    acc = best = None
    for block in range(n_blocks):
        ks = block * W + torch.arange(W, device=lane["device"])
        alphas = torch.full((W,), opts.ls_beta_decrease, **lane) ** ks.to(lane["dtype"])
        phis, xstacks = merits.grid(alphas)
        passes = phis <= (phi0[None] + c1 * alphas[:, None] * dphi0[None]
                          + slack * torch.abs(phi0)[None])
        if block == 0 and wolfe_first:  # trial 0 passes on Armijo and strong Wolfe
            dphi_first = merits.payload(xstacks[0], alphas[0].expand(phi0.shape), phis[0]).dphi
            passes[0] &= torch.abs(dphi_first) <= -c2 * dphi0
        sel = ti.select_trial_tiled(passes, alphas, phis, xstacks)
        best2 = ti.select_best_tiled(alphas, phis, xstacks) if fallback else None
        if acc is None:
            acc, best = sel, best2
        else:
            acc, best = merge_block(acc, sel, block, W, best, best2)
    return grid_outcome(kind, opts.ls_max_iters, acc, best, phi0, dphi0)


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
    # fake tensors for the inputs, each its own (make_fx gives one tensor
    # passed twice one placeholder); the tensors fn closes over stay real
    example = [t.clone() for t in example]
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
    calls that a loaded program cannot replay. So under the strong-Wolfe
    search a machine pass is traced first, on the machine's state and the
    trip's values at the first trip (run eagerly for their shapes), and
    the trip's loop operator runs that graph."""
    leaves = [t for _, t in problem_leaves(problem)]
    groups = len(problem.constraints)
    n_state = len(_state_flat(state))
    flat0 = [_standard(t) for t in _flatten(initial_carry(problem, state, opts))]
    n_carry = len(flat0)
    search = None
    if search_kind(opts, vmapped=True) == "sequential":
        c0 = _unflatten(flat0, groups)
        h0 = _head(problem, opts, single, c0)
        s0 = lanes_start(h0["phi0"], h0["dphi0"],
                         lane_constants(h0["phi0"], 1.0, search_options(opts)),
                         aux0=h0["payload0"], active=h0["active"])
        search = _search_pass(problem, opts, single, s0, groups)
        example = [_standard(t) for t in tree_flatten(s0)[0]] + _closure(c0, h0) + leaves
        search = search._replace(traced=_trace(search.fn, example))

    def setup(*args):
        prob = problem_with_leaves(problem, args[n_state:])
        c = initial_carry(prob, _state_unflat(args[:n_state], groups), opts)
        return [_standard(t) for t in _flatten(c)]

    def one(*args):
        prob = problem_with_leaves(problem, args[n_carry:])
        c = trip(prob, opts, single, _unflatten(args[:n_carry], groups), search)
        return [_standard(t) for t in _flatten(c)]

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
    host read but the backward operator's and the loops' conditions.
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
