"""Solver state, statistics, measures and the single-lane solve (PyTorch port).

Counterpart: altro_tpu/solver.py (`SolverState`, `SolveStats`,
`init_state`, `stationarity`, `feasibility`, `complementarity`,
`total_cost`, and the single-lane `solve` with its helpers:
`open_loop_rollout`, `merit_function`, `merit_rollout_phi_x`,
`light_from_xstack`, `al_gradients`, `complete_merit_payload`,
`merit0_derivative`, `dynamics_expansions`, `al_expansions`,
`_cost_expansions_and_cost`,
`_cost_expansions_and_cost_diag`, `_retry_loop`, `backward_adaptive`,
`_alpha0_merit_out`, `_trajectory_convals`, `al_total_cost`). The
batched solve is tile_solver.solve_tiled.

`SolverState` and `SolveStats` hold tensors in either layout: one lane
(the JAX layout, `x [N+1, n]`, scalars 0-dim), batch-major ([B, ...])
or lane-minor ([..., B], inside the batched solve). The measures
`stationarity` .. `total_cost` take lane-minor stacks and return one
value per lane, [B]; the single-lane helpers take the one-lane layout and
run the lane-minor blocks of ops/tile_iter.py and al.py with B = 1.

`solve` ports the JAX solve's line-search branches (solver.py:865-1007)
with diagonal or dense expansions (:745-752), the latter with the
Gauss-Newton or, under exact_al_hessian, the exact AL Hessian; the
single-lane backward pass (ops/packed_backward.py, the kernel on the card) with the
adaptive-regularization retry, or under `pallas_backward` the plain
serial recursion (JAX's fused dispatcher runs its scan on one lane,
altro_tpu/solver.py:629-641: no kernel there either); then one of
  * the strong-Wolfe cubic search or, with use_backtracking_linesearch,
    the sequential backtracking (linesearch.wolfe_line_search, the
    default options) over `merit_function`;
  * the non-split grid (parallel_linesearch without ls_phase_split,
    linesearch.parallel_backtracking_search) through the problem's own
    dynamics and AL cost;
  * the phase-split x-only grid (linesearch.
    parallel_backtracking_search_split) through the single-lane trial
    rollout (ops/trial_rollout.py) when `pallas_rollout` and the problem
    has what it needs (`_trial_grid`), else through the problem's own
    dynamics and AL cost;
  * the phase-split light-payload grid (ls_grid_x_only=False): every
    trial's light payload (`merit_rollout_light`) through the problem's
    own dynamics and AL cost, on any device: JAX passes it no
    `merit_grid` (altro_tpu/solver.py:957-975), so the plain rollout on
    the card is its own semantics, not a fallback;
  * or, under `rti_mode`, no search: the full step (alpha = 1) through
    the same rollouts (the x-only or light payload with the phase split,
    `merit_function` without it, altro_tpu/solver.py:865-893);
and the status chain, the dual/penalty update and ls_failure_recovery.
The JAX `lax.while_loop` becomes a Python loop with one host sync per
iteration on `stop` (plus one per backward retry, per extra grid block
and per strong-Wolfe trial). The verbosity tiers and `iteration_callback`
(the JAX solve's `jax.debug.print` / `debug_callback` sites) are host
prints and calls in that loop, with JAX's format strings; at
Verbosity.SILENT without a callback they read nothing from the device.
Options it does not implement raise NotImplementedError naming the
option (`single_lane_refusal`), as does a CUDA problem the kernels cannot
take.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import NamedTuple, Optional, Tuple

import torch

from altro_tpu_torch import al, cones
from altro_tpu_torch.linesearch import (
    LineSearchOptions,
    _read,
    parallel_backtracking_search,
    parallel_backtracking_search_split,
    tree_map,
    wolfe_line_search,
)
from altro_tpu_torch.ops import tile_iter as ti
from altro_tpu_torch.ops.library import retry
from altro_tpu_torch.ops.packed_backward import tvlqr_backward_latency
from altro_tpu_torch.ops import riccati_latency as rl
from altro_tpu_torch.ops.riccati_latency import riccati_latency_ref
from altro_tpu_torch.ops.rollout_grid import affine_constraint_stacks
from altro_tpu_torch.ops.trial_rollout import (
    ineligibility,
    problem_ineligibility,
    trial_rollout,
)
from altro_tpu_torch.options import SolverOptions, Verbosity
from altro_tpu_torch.problem import Problem
from altro_tpu_torch.status import LineSearchCode, SolveStatus

__all__ = [
    "SolverState",
    "SolveStats",
    "init_state",
    "solve",
    "single_lane_refusal",
    "grid_search_refusal",
    "check_pallas_backward",
    "open_loop_rollout",
    "MeritOut",
    "merit_function",
    "merit_rollout_light",
    "merit_rollout_phi_x",
    "light_from_xstack",
    "complete_merit_payload",
    "dynamics_expansions",
    "al_expansions",
    "stationarity",
    "feasibility",
    "complementarity",
    "total_cost",
    "al_total_cost",
    "al_total_cost_lanes",
]


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Everything that persists across warm-started solves (one lane's
    shapes shown; a batch adds the lane axis)."""

    x: torch.Tensor  # [N+1, n]
    u: torch.Tensor  # [N, m]
    y: torch.Tensor  # [N+1, n]
    z: Tuple[torch.Tensor, ...]  # per-group [N+1, p]
    rho: torch.Tensor  # scalar penalty
    K: torch.Tensor  # [N, m, n]
    d: torch.Tensor  # [N, m]
    P: torch.Tensor  # [N+1, n, n]
    p: torch.Tensor  # [N+1, n]
    reg: torch.Tensor  # scalar Quu regularization in effect

    def map(self, fn) -> "SolverState":
        """Apply fn to every tensor (the duals one by one)."""
        return SolverState(**{
            f.name: (tuple(fn(t) for t in getattr(self, f.name)) if f.name == "z"
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class SolveStats:
    status: torch.Tensor  # int32 SolveStatus
    iterations: torch.Tensor  # int32
    objective_value: torch.Tensor
    merit_value: torch.Tensor
    stationarity: torch.Tensor
    primal_feasibility: torch.Tensor
    complementarity: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    ls_iterations: torch.Tensor  # int32
    dphi: torch.Tensor
    bp_fail_index: torch.Tensor  # int32


def init_state(problem: Problem) -> SolverState:
    """Cold start for one lane (problem.x0 is [n])."""
    N, n, m = problem.N, problem.n, problem.m
    kw = dict(dtype=problem.dtype, device=problem.device)
    return SolverState(
        x=problem.x0[None].repeat(N + 1, 1),
        u=torch.zeros((N, m), **kw),
        y=torch.zeros((N + 1, n), **kw),
        z=problem.init_duals(),
        rho=torch.tensor(1.0, **kw),
        K=torch.zeros((N, m, n), **kw),
        d=torch.zeros((N, m), **kw),
        P=torch.zeros((N + 1, n, n), **kw),
        p=torch.zeros((N + 1, n), **kw),
        reg=torch.tensor(0.0, **kw),
    )


def _lane_max(t):
    """max over every axis but the last (lanes)."""
    return torch.amax(t.reshape(-1, t.shape[-1]), dim=0)


def stationarity(A, B, lx, lu, y):
    """max-norm KKT stationarity residual per lane."""
    N = A.shape[0]
    res_x = lx[:N] + torch.einsum("kijb,kib->kjb", A, y[1:]) - y[:N]
    res_u = lu + torch.einsum("kijb,kib->kjb", B, y[1:])
    res_term = lx[N] - y[N]
    return torch.maximum(
        torch.maximum(_lane_max(torch.abs(res_x)), _lane_max(torch.abs(res_u))),
        _lane_max(torch.abs(res_term)),
    )


def feasibility(problem: Problem, convals):
    """max over knots/groups of ||P_K(c) - c||_inf per lane; convals per
    group [N+1, p, B]."""
    B = problem.x0.shape[-1]
    viol = torch.zeros(B, dtype=problem.dtype, device=problem.device)
    for spec, c_j in zip(problem.constraints, convals):
        v = cones.project(spec.cone, c_j.movedim(1, 0)).movedim(0, 1) - c_j
        masked = torch.where(spec.active[:, None, None], torch.abs(v), torch.zeros_like(v))
        if masked.numel():
            viol = torch.maximum(viol, _lane_max(masked))
    return viol


def complementarity(problem: Problem, convals, z):
    B = problem.x0.shape[-1]
    comp = torch.zeros(B, dtype=problem.dtype, device=problem.device)
    for spec, c_j, z_j in zip(problem.constraints, convals, z):
        cz = torch.abs(c_j * z_j)
        masked = torch.where(spec.active[:, None, None], cz, torch.zeros_like(cz))
        if masked.numel():
            comp = torch.maximum(comp, _lane_max(masked))
    return comp


def total_cost(problem: Problem, x, u):
    """Original objective (no AL terms) per lane."""
    N = problem.N
    ks = torch.arange(N, device=x.device)
    stage = problem.cost.stage_value(ks, x[:N], u)
    return torch.sum(stage, dim=0) + problem.cost.term_value(x[N:])[0]


# ---------------------------------------------------------------------------
# Single-lane solve
# ---------------------------------------------------------------------------

_UNSOLVED = int(SolveStatus.UNSOLVED)


class _Span:
    """Adds the host seconds of a `with` block to acc[name] (acc None:
    records nothing)."""

    __slots__ = ("acc", "name", "t0")

    def __init__(self, acc, name):
        self.acc, self.name = acc, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.acc is not None:
            self.acc[self.name] = self.acc.get(self.name, 0.0) + time.perf_counter() - self.t0


def _l(t):
    """One-lane tensor -> lane-minor with B = 1 (a view)."""
    return t[..., None]


def _u(t):
    """Lane-minor with B = 1 -> one-lane tensor (a view)."""
    return t[..., 0]


def _lz(z):
    return tuple(zj[..., None] for zj in z)


def _uz(z):
    return tuple(zj[..., 0] for zj in z)


def _lane_problem(problem: Problem) -> Problem:
    """The problem with x0 [n, 1], for the lane-minor measures."""
    return dataclasses.replace(problem, x0=problem.x0[:, None])


class MeritOut(NamedTuple):
    phi: torch.Tensor
    dphi: torch.Tensor
    x: torch.Tensor  # [N+1, n]
    u: torch.Tensor  # [N, m]
    y: torch.Tensor  # [N+1, n]
    A: torch.Tensor  # [N, n, n]
    B: torch.Tensor  # [N, n, m]
    lx: torch.Tensor  # [N+1, n]
    lu: torch.Tensor  # [N, m]
    convals: Tuple[torch.Tensor, ...]  # per group [N+1, p]
    zproj: Tuple[torch.Tensor, ...]


class MeritOutLight(NamedTuple):
    phi: torch.Tensor
    x: torch.Tensor
    u: torch.Tensor
    y: torch.Tensor
    convals: Tuple[torch.Tensor, ...]
    zproj: Tuple[torch.Tensor, ...]


def open_loop_rollout(problem: Problem, u, x0=None):
    """x_{k+1} = f(x_k, u_k) from x0 (default problem.x0); [N+1, n]."""
    xs = [problem.x0 if x0 is None else x0]
    for k in range(problem.N):
        xs.append(problem.dyn_step(k, xs[-1], u[k]))
    return torch.stack(xs)


def merit_rollout_phi_x(problem: Problem, ref_x, ref_u, K, d, z, rho, alphas, x0):
    """Trial rollouts through the problem's own dynamics and AL cost, for
    every alpha of alphas [W] at once (the JAX function vmapped over
    alpha). Returns (phi [W], xstack [W, N+1, n]).

    The JAX scan adds each knot's AL cost inside the sequential step; the
    cost needs only that knot's (x, u), so here the states roll out with
    the dynamics alone (the trials on the lane axis, a few launches a
    knot), the AL costs follow in one knot-parallel call, and phi sums
    them knot by knot in the scan's order."""
    N, W = problem.N, alphas.shape[0]
    a = alphas.to(x0.dtype)
    x = x0[:, None].expand(-1, W)
    xs, us = [x], []
    for k in range(N):
        u = ref_u[k, :, None] - K[k] @ (x - ref_x[k, :, None]) + a * d[k, :, None]
        x = problem.dyn_step(k, x, u)
        xs.append(x)
        us.append(u)
    ks, kN = _knots(problem, x0.device)
    rho_w = rho.reshape(1).expand(W)
    cost, _, _ = al.al_cost(problem, ks, torch.stack(xs[:N]), torch.stack(us),
                            tuple(zj[:N, :, None].expand(-1, -1, W) for zj in z), rho_w,
                            terminal=False)
    cost_N, _, _ = al.al_cost(problem, kN, x[None], None,
                              tuple(zj[N:, :, None].expand(-1, -1, W) for zj in z), rho_w,
                              terminal=True)
    phi = torch.zeros_like(a)
    for k in range(N):
        phi = phi + cost[k]
    return phi + cost_N[0], torch.stack(xs).permute(2, 0, 1)


def merit_rollout_light(problem: Problem, ref_x, ref_u, K, d, P, p, z, rho,
                        alphas, x0) -> MeritOutLight:
    """Closed-loop rollouts and AL cost without the expansions, each
    trial's light payload (phi, x, u, y, convals, zproj), for every alpha
    of alphas [W] at once (the JAX function vmapped over the block):
    `merit_rollout_phi_x`'s states and phi, then u, y, the constraint
    values and projected duals knot-parallel with the trials on the lane
    axis. The same values as the JAX scan's to roundoff (u, y and the
    rest are per-knot functions of the states). Returns the payload
    stacked on a leading W axis."""
    W = alphas.shape[0]
    phi, xs = merit_rollout_phi_x(problem, ref_x, ref_u, K, d, z, rho, alphas, x0)
    ln = lambda t: t[..., None].expand(*t.shape, W)  # noqa: E731  shared by the trials
    u, y, convals, zproj = ti.light_from_xstack_tiled(
        problem, xs.permute(1, 2, 0), ln(ref_x), ln(ref_u), ln(K), ln(d), ln(P), ln(p),
        tuple(ln(zj) for zj in z), rho.reshape(1).expand(W), alphas.to(x0.dtype))
    lead = lambda t: t.movedim(-1, 0)  # noqa: E731
    return MeritOutLight(phi, xs, lead(u), lead(y), tuple(map(lead, convals)),
                         tuple(map(lead, zproj)))


def light_from_xstack(problem: Problem, phi, x, ref_x, ref_u, K, d, P, p, z, rho,
                      alpha) -> MeritOutLight:
    """Rebuild the light merit payload (u, y, convals, zproj) knot-parallel
    from a rolled-out state trajectory x [N+1, n]."""
    u, y, convals, zproj = ti.light_from_xstack_tiled(
        problem, _l(x), _l(ref_x), _l(ref_u), _l(K), _l(d), _l(P), _l(p), _lz(z),
        rho.reshape(1), alpha)
    return MeritOutLight(phi, x, _u(u), _u(y), _uz(convals), _uz(zproj))


def _knots(problem: Problem, device):
    N = problem.N
    return (torch.arange(N, device=device),
            torch.full((1,), N, dtype=torch.long, device=device))


def al_gradients(problem: Problem, x, u, z, rho):
    """AL cost gradients (lx [N+1, n], lu [N, m]) along a trajectory."""
    N = problem.N
    ks, kN = _knots(problem, x.device)
    xl, zl, r = _l(x), _lz(z), rho.reshape(1)
    lx_st, lu = al.al_grad(problem, ks, xl[:N], _l(u), tuple(zj[:N] for zj in zl), r,
                           terminal=False)
    lxN, _ = al.al_grad(problem, kN, xl[N:], None, tuple(zj[N:] for zj in zl), r,
                        terminal=True)
    return _u(torch.cat([lx_st, lxN], dim=0)), _u(lu)


def al_total_cost_lanes(problem: Problem, x, u, z, rho):
    """Objective + AL penalty terms per lane on lane-minor stacks (the
    reference's CalcCost, solver.cpp:163-174): x [N+1, n, B], u [N, m, B],
    z per group [N+1, p, B], rho [B]; returns [B]."""
    N = problem.N
    ks, kN = _knots(problem, x.device)
    stage = al.al_cost(problem, ks, x[:N], u, tuple(zj[:N] for zj in z), rho, terminal=False)[0]
    term = al.al_cost(problem, kN, x[N:], None, tuple(zj[N:] for zj in z), rho, terminal=True)[0]
    return torch.sum(stage, dim=0) + term[0]


def al_total_cost(problem: Problem, x, u, z, rho):
    """`al_total_cost_lanes` along one lane's trajectory: x [N+1, n],
    u [N, m], z per group [N+1, p], rho 0-dim; returns a 0-dim tensor."""
    return al_total_cost_lanes(problem, _l(x), _l(u), _lz(z), rho.reshape(1))[0]


def dynamics_expansions(problem: Problem, x, u):
    """(A [N, n, n], B [N, n, m]) at a trajectory, knot-parallel."""
    ks, _ = _knots(problem, x.device)
    A, B = problem.dyn_expansion(ks, x[: problem.N].T, u.T)
    return A.permute(2, 0, 1), B.permute(2, 0, 1)


def merit0_derivative(A, B, K, d, lx, lu):
    """dphi/dalpha at alpha = 0 by the forward-sensitivity recurrence over
    the cached linear data (`ti.merit0_derivative_tiled` with one lane)."""
    return ti.merit0_derivative_tiled(_l(A), _l(B), _l(K), _l(d), _l(lx), _l(lu))[0]


def complete_merit_payload(problem: Problem, light: MeritOutLight, K, d, z, rho,
                           with_dphi: bool = True):
    """The full MeritOut from a light payload: dynamics expansions and AL
    gradients knot-parallel, dphi by `merit0_derivative` (NaN when
    with_dphi=False). Returns (dphi, MeritOut)."""
    A, B = dynamics_expansions(problem, light.x, light.u)
    lx, lu = al_gradients(problem, light.x, light.u, z, rho)
    if with_dphi:
        dphi = merit0_derivative(A, B, K, d, lx, lu)
    else:
        dphi = torch.full((), math.nan, dtype=light.phi.dtype, device=light.phi.device)
    return dphi, MeritOut(light.phi, dphi, light.x, light.u, light.y, A, B, lx, lu,
                          light.convals, light.zproj)


def merit_function(problem: Problem, ref_x, ref_u, K, d, P, p, z, rho, alpha, x0,
                   with_derivative: bool, layer_seconds: Optional[dict] = None) -> MeritOut:
    """Closed-loop rollout + AL cost + analytic dphi/dalpha at one alpha
    (the reference's MeritFunction, solver.cpp:273-355): the policy
    u = u_ref - K (x - x_ref) + alpha d, the dual estimate
    y = P (x - x_ref) + p, and the directional derivative by the forward
    sensitivity recurrence du/da = -K dx/da + d, dx'/da = A dx/da + B du/da,
    dphi = sum lx.dx/da + lu.du/da.

    The JAX function steps one knot at a time and takes the Jacobians
    inside that scan. Here the states roll out with the dynamics alone
    (`merit_rollout_phi_x`, one trial); u, y, the constraint values and
    the projected duals follow knot-parallel (`light_from_xstack`); the
    N Jacobians and AL gradients in one knot-parallel call each, then the
    recurrence over them (`complete_merit_payload`). The same values, to
    roundoff. with_derivative=False returns zeros for A, B, lx, lu and
    dphi, as JAX does. layer_seconds: a dict that gains the host seconds
    of the rollout (`grid`) and of the rest (`completion`)."""
    alpha = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device)
    with _Span(layer_seconds, "grid"):
        phi, xs = merit_rollout_phi_x(problem, ref_x, ref_u, K, d, z, rho, alpha.reshape(1), x0)
    with _Span(layer_seconds, "completion"):
        light = light_from_xstack(problem, phi[0], xs[0], ref_x, ref_u, K, d, P, p, z, rho,
                                  alpha)
        if with_derivative:
            return complete_merit_payload(problem, light, K, d, z, rho)[1]
    N, n, m = problem.N, problem.n, problem.m
    zeros = light.x.new_zeros
    return MeritOut(light.phi, zeros(()), light.x, light.u, light.y, zeros((N, n, n)),
                    zeros((N, n, m)), zeros((N + 1, n)), zeros((N, m)), light.convals,
                    light.zproj)


def _cost_expansions_and_cost(problem: Problem, x, u, z, rho, exact=False):
    """Dense AL cost expansions and the total AL cost at a trajectory:
    (lx, lu, lxx [N+1, n, n], luu [N, m, m], lux [N, m, n], al_cost); the
    Gauss-Newton AL Hessian, or with exact=True (SolverOptions.
    exact_al_hessian) the exact one (al.al_hess_exact)."""
    lx, lu, lxx, luu, lux, phi0 = ti.cost_expansions_tiled(
        problem, _l(x), _l(u), _lz(z), rho.reshape(1), diag=False, exact=exact)
    return _u(lx), _u(lu), _u(lxx), _u(luu), _u(lux), phi0[0]


def al_expansions(problem: Problem, x, u, z, rho):
    """Per-knot AL cost expansions (dense, Gauss-Newton) and dynamics
    expansions along one lane's trajectory: (A [N, n, n], B [N, n, m],
    lx [N+1, n], lu [N, m], lxx [N+1, n, n], luu [N, m, m], lux [N, m, n]),
    JAX's order."""
    lx, lu, lxx, luu, lux, _ = _cost_expansions_and_cost(problem, x, u, z, rho)
    A, B = dynamics_expansions(problem, x, u)
    return A, B, lx, lu, lxx, luu, lux


def _cost_expansions_and_cost_diag(problem: Problem, x, u, z, rho):
    """Diagonal AL cost expansions and the total AL cost at a trajectory:
    (lx, lu, lxx_diag [N+1, n], luu_diag [N, m], None, al_cost)."""
    lx, lu, lxx, luu, _, phi0 = ti.cost_expansions_tiled(
        problem, _l(x), _l(u), _lz(z), rho.reshape(1), diag=True)
    return _u(lx), _u(lu), _u(lxx), _u(luu), None, phi0[0]


def _trajectory_convals(problem: Problem, x, u):
    """Constraint values along a trajectory, per group [N+1, p]."""
    N = problem.N
    ks, kN = _knots(problem, x.device)
    stage = al.constraint_values(problem, ks, _l(x[:N]), _l(u))
    term = al.constraint_values(problem, kN, _l(x[N:]), x.new_zeros((1, problem.m, 1)))
    return tuple(_u(torch.cat([s, t], dim=0)) for s, t in zip(stage, term))


def _retry_loop(opts: SolverOptions, attempt, reg0):
    """Adaptive-regularization retry: while the factorization fails, bump
    reg geometrically (up to reg_max_retries) and re-run `attempt`. One
    host sync per attempt (on ok)."""
    return retry(attempt, reg0, opts.reg_min, opts.reg_scaling, opts.reg_max_retries)


def backward_adaptive(opts: SolverOptions, A, B, lxx, luu, lux, lx, lu, reg0):
    """Single-lane backward pass with the retry: under `pallas_backward`
    the plain serial recursion (JAX's fused dispatcher on one lane runs
    its scan, altro_tpu/solver.py:635-641; it takes precedence over
    pallas_latency_backward and runs on any device); else the latency
    dispatcher (the kernel on CUDA tensors) when pallas_latency_backward,
    else the plain recursion on whatever device the operands are. The
    caller has refused parallel_riccati (`single_lane_refusal`) and
    pallas_backward's exclusions (`check_pallas_backward`)."""
    A, B, lxx, luu, lx, lu = (t.contiguous() for t in (A, B, lxx, luu, lx, lu))
    lux = None if lux is None else lux.contiguous()
    if opts.pallas_latency_backward and not opts.pallas_backward:
        def attempt(reg):
            return tvlqr_backward_latency(A, B, None, lxx, luu, lux, lx, lu, reg,
                                          symmetrize=opts.symmetrize_ctg)
    else:
        def attempt(reg):
            return riccati_latency_ref(A, B, lxx, luu, lx, lu, reg, lux=lux)
    return _retry_loop(opts, attempt, reg0)


def _alpha0_merit_out(problem: Problem, x, u, z, rho, convals, A, B, lx, lu, gains,
                      phi0, dphi0) -> MeritOut:
    """merit(0) from cached data: the reference trajectory, y = p, the
    loop-top expansions, and one projection of z - rho c per group."""
    _, zproj = al.projected_duals(problem, _lz(convals), _lz(z), rho.reshape(1))
    return MeritOut(phi0, dphi0, x, u, gains.p, A, B, lx, lu, convals, _uz(zproj))


def check_pallas_backward(opts: SolverOptions) -> None:
    """JAX's ValueError for pallas_backward with parallel_riccati or
    symmetrize_ctg (altro_tpu/solver.py:629-634)."""
    if opts.pallas_backward and (opts.parallel_riccati or opts.symmetrize_ctg):
        raise ValueError(
            "pallas_backward is mutually exclusive with parallel_riccati "
            "and symmetrize_ctg (the fused kernel implements the plain "
            "serial recursion); disable one of them")


def grid_search_refusal(opts: SolverOptions) -> Optional[str]:
    """Why the batched solves (the vmapped solve of parallel/batch.py) cannot
    run these options, or None: every line search of `jax.vmap(solve)`
    runs, the light-payload grid included, with the solve's verbosity
    tiers and `iteration_callback` per lane; the line searches' own
    per-trial trace (Verbosity.LINE_SEARCH) is not printed by the batch."""
    checks = (
        (opts.parallel_riccati, "parallel_riccati is not ported"),
        (opts.verbose >= Verbosity.LINE_SEARCH,
         "Verbosity.LINE_SEARCH (the line searches' per-trial trace) is not ported for the "
         "batched solves"),
    )
    return next((why for bad, why in checks if bad), None)


def _phase_split(opts: SolverOptions) -> bool:
    """True when the solve searches the phase-split grid."""
    return opts.parallel_linesearch and opts.ls_phase_split


def _kernel_grid(opts: SolverOptions) -> bool:
    """True when the options ask for the trial-rollout kernel: the
    phase-split x-only grid with `pallas_rollout` (JAX's light-payload
    grid and its RTI step pass no `merit_grid`)."""
    return (_phase_split(opts) and opts.ls_grid_x_only and opts.pallas_rollout
            and not opts.rti_mode)


def _trial_grid(problem: Problem, opts: SolverOptions) -> bool:
    """True when the phase-split grid runs through the trial rollout: with
    `pallas_rollout`, a block step, a diagonal cost and affine
    NEGATIVE_ORTHANT groups, as JAX asks (altro_tpu/solver.py:770-790,
    :924-930); else the problem's own grid, as JAX falls back to its scan
    grid. A CUDA problem that would fall back is refused instead
    (`single_lane_refusal`)."""
    return _kernel_grid(opts) and problem_ineligibility(problem, rows=False) is None


def single_lane_refusal(problem: Problem, opts: SolverOptions) -> Optional[str]:
    """Why `solve` does not run this configuration, or None: an option it
    does not implement, or, on a CUDA problem, a kernel that cannot take
    it (checked before anything launches; the plain paths are selected by
    pallas_latency_backward=False and pallas_rollout=False). A CPU problem
    that the trial rollout cannot take runs the problem's own grid, as
    JAX's solve does."""
    if opts.parallel_riccati:
        return "parallel_riccati is not ported"
    if problem.device.type != "cuda":
        return None
    kernel_grid = _kernel_grid(opts)
    if kernel_grid:
        grid_why = problem_ineligibility(problem)
        if grid_why is not None:
            return (f"pallas_rollout (the trial-rollout grid) cannot take this problem: "
                    f"{grid_why}; pallas_rollout=False selects the problem's own grid")
    f32 = problem.dtype == torch.float32
    if opts.pallas_latency_backward and not opts.pallas_backward:
        bad = []
        if (problem.n, problem.m) not in rl.KERNEL_SHAPES:
            bad.append(f"no instantiation for n={problem.n}, m={problem.m} (it has "
                       f"{', '.join(map(str, rl.KERNEL_SHAPES))})")
        if not f32:
            bad.append(f"{problem.dtype} (it takes float32)")
        if bad:
            return (f"pallas_latency_backward: the backward kernel (riccati_latency): "
                    f"{', '.join(bad)}; pallas_latency_backward=False selects the plain "
                    f"backward")
    if kernel_grid and not f32:
        return (f"pallas_rollout: the trial-rollout kernel takes float32, not "
                f"{problem.dtype}; pallas_rollout=False selects the problem's own grid")
    if kernel_grid:
        rows = sum(spec.dim for spec in problem.constraints)
        grid_why = ineligibility(problem.dynamics_tile, problem.n, problem.m,
                                 int(opts.ls_parallel_width), rows)
        if grid_why is not None:
            return (f"pallas_rollout: the trial-rollout kernel (trial_rollout): {grid_why}; "
                    f"pallas_rollout=False selects the problem's own grid")
    return None


def reports(opts: SolverOptions) -> bool:
    """True when the solve reports its iterations: a verbosity tier that
    prints them, or an `iteration_callback`."""
    return opts.iteration_callback is not None or opts.verbose >= Verbosity.OUTER


def emit(opts: SolverOptions, it, p0, p, d0, d, a, li, s, f, r, rn, du):
    """One iteration's `iteration_callback(iter, phi, stat, feas, alpha,
    rho)` and its INNER or OUTER line (altro_tpu/solver.py:1176-1200),
    from host numbers."""
    if opts.iteration_callback is not None:
        opts.iteration_callback(it, p, s, f, a, r)
    if opts.verbose >= Verbosity.INNER:
        print("  iter = {i}, phi = {p0:.6} -> {p:.6}, dphi = {d0:.4} -> {d:.4}, "
              "alpha = {a:.4}, ls_iter = {li}, stat = {s:.4}, feas = {f:.4}, "
              "rho = {r:.3}, dual update? {du}".format(
                  i=it, p0=p0, p=p, d0=d0, d=d, a=a, li=int(li), s=s, f=f, r=r, du=bool(du)))
    elif opts.verbose == Verbosity.OUTER and du:
        print("  outer: iter = {i}, phi = {p:.6}, stat = {s:.4}, "
              "feas = {f:.4}, rho = {r:.3} -> {rn:.3}".format(i=it, p=p, s=s, f=f, r=r, rn=rn))


def banner_start(cost):
    """The solve's first line (altro_tpu/solver.py:790-794)."""
    print("STARTING ALTRO iLQR SOLVE....\n  Initial Cost: {c}".format(c=cost))


def banner_end(iterations, status):
    """The solve's last line (altro_tpu/solver.py:1232-1236)."""
    print(f"ALTRO SOLVE FINISHED! iterations = {iterations}, status = {status}")


def _report(opts: SolverOptions, it, phi0, dphi0, m, alpha, ls_iters, stat, feas, rho,
            rho_new, do_dual):
    """One iteration's report (`emit`) from one host read; nothing at
    SILENT without a callback."""
    if not reports(opts):
        return
    vals = _read(float, phi0, m.phi, dphi0, m.dphi, alpha, ls_iters, stat, feas, rho, rho_new,
                 do_dual)
    emit(opts, it, *vals)


class Update(NamedTuple):
    """An iteration's criteria, dual/penalty update and status, per lane [B]
    (`iteration_update`)."""

    stat: torch.Tensor
    feas: torch.Tensor
    z: Tuple[torch.Tensor, ...]  # the updated duals, per group [N+1, p, B]
    rho: torch.Tensor
    status: torch.Tensor  # int32
    ls_fails: torch.Tensor  # int32
    reg: torch.Tensor  # reg used, escalated under ls_failure_recovery
    stop: torch.Tensor  # bool
    do_dual: torch.Tensor  # bool


def iteration_update(problem: Problem, opts: SolverOptions, m, *, z, rho, status, ls_fails,
                     reg_used, phi_prev, it, grad_small, bp_failed, ls_failed) -> Update:
    """Steps 6-7 of an AL-iLQR iteration and its status chain, per lane on
    lane-minor stacks (altro_tpu/solver.py:1020-1130): the optimality
    criteria at the candidate `m` (a `tile_iter.Payload`: x, u, y, A, B,
    lx, lu, convals, zproj [..., B], phi [B]), the adaptive dual and
    penalty update, the status chain (lowest priority first;
    MERIT_FUN_GRADIENT_TOO_SMALL sticky only while the gradient stays
    small), ls_failure_recovery and the stop flag. z, rho, status,
    ls_fails, phi_prev: the iteration's incoming values; it: its index (an
    int, or an int tensor [B]); grad_small, bp_failed, ls_failed [B] bool.
    The single-lane solve, the batched lane loop and the exported graph
    (graph_solve.py) all run it; the single-lane solve with B = 1."""
    Bsz = m.phi.shape[-1]
    dev = m.phi.device
    kw = dict(dtype=m.phi.dtype, device=dev)

    def lanes_max(t):
        return torch.abs(t).flatten(0, -2).amax(0)

    stat = stationarity(m.A, m.B, m.lx, m.lu, m.y)
    feas = feasibility(problem, m.convals)
    stat_tol = torch.full((Bsz,), opts.tol_stationarity, **kw)
    if opts.tol_stationarity_rel > 0:
        scale = torch.maximum(torch.maximum(lanes_max(m.lx), lanes_max(m.lu)), lanes_max(m.y))
        stat_tol = torch.maximum(stat_tol, opts.tol_stationarity_rel * scale)
    no = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    x_oob, u_oob, obj_exceeded = no, no, no
    if math.isfinite(opts.max_state_value):
        x_oob = lanes_max(m.x) > opts.max_state_value
    if math.isfinite(opts.max_input_value):
        u_oob = lanes_max(m.u) > opts.max_input_value
    if math.isfinite(opts.max_objective_value):
        obj_exceeded = ~torch.isfinite(m.phi) | (m.phi > opts.max_objective_value)
    diverged = obj_exceeded | x_oob | u_oob
    converged = (torch.abs(stat) < stat_tol) & (feas < opts.tol_primal_feasibility)
    if opts.enable_cost_tolerance:
        converged = converged | ((it > 0) & (torch.abs(phi_prev - m.phi) < opts.tol_cost)
                                 & (feas < opts.tol_primal_feasibility))

    # 7. adaptive dual/penalty update
    do_dual = stat < torch.sqrt(torch.tensor(opts.tol_stationarity, **kw))
    z_new = tuple(torch.where(do_dual & spec.active[:, None, None], zp, zj)
                  for spec, zp, zj in zip(problem.constraints, m.zproj, z))
    do_penalty = do_dual & (feas > opts.tol_primal_feasibility)
    rho_new = torch.where(
        do_penalty, torch.clamp(rho * opts.penalty_scaling, max=opts.penalty_max), rho)

    def code(s):
        return torch.full((Bsz,), int(s), dtype=torch.int32, device=dev)

    new_status = torch.where(status == int(SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL),
                             code(SolveStatus.UNSOLVED), status)
    grad_small_stat = no if opts.rti_mode else grad_small
    for cond_, s in ((grad_small_stat, SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL),
                     (u_oob, SolveStatus.INPUT_OUT_OF_BOUNDS),
                     (x_oob, SolveStatus.STATE_OUT_OF_BOUNDS),
                     (obj_exceeded, SolveStatus.MAX_OBJECTIVE_EXCEEDED),
                     (bp_failed, SolveStatus.BACKWARD_PASS_FAILED),
                     (ls_failed, SolveStatus.LINE_SEARCH_FAILED),
                     (converged, SolveStatus.SUCCESS)):
        new_status = torch.where(cond_, code(s), new_status)
    ls_fails_new = ls_fails + ls_failed.to(torch.int32)
    if opts.ls_failure_recovery:
        reg_cap = opts.reg_min * opts.reg_scaling ** opts.reg_max_retries
        escalated = torch.clamp(
            torch.where(reg_used <= 0, torch.full_like(reg_used, opts.reg_min),
                        reg_used * opts.reg_scaling), max=reg_cap)
        reg_used = torch.where(ls_failed, escalated, reg_used)
        cleared = ~ls_failed & ~converged & (status == int(SolveStatus.LINE_SEARCH_FAILED))
        new_status = torch.where(cleared, code(SolveStatus.UNSOLVED), new_status)
        cap = opts.ls_recovery_max_fails
        exhausted = (ls_failed & (ls_fails_new > cap)) if cap > 0 else no
        stop = converged | bp_failed | exhausted
    else:
        stop = converged | ls_failed | bp_failed
    return Update(stat, feas, z_new, rho_new, new_status, ls_fails_new, reg_used,
                  stop | diverged, do_dual)


def solve(problem: Problem, state: SolverState, opts: SolverOptions = SolverOptions(),
          layer_seconds: Optional[dict] = None):
    """Single-lane AL-iLQR solve. Returns (SolverState, SolveStats), both in
    the one-lane layout (problem.x0 [n], state.x [N+1, n], scalars 0-dim).

    On CUDA tensors the backward pass and the trial rollout run their
    kernels (float32) or the solve is refused before it starts
    (`single_lane_refusal`); on CPU tensors their plain versions run.
    The phase-split grid with `pallas_rollout` runs the trial rollout on
    a problem with a block step, a diagonal cost and only affine
    NEGATIVE_ORTHANT groups; on the CPU any other problem runs its own
    grid, as the JAX solve falls back to it, and on CUDA it is refused
    with its reason. `pallas_latency_backward=False` and
    `pallas_rollout=False` select the plain paths on any device. The
    strong-Wolfe search and the non-split grid evaluate the merit through
    the problem's own dynamics and AL cost (`merit_function`), as JAX's do.

    layer_seconds: a dict to accumulate host seconds per layer into:
    open_loop_rollout, expansions, backward (with its retry syncs),
    line_search (inclusive of what follows, and of its syncs: one per
    grid block beyond the first, one per strong-Wolfe trial), grid (the
    trial rollouts: the grid's, or each strong-Wolfe trial's), completion
    (payload and dphi of a trial), update (criteria, duals, status) and
    sync (the iteration's wait on `stop`).
    """
    if opts.ls_armijo_only and not (opts.rti_mode or opts.ls_phase_split):
        raise ValueError(
            "ls_armijo_only requires ls_phase_split (or rti_mode): without the phase-split "
            "line search the directional derivative is computed inside the merit rollout "
            "and cannot be skipped")
    if (not opts.rti_mode and opts.parallel_linesearch
            and not opts.use_backtracking_linesearch):
        raise ValueError("parallel_linesearch requires use_backtracking_linesearch")
    check_pallas_backward(opts)
    why = single_lane_refusal(problem, opts)
    if why is not None:
        raise NotImplementedError(f"solve: {why}")
    N = problem.N
    dtype, dev = problem.dtype, problem.device
    kw = dict(dtype=dtype, device=dev)
    lp = _lane_problem(problem)

    def span(name):
        return _Span(layer_seconds, name)

    ls_opts = LineSearchOptions(
        c1=opts.ls_c1, c2=opts.ls_c2, max_iters=opts.ls_max_iters,
        alpha_max=opts.ls_alpha_max, beta_increase=opts.ls_beta_increase,
        beta_decrease=opts.ls_beta_decrease, min_interval_size=opts.ls_min_interval_size,
        try_cubic_first=opts.ls_try_cubic_first,
        use_backtracking=opts.use_backtracking_linesearch,
        armijo_slack=opts.ls_armijo_slack, verbose=opts.verbose >= Verbosity.LINE_SEARCH)

    rho = torch.tensor(opts.penalty_initial, **kw)
    if opts.penalty_warm_start:
        rho = torch.clamp(state.rho.to(dtype) * opts.penalty_warm_start_decay,
                          min=opts.penalty_initial, max=opts.penalty_max)
    x0 = problem.x0
    with span("open_loop_rollout"):
        x = open_loop_rollout(problem, state.u)
    u = state.u
    with span("expansions"):
        convals = _trajectory_convals(problem, x, u)
        A, B = dynamics_expansions(problem, x, u)

    # dense expansions unless the AL Hessian is diagonal (altro_tpu/
    # solver.py:745-752, 832-837; parallel_riccati is refused); the exact
    # AL Hessian and pallas_backward's operands are dense
    diag_mode = (opts.diag_expansion and al.diag_expansion_eligible(problem)
                 and not opts.exact_al_hessian and not opts.pallas_backward)
    if diag_mode:
        expand = _cost_expansions_and_cost_diag
    elif opts.exact_al_hessian:
        expand = functools.partial(_cost_expansions_and_cost, exact=True)
    else:
        expand = _cost_expansions_and_cost

    # the trial-rollout grid (a problem with its block step, diagonal cost
    # and affine NEGATIVE_ORTHANT groups; their rows are extracted once)
    cost = problem.cost
    kernel_grid = _trial_grid(problem, opts)
    rollout_con = None
    if kernel_grid and problem.constraints:
        ax, au, g_raw, act = affine_constraint_stacks(problem)
        rollout_con = (ax * act[..., None], au * act[..., None], g_raw, act)

    y, z, K, d, P, p = state.y, state.z, state.K, state.d, state.P, state.p
    if opts.verbose > Verbosity.SILENT:  # altro_tpu/solver.py:790-794
        banner_start(float(al_total_cost(problem, x, u, z, rho)))
    reg = torch.tensor(opts.reg_initial, **kw)
    status = torch.tensor(_UNSOLVED, dtype=torch.int32, device=dev)
    phi = torch.zeros((), **kw)
    dphi = torch.zeros((), **kw)
    alpha = torch.zeros((), **kw)
    stat = torch.full((), math.inf, **kw)
    feas = torch.full((), math.inf, **kw)
    ls_iters = torch.zeros((), dtype=torch.int32, device=dev)
    ls_fails = torch.zeros((), dtype=torch.int32, device=dev)
    bp_fail_index = torch.tensor(N, dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), **kw)

    def code(s):
        return torch.tensor(int(s), dtype=torch.int32, device=dev)

    it = 0
    stop = False
    while it < opts.iterations_max and not stop:
        # 1-2. expansions at the reference trajectory + backward with retry
        with span("expansions"):
            lx, lu, lxx, luu, lux, phi0 = expand(problem, x, u, z, rho)
        with span("backward"):
            gains, reg_used = backward_adaptive(opts, A, B, lxx, luu, lux, lx, lu, reg)
        bp_failed = ~gains.ok

        # 3. dphi(0) from the expected-decrease identity
        dphi0 = gains.delta_V[0]
        grad_small = torch.abs(dphi0) < opts.tol_meritfun_gradient
        with span("expansions"):
            aux0 = _alpha0_merit_out(problem, x, u, z, rho, convals, A, B, lx, lu, gains,
                                     phi0, dphi0)

        # 4. line search (the closures run inside this iteration's search,
        #    on this iteration's values)
        def reconstruct(xstack, a, ph):
            with span("completion"):
                return light_from_xstack(problem, ph, xstack, x, u, gains.K, gains.d,
                                         gains.P, gains.p, z, rho, a)

        def complete(light, with_dphi=True):
            with span("completion"):
                return complete_merit_payload(problem, light, gains.K, gains.d, z, rho,
                                              with_dphi=with_dphi)

        if kernel_grid:
            con = None
            if rollout_con is not None:
                axm, aum, g_raw, act = rollout_con
                cz = torch.cat(z, dim=1)
                con = (rho * axm, rho * aum, (cz - rho * g_raw) * act, 1.0 / (2.0 * rho))
            ops = (x0, x.contiguous(), u.contiguous(), gains.K, gains.d, cost.Q, cost.q,
                   cost.R, cost.r, cost.c, problem.h)

            def merit_grid(alphas):
                with span("grid"):
                    return trial_rollout(problem.dynamics_tile, alphas, *ops, con=con)
        else:
            def merit_grid(alphas):
                with span("grid"):
                    return merit_rollout_phi_x(problem, x, u, gains.K, gains.d, z, rho,
                                               alphas, x0)

        def light_grid(alphas):  # the light payload of every trial (no kernel)
            with span("grid"):
                light = merit_rollout_light(problem, x, u, gains.K, gains.d, gains.P, gains.p,
                                            z, rho, alphas, x0)
            return light.phi, light

        with span("line_search"):
            if opts.rti_mode:  # the full step (altro_tpu/solver.py:865-893)
                one = torch.ones(1, **kw)
                if opts.ls_phase_split:
                    if opts.ls_grid_x_only:
                        with span("grid"):
                            phi_1, xs_1 = merit_rollout_phi_x(problem, x, u, gains.K, gains.d,
                                                              z, rho, one, x0)
                        light = reconstruct(xs_1[0], one[0], phi_1[0])
                    else:
                        light = tree_map(lambda t: t[0], light_grid(one)[1])
                    m_rti = complete(light, with_dphi=not opts.ls_armijo_only)[1]
                else:
                    m_rti = merit_function(problem, x, u, gains.K, gains.d, gains.P, gains.p,
                                           z, rho, one[0], x0, True, layer_seconds)
            elif _phase_split(opts):
                ls = parallel_backtracking_search_split(
                    None, complete, phi0, dphi0, 1.0, ls_opts, width=opts.ls_parallel_width,
                    armijo_only=opts.ls_armijo_only,
                    reconstruct=reconstruct if opts.ls_grid_x_only else None,
                    merit_grid=merit_grid if opts.ls_grid_x_only else light_grid,
                    best_decrease_fallback=opts.ls_best_decrease_fallback)
            elif opts.parallel_linesearch:
                ls = parallel_backtracking_search(
                    None, phi0, dphi0, 1.0, ls_opts, width=opts.ls_parallel_width,
                    merit_grid=merit_grid, reconstruct=reconstruct, complete=complete)
            else:
                def merit_full(alpha):
                    out = merit_function(problem, x, u, gains.K, gains.d, gains.P, gains.p,
                                         z, rho, alpha, x0, True, layer_seconds)
                    return out.phi, out.dphi, out

                def merit_light(alpha):  # a backtracking trial: phi and its states
                    phi_a, xs = merit_grid(alpha.reshape(1))
                    return phi_a[0], (xs[0], alpha, phi_a[0])

                ls = wolfe_line_search(merit_full, None, phi0, dphi0, 1.0, ls_opts, aux0=aux0,
                                       merit_light=merit_light,
                                       complete=lambda light: complete(reconstruct(*light)))
        with span("update"):
            if opts.rti_mode:  # the full step's payload, never a failed search
                alpha, ls_failed, n_iters = torch.ones((), **kw), no, torch.ones_like(ls_iters)
                m = m_rti
            else:
                alpha = torch.where(grad_small, zero, ls.alpha)
                ls_ok = (ls.code == int(LineSearchCode.MINIMUM_FOUND)) | (
                    ls.code == int(LineSearchCode.HIT_MAX_STEPSIZE))
                ls_failed = ~grad_small & (torch.isnan(alpha) | ~ls_ok)
                ls_accepted = ls_ok | (ls.code == int(LineSearchCode.BEST_DECREASE))
                n_iters = ls.n_iters

                # 5. accepted-step payload, or merit(0) on the short-circuit and
                #    failure paths
                use_ls_payload = ls_accepted & ~grad_small & (ls.aux_alpha == alpha)
                m = tree_map(lambda a, b: torch.where(use_ls_payload, a, b), ls.aux, aux0)

            # 6-7. criteria, dual/penalty update and status chain (one lane)
            one = lambda t: t.reshape(1)  # noqa: E731  a 0-dim value as one lane
            upd = iteration_update(
                lp, opts, ti.Payload(one(m.phi), one(m.dphi), _l(m.x), _l(m.u), _l(m.y),
                                     _l(m.A), _l(m.B), _l(m.lx), _l(m.lu), _lz(m.convals),
                                     _lz(m.zproj)),
                z=_lz(z), rho=one(rho), status=one(status), ls_fails=one(ls_fails),
                reg_used=one(reg_used), phi_prev=one(phi), it=it, grad_small=one(grad_small),
                bp_failed=one(bp_failed), ls_failed=one(ls_failed))
            stat, feas, rho_new, do_dual = upd.stat[0], upd.feas[0], upd.rho[0], upd.do_dual[0]
            stop_t = upd.stop[0]
            _report(opts, it, phi0, dphi0, m, alpha, n_iters, stat, feas, rho, rho_new,
                    do_dual)

            x, u, y, z, rho = m.x, m.u, m.y, _uz(upd.z), rho_new
            K, d, P, p, reg = gains.K, gains.d, gains.P, gains.p, upd.reg[0]
            convals, A, B = m.convals, m.A, m.B
            status, phi, dphi = upd.status[0], m.phi, m.dphi
            ls_iters, ls_fails = n_iters, upd.ls_fails[0]
            bp_fail_index = gains.fail_index.to(torch.int32)
            it += 1
        with span("sync"):
            stop = bool(stop_t)  # the iteration's host sync

    if opts.verbose > Verbosity.SILENT:  # altro_tpu/solver.py:1232-1236
        banner_end(it, int(status))
    if it >= opts.iterations_max:
        status = torch.where(status == _UNSOLVED, code(SolveStatus.MAX_ITERATIONS), status)
    new_state = SolverState(x=x, u=u, y=y, z=z, rho=rho, K=K, d=d, P=P, p=p, reg=reg)
    stats = SolveStats(
        status=status,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        objective_value=total_cost(lp, _l(x), _l(u))[0],
        merit_value=phi,
        stationarity=stat,
        primal_feasibility=feas,
        complementarity=complementarity(lp, _lz(convals), _lz(z))[0],
        rho=rho,
        alpha=alpha,
        ls_iterations=ls_iters,
        dphi=dphi,
        bp_fail_index=bp_fail_index,
    )
    return new_state, stats
