"""Batched solver-iteration building blocks on lane-minor stacks.

Counterpart: altro_tpu/ops/tile_iter.py (`cost_expansions_tiled`,
`completion_tiled`, `light_from_xstack_tiled`, `retry_tiled`,
`select_trial_tiled`, `select_best_tiled`) and, for the vmapped solve's
searches, altro_tpu/solver.py's `merit0_derivative`, `merit_function`
(`merit_tiled`: each lane at its own alpha) and `_alpha0_merit_out`
(`alpha0_payload_tiled`), with `MeritOut` as `Payload`. The JAX module lifted
per-lane functions over (8, 128) lane tiles with nested vmaps; here
every array carries the lanes on its last axis ([N(+1), entry..., B]),
the knot-parallel pieces run on whole knot stacks at once, and a
per-lane mask [B] broadcasts against any of them unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from altro_tpu_torch import al
from altro_tpu_torch.linesearch import Trace
from altro_tpu_torch.ops.rollout_grid import rollout_grid_ref

__all__ = [
    "cost_expansions_tiled",
    "completion_tiled",
    "light_from_xstack_tiled",
    "merit0_derivative_tiled",
    "Payload",
    "payload_tiled",
    "alpha0_payload_tiled",
    "merit_tiled",
    "retry_tiled",
    "select_trial_tiled",
    "select_best_tiled",
]


def _knots(problem, device):
    N = problem.N
    return (torch.arange(N, device=device),
            torch.full((1,), N, dtype=torch.long, device=device))


def cost_expansions_tiled(problem, x, u, z, rho, diag=False, exact=False):
    """AL cost expansions and total AL cost, without the dynamics
    Jacobians (those are carried from the accepted-step completion).

    x [N+1, n, B], u [N, m, B], z per group [N+1, p, B], rho [B].
    Returns (lx, lu, lxx, luu, lux_or_None, phi0 [B]); with diag=True
    lxx/luu are diagonals ([N+1, n, B] / [N, m, B]) and lux is None;
    exact=True (dense only) takes the exact AL Hessian (`al.al_hess_exact`,
    SolverOptions.exact_al_hessian) for the Gauss-Newton one.
    """
    N = problem.N
    ks, kN = _knots(problem, x.device)
    zs = tuple(zj[:N] for zj in z)
    zN = tuple(zj[N:] for zj in z)
    xs, xN = x[:N], x[N:]
    lx_st, lu = al.al_grad(problem, ks, xs, u, zs, rho, terminal=False)
    lxN, _ = al.al_grad(problem, kN, xN, None, zN, rho, terminal=True)
    if diag:
        lxx_st, luu = al.al_hess_diag(problem, ks, xs, u, zs, rho, terminal=False)
        lxxN, _ = al.al_hess_diag(problem, kN, xN, None, zN, rho, terminal=True)
        lux = None
    else:
        hess = al.al_hess_exact if exact else al.al_hess
        lxx_st, luu, lux = hess(problem, ks, xs, u, zs, rho, terminal=False)
        lxxN, _, _ = hess(problem, kN, xN, None, zN, rho, terminal=True)
    cost_st, _, _ = al.al_cost(problem, ks, xs, u, zs, rho, terminal=False)
    costN, _, _ = al.al_cost(problem, kN, xN, None, zN, rho, terminal=True)
    lx = torch.cat([lx_st, lxN], dim=0)
    lxx = torch.cat([lxx_st, lxxN], dim=0)
    phi0 = torch.sum(cost_st, dim=0) + costN[0]
    return lx, lu, lxx, luu, lux, phi0


def completion_tiled(problem, x, u, z, rho):
    """Dynamics Jacobians and AL gradients at the accepted trajectory,
    knot-parallel. Returns (A [N, n, n, B], B [N, n, m, B], lx, lu)."""
    N = problem.N
    ks, kN = _knots(problem, x.device)
    A, Bm = problem.dyn_expansion(ks[:, None], x[:N].movedim(1, 0), u.movedim(1, 0))
    A = A.permute(2, 0, 1, 3)
    Bm = Bm.permute(2, 0, 1, 3)
    lx_st, lu = al.al_grad(problem, ks, x[:N], u, tuple(zj[:N] for zj in z), rho,
                           terminal=False)
    lxN, _ = al.al_grad(problem, kN, x[N:], None, tuple(zj[N:] for zj in z), rho,
                        terminal=True)
    return A, Bm, torch.cat([lx_st, lxN], dim=0), lu


def light_from_xstack_tiled(problem, x, ref_x, ref_u, K, d, P, p, z, rho, alpha):
    """Rebuild (u, y, convals, zproj) knot-parallel from a rolled-out state
    trajectory x [N+1, n, B]; alpha [B]."""
    N = problem.N
    ks, kN = _knots(problem, x.device)
    dx = x[:N] - ref_x[:N]
    u = ref_u - torch.einsum("kjib,kib->kjb", K, dx) + alpha * d
    y_st = torch.einsum("kijb,kjb->kib", P[:N], dx) + p[:N]
    _, conv_st, zp_st = al.al_cost(problem, ks, x[:N], u, tuple(zj[:N] for zj in z),
                                   rho, terminal=False)
    yN = torch.einsum("ijb,jb->ib", P[N], x[N] - ref_x[N]) + p[N]
    _, conv_N, zp_N = al.al_cost(problem, kN, x[N:], None, tuple(zj[N:] for zj in z),
                                 rho, terminal=True)
    y = torch.cat([y_st, yN[None]], dim=0)
    convals = tuple(torch.cat([a, b], dim=0) for a, b in zip(conv_st, conv_N))
    zproj = tuple(torch.cat([a, b], dim=0) for a, b in zip(zp_st, zp_N))
    return u, y, convals, zproj


def merit0_derivative_tiled(A, B, K, d, lx, lu):
    """dphi/dalpha at alpha = 0 per lane by the forward-sensitivity
    recurrence over cached linear data (altro_tpu/solver.py::
    merit0_derivative, a Python loop over knots). A [N, n, n, B],
    B [N, n, m, B], K [N, m, n, B], d [N, m, B], lx [N+1, n, B],
    lu [N, m, B]; returns [B]."""
    N = A.shape[0]
    dx = A.new_zeros(A.shape[1:2] + A.shape[3:])
    contribs = []
    for k in range(N):
        du = d[k] - torch.einsum("jib,ib->jb", K[k], dx)
        contribs.append(torch.sum(lx[k] * dx, dim=0) + torch.sum(lu[k] * du, dim=0))
        dx = torch.einsum("ijb,jb->ib", A[k], dx) + torch.einsum("ijb,jb->ib", B[k], du)
    return torch.sum(torch.stack(contribs), dim=0) + torch.sum(lx[N] * dx, dim=0)


class Payload(NamedTuple):
    """The merit's payload at one step per lane (altro_tpu/solver.py::
    MeritOut, lane-minor): phi, dphi [B], the trajectory x [N+1, n, B],
    u [N, m, B], y [N+1, n, B], the dynamics expansions A, B, the AL
    gradients lx, lu, and per group the constraint values and projected
    duals [N+1, p, B]."""

    phi: torch.Tensor
    dphi: torch.Tensor
    x: torch.Tensor
    u: torch.Tensor
    y: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    lx: torch.Tensor
    lu: torch.Tensor
    convals: Tuple[torch.Tensor, ...]
    zproj: Tuple[torch.Tensor, ...]


def payload_tiled(problem, x, alpha, phi, ref_x, ref_u, K, d, P, p, z, rho,
                  with_dphi=True) -> Payload:
    """The payload of a rolled-out trial x [N+1, n, B] at alpha [B] with
    merit phi [B]: u, y, the constraint values and projected duals
    knot-parallel (`light_from_xstack_tiled`), the expansions at (x, u)
    (`completion_tiled`) and dphi by the forward-sensitivity recurrence
    (NaN when with_dphi=False), as complete_merit_payload does."""
    u, y, convals, zproj = light_from_xstack_tiled(problem, x, ref_x, ref_u, K, d, P, p, z,
                                                   rho, alpha)
    A, B, lx, lu = completion_tiled(problem, x, u, z, rho)
    if with_dphi:
        dphi = merit0_derivative_tiled(A, B, K, d, lx, lu)
    else:
        dphi = torch.full_like(phi, float("nan"))
    return Payload(phi, dphi, x, u, y, A, B, lx, lu, convals, zproj)


def alpha0_payload_tiled(problem, x, u, p, z, rho, convals, A, B, lx, lu, phi0,
                         dphi0) -> Payload:
    """merit(0) from cached data (altro_tpu/solver.py::_alpha0_merit_out):
    the reference trajectory, y = p, the loop-top expansions and one
    projection of z - rho c per group."""
    _, zproj = al.projected_duals(problem, convals, z, rho)
    return Payload(phi0, dphi0, x, u, p, A, B, lx, lu, convals, zproj)


def merit_tiled(problem, ref_x, ref_u, K, d, P, p, z, rho, alpha, x0):
    """The full merit at one alpha per lane (altro_tpu/solver.py::
    merit_function with_derivative=True, vmapped): the closed-loop
    rollout through the problem's own dynamics and AL cost at alpha [B]
    (`rollout_grid_ref`, one trial a lane), then its payload with dphi.
    Returns (phi [B], dphi [B], Payload)."""
    phis, xs = rollout_grid_ref(problem, ref_x, ref_u, K, d, z, rho, alpha[None], x0)
    out = payload_tiled(problem, xs[0], alpha, phis[0], ref_x, ref_u, K, d, P, p, z, rho)
    return out.phi, out.dphi, out


def retry_tiled(opts, attempt, reg0, trace: Optional[Trace] = None):
    """Adaptive-regularization retry over the whole batch: lanes already
    ok keep their gains; failing lanes bump reg and take the recomputed
    values. One host read per retry trip (the loop condition), counted
    in the `Trace`."""
    trace = trace or Trace()
    g = attempt(reg0)
    reg = reg0
    tries = 0
    while tries < opts.reg_max_retries and trace.read(torch.any(~g.ok)):
        need = ~g.ok
        bumped = torch.where(reg <= 0, torch.full_like(reg, opts.reg_min),
                             reg * opts.reg_scaling)
        reg = torch.where(need, bumped, reg)
        g2 = attempt(reg)
        g = type(g)(*(torch.where(need, new, old) for new, old in zip(g2, g)))
        tries += 1
    return g, reg


def _blend(sel, alphas, phis, xstacks):
    zero = torch.zeros((), dtype=phis.dtype, device=phis.device)
    phi = torch.sum(torch.where(sel, phis, zero), dim=0)
    alpha = torch.sum(torch.where(sel, alphas.to(phis.dtype)[:, None], zero), dim=0)
    xsel = torch.sum(torch.where(sel[:, None, None, :], xstacks, zero), dim=0)
    return alpha, phi, xsel


def select_trial_tiled(passes, alphas, phis, xstacks):
    """Per-lane first passing trial. passes/phis [W, B], alphas [W],
    xstacks [W, N+1, n, B]. Returns (found [B], idx int32, alpha, phi,
    xstack). Selects with where, never 0*x, so a diverged trial's inf
    cannot reach the selected lane."""
    W = passes.shape[0]
    idx = torch.argmax(passes.to(torch.int32), dim=0)  # first True
    found = torch.any(passes, dim=0)
    sel = torch.arange(W, device=passes.device)[:, None] == idx[None]
    alpha, phi, xsel = _blend(sel, alphas, phis, xstacks)
    return found, idx.to(torch.int32), alpha, phi, xsel


def select_best_tiled(alphas, phis, xstacks):
    """Per-lane lowest-merit finite trial (the best-decrease fallback)."""
    W = phis.shape[0]
    phis_f = torch.where(torch.isfinite(phis), phis, torch.full_like(phis, float("inf")))
    idx = torch.argmin(phis_f, dim=0)
    sel = torch.arange(W, device=phis.device)[:, None] == idx[None]
    return _blend(sel, alphas, phis_f, xstacks)
