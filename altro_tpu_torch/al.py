"""Augmented-Lagrangian machinery on knot stacks (PyTorch port).

Counterpart: altro_tpu/al.py (`constraint_values`, `projected_duals`,
`al_cost`, `al_grad`, `al_hess`, `al_hess_diag`,
`diag_expansion_eligible`). The JAX functions work on one knot of one
lane and are lifted by vmap; here each function takes a stack of knots
in the solver's lane-minor layout and computes them all at once:
x [K, n, B], u [K, m, B] (None at the terminal knot), duals z per group
[K, p, B], penalty rho [B], ks the [K] knot indices.

    z_est  = z - rho * c(x, u)
    z_proj = P_{K*}(z_est)
    AL cost  += ||z_proj||^2 / (2 rho)
    AL grad  -= J_c^T dP^T z_proj
    AL hess  += rho (dP J_c)^T (dP J_c) (+ curvature term for the SOC)
"""

from __future__ import annotations

from typing import Tuple

import torch

from altro_tpu_torch import cones
from altro_tpu_torch.problem import DiagonalCost, Problem

__all__ = [
    "constraint_values",
    "projected_duals",
    "al_cost",
    "al_grad",
    "al_hess",
    "al_hess_diag",
    "diag_expansion_eligible",
]


def _cf(t):
    """Knot stack [K, c, ...] -> component-first [c, K, ...] (a view)."""
    return t.movedim(1, 0)


def _stack(t):
    """Component-first [c, K, ...] -> knot stack [K, c, ...] (a view)."""
    return t.movedim(0, 1)


def _terminal_u(problem: Problem, x):
    return x.new_zeros((x.shape[0], problem.m, x.shape[-1]))


def _active(spec, ks):
    return spec.active[ks][:, None]  # [K, 1]


def _jac(spec, ks, x, u):
    """Constraint Jacobian as a knot stack [K, p, n+m, B]."""
    J = spec.jacobian(_cf(x), _cf(u), ks[:, None])  # [p, n+m, K, B]
    return J.permute(2, 0, 1, 3)


def _proj_jac(cone, ze):
    """dP(ze) as a knot stack [K, p, p, B]."""
    return cones.project_jacobian(cone, _cf(ze)).permute(2, 0, 1, 3)


def constraint_values(problem: Problem, ks, x, u) -> Tuple[torch.Tensor, ...]:
    """c_j(x, u) for each constraint group, [K, p, B] each."""
    k = ks[:, None]
    return tuple(_stack(spec.fn(_cf(x), _cf(u), k)) for spec in problem.constraints)


def projected_duals(problem: Problem, convals, z, rho):
    """(z_est, z_proj) per group."""
    z_est, z_proj = [], []
    for spec, c_j, z_j in zip(problem.constraints, convals, z):
        ze = z_j - rho * c_j
        z_est.append(ze)
        z_proj.append(_stack(cones.project(cones.dual_cone(spec.cone), _cf(ze))))
    return tuple(z_est), tuple(z_proj)


def al_cost(problem: Problem, ks, x, u, z, rho, terminal: bool):
    """Original cost + sum_j ||z_proj_j||^2 / (2 rho) at each knot.

    Returns (cost [K, B], convals, z_proj)."""
    if terminal:
        cost = problem.cost.term_value(x)
        u = _terminal_u(problem, x)
    else:
        cost = problem.cost.stage_value(ks, x, u)
    convals = constraint_values(problem, ks, x, u)
    _, z_proj = projected_duals(problem, convals, z, rho)
    for spec, zp in zip(problem.constraints, z_proj):
        term = torch.sum(zp * zp, dim=1) / (2.0 * rho)
        cost = cost + torch.where(_active(spec, ks), term, torch.zeros_like(term))
    return cost, convals, z_proj


def al_grad(problem: Problem, ks, x, u, z, rho, terminal: bool):
    """AL cost gradient (lx [K, n, B], lu [K, m, B]); lu is zero at the
    terminal knot."""
    n = problem.n
    if terminal:
        u = _terminal_u(problem, x)
        lx = problem.cost.term_grad(x)
        lu = torch.zeros_like(u)
    else:
        lx, lu = problem.cost.stage_grad(ks, x, u)
    convals = constraint_values(problem, ks, x, u)
    z_est, z_proj = projected_duals(problem, convals, z, rho)
    for spec, ze, zp in zip(problem.constraints, z_est, z_proj):
        Jc = _jac(spec, ks, x, u)
        Pj = _proj_jac(cones.dual_cone(spec.cone), ze)
        jvp = torch.einsum("kijb,kib->kjb", Pj, zp)
        act = _active(spec, ks)[:, :, None]
        gx = torch.einsum("kijb,kib->kjb", Jc[:, :, :n], jvp)
        lx = lx - torch.where(act, gx, torch.zeros_like(gx))
        if not terminal:
            gu = torch.einsum("kijb,kib->kjb", Jc[:, :, n:], jvp)
            lu = lu - torch.where(act, gu, torch.zeros_like(gu))
    return lx, lu


def al_hess(problem: Problem, ks, x, u, z, rho, terminal: bool):
    """Gauss-Newton AL Hessian (lxx [K,n,n,B], luu [K,m,m,B], lux [K,m,n,B])."""
    n, m = problem.n, problem.m
    if terminal:
        u = _terminal_u(problem, x)
        lxx = problem.cost.term_hess(x)
        luu = x.new_zeros((x.shape[0], m, m, x.shape[-1]))
        lux = x.new_zeros((x.shape[0], m, n, x.shape[-1]))
    else:
        lxx, luu, lux = problem.cost.stage_hess(ks, x, u)
    convals = constraint_values(problem, ks, x, u)
    z_est, z_proj = projected_duals(problem, convals, z, rho)
    for spec, ze, zp in zip(problem.constraints, z_est, z_proj):
        dual = cones.dual_cone(spec.cone)
        Jc = _jac(spec, ks, x, u)
        Pj = _proj_jac(dual, ze)
        Jt = torch.einsum("kijb,kjlb->kilb", Pj, Jc)
        Hc = rho * torch.einsum("kijb,kilb->kjlb", Jt, Jt)
        if not cones.cone_is_linear(dual):
            Hp = cones.project_hessian(dual, _cf(ze), _cf(zp)).permute(2, 0, 1, 3)
            HJ = torch.einsum("kijb,kjlb->kilb", Hp, Jc)
            Hc = Hc + rho * torch.einsum("kijb,kilb->kjlb", Jc, HJ)
        act = _active(spec, ks)[:, :, None, None]
        zero = torch.zeros_like(Hc)
        Hc = torch.where(act, Hc, zero)
        lxx = lxx + Hc[:, :n, :n]
        if not terminal:
            luu = luu + Hc[:, n:, n:]
            lux = lux + Hc[:, n:, :n]
    return lxx, luu, lux


def diag_expansion_eligible(problem: Problem) -> bool:
    """True when the AL cost Hessian is diagonal at every knot: diagonal
    cost and every constraint group declared `diag_hessian`."""
    return isinstance(problem.cost, DiagonalCost) and all(
        spec.diag_hessian for spec in problem.constraints
    )


def al_hess_diag(problem: Problem, ks, x, u, z, rho, terminal: bool):
    """Diagonal Gauss-Newton AL Hessian (lxx_diag [K, n, B], luu_diag
    [K, m, B]); valid only when `diag_expansion_eligible(problem)`."""
    n = problem.n
    B = x.shape[-1]
    if terminal:
        u = _terminal_u(problem, x)
        lxxd = problem.cost.Q[-1][None, :, None].expand(x.shape[0], -1, B)
        luud = torch.zeros_like(u)
    else:
        lxxd = problem.cost.Q[ks][..., None].expand(-1, -1, B)
        luud = problem.cost.R[ks][..., None].expand(-1, -1, B)
    convals = constraint_values(problem, ks, x, u)
    z_est, _ = projected_duals(problem, convals, z, rho)
    for spec, ze in zip(problem.constraints, z_est):
        Jc = _jac(spec, ks, x, u)
        Pj = _proj_jac(cones.dual_cone(spec.cone), ze)
        Jt = torch.einsum("kijb,kjlb->kilb", Pj, Jc)
        hd = rho * torch.sum(Jt * Jt, dim=1)  # [K, n+m, B]
        hd = torch.where(_active(spec, ks)[:, :, None], hd, torch.zeros_like(hd))
        lxxd = lxxd + hd[:, :n]
        if not terminal:
            luud = luud + hd[:, n:]
    return lxxd, luud
