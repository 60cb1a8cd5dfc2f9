"""Augmented-Lagrangian machinery on knot stacks (PyTorch port).

Counterpart: altro_tpu/al.py (`constraint_values`, `projected_duals`,
`al_cost`, `al_grad`, `al_hess`, `al_hess_exact`, `al_hess_diag`,
`diag_expansion_eligible`, `knot_violation`). The JAX functions work on one knot of one
lane and are lifted by vmap; here each function takes a stack of knots
in the solver's lane-minor layout and computes them all at once:
x [K, n, B], u [K, m, B] (None at the terminal knot), duals z per group
[K, p, B], penalty rho [B], ks the [K] knot indices. A group's mask is
shared ([N+1]) or per lane ([N+1, B], `ConstraintSpec.mask`).

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
    "al_hess_exact",
    "al_hess_diag",
    "diag_expansion_eligible",
    "knot_violation",
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
    return spec.mask(ks)  # [K, 1] shared or [K, B] per lane


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
        act = _active(spec, ks)[:, None]
        gx = torch.einsum("kijb,kib->kjb", Jc[:, :, :n], jvp)
        lx = lx - torch.where(act, gx, torch.zeros_like(gx))
        if not terminal:
            gu = torch.einsum("kijb,kib->kjb", Jc[:, :, n:], jvp)
            lu = lu - torch.where(act, gu, torch.zeros_like(gu))
    return lx, lu


def al_hess(problem: Problem, ks, x, u, z, rho, terminal: bool):
    """Gauss-Newton AL Hessian (lxx [K,n,n,B], luu [K,m,m,B], lux [K,m,n,B])."""
    return _al_hess(problem, ks, x, u, z, rho, terminal, exact=False)


def al_hess_exact(problem: Problem, ks, x, u, z, rho, terminal: bool):
    """Exact (full-Newton) AL Hessian (lxx, luu, lux), the value of JAX's
    autodiff Hessian of `al_cost` (`jax.hessian`; SolverOptions.
    exact_al_hessian): the Gauss-Newton terms plus the constraint-curvature
    term -sum_e w_e nabla^2 c_e, w = dP^T z_proj, that the Gauss-Newton
    form drops. May be indefinite (the Quu regularization retry handles
    it). lux and luu are zero at the terminal knot.

    Written in closed form rather than by autodiff of `al_cost`, so that
    it gives JAX's value where the projection min(ze, 0) ties (ze = 0
    exactly, e.g. zero duals on a row at its bound): JAX's derivative of
    min there is 1/2 (`lax.min`'s balanced tie), torch's clamp gives 1,
    so the row's Gauss-Newton weight rho s^2 is rho / 4 there. The
    curvature of a group not declared affine comes from forward-mode
    Hessians of its function (`torch.func`), vmapped over knots and lanes
    and cast to the input dtype."""
    return _al_hess(problem, ks, x, u, z, rho, terminal, exact=True)


def _curvature(spec, ks, x, u, w):
    """sum_e w_e nabla^2 c_e(x, u) per knot and lane, [K, n+m, n+m, B]:
    the Hessian of w . c in (x, u) with w [K, p, B] held fixed. Forward
    over reverse, all n + m directions in one evaluation (the replica axis
    of `problem.lane_jacobian`): one backward pass of w . c at a dual
    input gives the gradient, whose tangent along e_j is the Hessian's
    column j; jax.hessian's value to roundoff. It traces under `make_fx`
    on fake tensors (graph_solve.py), which torch.func's nested jacfwd
    does not."""
    import torch.autograd.forward_ad as fwad

    K, n, B = x.shape
    R = n + u.shape[1]
    eye = torch.eye(R, dtype=x.dtype, device=x.device)
    # [K, R (component), B, R (direction)], copy j carrying the tangent e_j
    z = torch.cat([x, u], dim=1).detach()[..., None].expand(K, R, B, R).contiguous()
    tangent = eye[None, :, None, :].expand(K, R, B, R).contiguous()
    with torch.enable_grad(), fwad.dual_level():
        leaf = z.requires_grad_(True)
        zd = fwad.make_dual(leaf, tangent)
        c = spec.fn(zd[:, :n].movedim(1, 0), zd[:, n:].movedim(1, 0), ks[:, None, None])
        total = torch.sum(w.movedim(1, 0)[..., None] * c)
        (grad,) = torch.autograd.grad(total, leaf, allow_unused=True)
        H = None if grad is None else fwad.unpack_dual(grad).tangent
    if H is None:  # c is affine in (x, u) (or does not depend on them)
        return x.new_zeros((K, R, R, B))
    return H.to(x.dtype).permute(0, 1, 3, 2)


def _al_hess(problem: Problem, ks, x, u, z, rho, terminal: bool, exact: bool):
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
        if exact and dual is cones.Cone.NEGATIVE_ORTHANT:
            # JAX's derivative of min(ze, 0): 1 below, 1/2 at a tie, 0 above
            s = torch.where(ze < 0, 1.0, torch.where(ze == 0, 0.5, 0.0)).to(ze.dtype)
            Pj = torch.diag_embed(s.movedim(-1, 1)).movedim(1, -1)  # [K, p, p, B]
        else:
            Pj = _proj_jac(dual, ze)
        Jt = torch.einsum("kijb,kjlb->kilb", Pj, Jc)
        Hc = rho * torch.einsum("kijb,kilb->kjlb", Jt, Jt)
        if not cones.cone_is_linear(dual):
            Hp = cones.project_hessian(dual, _cf(ze), _cf(zp)).permute(2, 0, 1, 3)
            HJ = torch.einsum("kijb,kjlb->kilb", Hp, Jc)
            Hc = Hc + rho * torch.einsum("kijb,kilb->kjlb", Jc, HJ)
        if exact and not spec.affine:
            w = torch.einsum("kijb,kib->kjb", Pj, zp)  # dP^T z_proj
            Hc = Hc - _curvature(spec, ks, x, u, w)
        act = _active(spec, ks)[:, None, None]
        zero = torch.zeros_like(Hc)
        Hc = torch.where(act, Hc, zero)
        lxx = lxx + Hc[:, :n, :n]
        if not terminal:
            luu = luu + Hc[:, n:, n:]
            lux = lux + Hc[:, n:, :n]
    return lxx, luu, lux


def diag_expansion_eligible(problem: Problem) -> bool:
    """True when the AL cost Hessian is diagonal at every knot: diagonal
    cost and every constraint group declared `diag_hessian`. Static
    declarations only, so the same for every lane whatever its leaves (a
    per-lane mask only zeroes a diagonal group's terms)."""
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
        lxxd = problem.cost.term_hess_diag(x.shape[0], B)
        luud = torch.zeros_like(u)
    else:
        lxxd, luud = problem.cost.stage_hess_diag(ks, B)
    convals = constraint_values(problem, ks, x, u)
    z_est, _ = projected_duals(problem, convals, z, rho)
    for spec, ze in zip(problem.constraints, z_est):
        Jc = _jac(spec, ks, x, u)
        Pj = _proj_jac(cones.dual_cone(spec.cone), ze)
        Jt = torch.einsum("kijb,kjlb->kilb", Pj, Jc)
        hd = rho * torch.sum(Jt * Jt, dim=1)  # [K, n+m, B]
        hd = torch.where(_active(spec, ks)[:, None], hd, torch.zeros_like(hd))
        lxxd = lxxd + hd[:, :n]
        if not terminal:
            luud = luud + hd[:, n:]
    return lxxd, luud


def knot_violation(problem: Problem, ks, convals):
    """max_j ||P_K(c_j) - c_j||_inf at each knot, [K, B] (0 where no group
    is active); convals per group [K, p, B]."""
    K, B = ks.shape[0], convals[0].shape[-1] if convals else 1
    viol = torch.zeros((K, B), dtype=problem.dtype, device=problem.device)
    for spec, c_j in zip(problem.constraints, convals):
        v = torch.abs(_stack(cones.project(spec.cone, _cf(c_j))) - c_j)
        vmax = torch.amax(v, dim=1) if v.shape[1] else torch.zeros_like(viol)
        viol = torch.maximum(viol, torch.where(_active(spec, ks), vmax, torch.zeros_like(vmax)))
    return viol
