"""Conic projections, Jacobians, and Hessian-vector Jacobians (PyTorch port).

Counterpart: altro_tpu/cones.py (`Cone`, `dual_cone`, `cone_is_linear`,
`project`, `project_jacobian`, `project_hessian`). Every projection is
branchless (`torch.where`), as in the JAX module.

Layout: the cone's components lead. `x` is `[p, *batch]`: a plain `[p]`
vector for one lane, or `[p, K, B]` for a stack of knots and lanes.
Jacobians and Hessians are `[p, p, *batch]`.
"""

from __future__ import annotations

import enum

import torch

__all__ = [
    "Cone",
    "dual_cone",
    "cone_is_linear",
    "project",
    "project_jacobian",
    "project_hessian",
]


class Cone(enum.Enum):
    """Constraint cone tag (Python-level, static)."""

    ZERO = "zero"  # equality constraints: c(x,u) = 0
    IDENTITY = "identity"  # free
    NEGATIVE_ORTHANT = "negative_orthant"  # inequality constraints: c(x,u) <= 0
    SECOND_ORDER = "second_order"  # ||c[:-1]|| <= c[-1]

    EQUALITY = "zero"
    INEQUALITY = "negative_orthant"


def dual_cone(cone: Cone) -> Cone:
    """Cone the estimated duals are projected into."""
    return {
        Cone.ZERO: Cone.IDENTITY,
        Cone.IDENTITY: Cone.ZERO,
        Cone.NEGATIVE_ORTHANT: Cone.NEGATIVE_ORTHANT,
        Cone.SECOND_ORDER: Cone.SECOND_ORDER,
    }[cone]


def cone_is_linear(cone: Cone) -> bool:
    """True when the projection is piecewise linear (Hessian term vanishes)."""
    return cone is not Cone.SECOND_ORDER


def _eye_like(p: int, x: torch.Tensor) -> torch.Tensor:
    """Identity [p, p, 1, ...] broadcastable against x's batch dims."""
    eye = torch.eye(p, dtype=x.dtype, device=x.device)
    return eye.reshape((p, p) + (1,) * (x.ndim - 1))


def _soc_split(x: torch.Tensor):
    v = x[:-1]
    s = x[-1]
    a = torch.sqrt(torch.sum(v * v, dim=0))
    # a == 0: the point is in the cone (s >= 0) or below it (s < 0), so
    # the outside branch is masked out and the placeholder never leaks
    a_safe = torch.where(a > 0.0, a, torch.ones_like(a))
    below = a <= -s
    inside = torch.logical_and(torch.logical_not(below), a <= s)
    outside = torch.logical_not(torch.logical_or(below, inside))
    return v, s, a, a_safe, below, inside, outside


def _soc_project(x: torch.Tensor) -> torch.Tensor:
    v, s, a, a_safe, below, inside, outside = _soc_split(x)
    c = 0.5 * (1.0 + s / a_safe)
    px_out = torch.cat([c * v, (c * a)[None]], dim=0)
    return torch.where(below, torch.zeros_like(x), torch.where(inside, x, px_out))


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[:, None] * b[None, :]


def _soc_project_jacobian(x: torch.Tensor) -> torch.Tensor:
    p = x.shape[0]
    v, s, a, a_safe, below, inside, outside = _soc_split(x)
    c = 0.5 * (1.0 + s / a_safe)
    eye_v = _eye_like(p - 1, x)

    dv_dv = c * eye_v - (0.5 * s / a_safe**3) * _outer(v, v)
    dv_ds = 0.5 * v / a_safe
    ds_dv = (-0.5 * s / a_safe**2 + c / a_safe) * v
    ds_ds = torch.full_like(s, 0.5)

    top = torch.cat([dv_dv, dv_ds[:, None]], dim=1)
    bot = torch.cat([ds_dv, ds_ds[None]], dim=0)[None, :]
    jac_out = torch.cat([top, bot], dim=0)

    eye = _eye_like(p, x).expand_as(jac_out)
    return torch.where(below, torch.zeros_like(jac_out), torch.where(inside, eye, jac_out))


def _soc_project_hessian(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Jacobian of x -> dP(x)^T b for the SOC (zero when in/below the cone)."""
    p = x.shape[0]
    v, s, a, a_safe, below, inside, outside = _soc_split(x)
    b_v = b[:-1]
    b_s = b[-1]
    vbv = torch.sum(v * b_v, dim=0)

    h = b_v - v * (vbv / a_safe**2)
    eye_v = _eye_like(p - 1, x)
    vvT = _outer(v, v)

    block = (
        (-s / a_safe**3) * (_outer(h, v) + _outer(v, h))
        + (s * vbv / a_safe**5) * vvT
        - (s * vbv / a_safe**3) * eye_v
        + (b_s / a_safe) * (eye_v - vvT / a_safe**2)
    ) * 0.5
    border = h / (2.0 * a_safe)

    top = torch.cat([block, border[:, None]], dim=1)
    bot = torch.cat([border, torch.zeros_like(border[:1])], dim=0)[None, :]
    hess_out = torch.cat([top, bot], dim=0)
    return torch.where(outside, hess_out, torch.zeros_like(hess_out))


def project(cone: Cone, x: torch.Tensor) -> torch.Tensor:
    """Projection P_K(x) onto the cone. x: [p, *batch]."""
    if cone is Cone.ZERO:
        return torch.zeros_like(x)
    if cone is Cone.IDENTITY:
        return x
    if cone is Cone.NEGATIVE_ORTHANT:
        return torch.clamp(x, max=0.0)
    if cone is Cone.SECOND_ORDER:
        return _soc_project(x)
    raise ValueError(f"unknown cone {cone}")


def project_jacobian(cone: Cone, x: torch.Tensor) -> torch.Tensor:
    """Jacobian dP_K(x): [p, p, *batch]."""
    p = x.shape[0]
    if cone is Cone.ZERO:
        return torch.zeros((p, p) + x.shape[1:], dtype=x.dtype, device=x.device)
    if cone is Cone.IDENTITY:
        return _eye_like(p, x).expand((p, p) + x.shape[1:]).clone()
    if cone is Cone.NEGATIVE_ORTHANT:
        diag = (x <= 0.0).to(x.dtype)
        return _eye_like(p, x) * diag[None]
    if cone is Cone.SECOND_ORDER:
        return _soc_project_jacobian(x)
    raise ValueError(f"unknown cone {cone}")


def project_hessian(cone: Cone, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Jacobian of x -> dP_K(x)^T b: [p, p, *batch]. Zero for all linear cones."""
    p = x.shape[0]
    if cone in (Cone.ZERO, Cone.IDENTITY, Cone.NEGATIVE_ORTHANT):
        return torch.zeros((p, p) + x.shape[1:], dtype=x.dtype, device=x.device)
    if cone is Cone.SECOND_ORDER:
        return _soc_project_hessian(x, b)
    raise ValueError(f"unknown cone {cone}")
