"""Implicit dynamics (PyTorch port).

Counterpart: altro_tpu/implicit.py (`implicit_dynamics`,
`implicit_midpoint_residual`). A residual r(x1, u, x2, h) = 0 defines the
step implicitly; the explicit step is a fixed number of Newton
iterations from x2 = x1, and the dynamics Jacobian comes from the
implicit function theorem,

    A = -(dr/dx2)^-1 dr/dx1,   B = -(dr/dx2)^-1 dr/du,

rather than from differentiating through the iterations. The returned
callables are component-first (`x [n, *batch]`), as every user callable
of the port.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["implicit_dynamics", "implicit_midpoint_residual"]


def implicit_dynamics(residual: Callable, newton_iters: int = 8):
    """(step(x, u, h, k) -> x_next, jac(x, u, h, k) -> [n, n+m, *batch])
    from residual(x1, u, x2, h) -> [n], zero at the implicit step, for the
    Problem dynamics interface. The residual is evaluated one lane at a
    time, its Jacobians by `torch.func.jacfwd`, vmapped over the lanes."""
    from torch.func import jacfwd, vmap

    def lanes(x, u, h):
        """x [n, *batch], u [m, *batch], h -> per-lane rows [L, n], [L, m],
        [L] and the batch shape."""
        batch = torch.broadcast_shapes(x.shape[1:], u.shape[1:])
        xl = x.expand((x.shape[0],) + batch).reshape(x.shape[0], -1).T
        ul = u.expand((u.shape[0],) + batch).reshape(u.shape[0], -1).T
        hl = torch.as_tensor(h, dtype=x.dtype, device=x.device).expand(batch).reshape(-1)
        return xl, ul, hl, batch

    def newton(xl, ul, hl):
        x2 = xl
        for _ in range(newton_iters):
            r = vmap(residual)(xl, ul, x2, hl)
            J = vmap(jacfwd(residual, argnums=2))(xl, ul, x2, hl).to(xl.dtype)
            x2 = x2 - torch.linalg.solve(J, r[..., None])[..., 0]
        return x2

    def step(x, u, h, k):
        xl, ul, hl, batch = lanes(x, u, h)
        return newton(xl, ul, hl).T.reshape((x.shape[0],) + batch)

    def jac(x, u, h, k):
        xl, ul, hl, batch = lanes(x, u, h)
        x2 = newton(xl, ul, hl)
        Jx2 = vmap(jacfwd(residual, argnums=2))(xl, ul, x2, hl)
        Jx1 = vmap(jacfwd(residual, argnums=0))(xl, ul, x2, hl)
        Ju = vmap(jacfwd(residual, argnums=1))(xl, ul, x2, hl)
        AB = -torch.linalg.solve(Jx2, torch.cat([Jx1, Ju], dim=2)).to(x.dtype)  # [L, n, n+m]
        return AB.permute(1, 2, 0).reshape(AB.shape[1:] + batch)

    return step, jac


def implicit_midpoint_residual(f: Callable) -> Callable:
    """Residual of the (symplectic) implicit midpoint rule:
    x2 = x1 + h f((x1 + x2) / 2, u)."""

    def residual(x1, u, x2, h):
        return x2 - x1 - h * f(0.5 * (x1 + x2), u)

    return residual
