"""Problem definition: costs, constraints, dynamics (PyTorch port).

Counterpart: altro_tpu/problem.py (`Problem`, `DiagonalCost`,
`ConstraintSpec`, `lqr_cost_from_reference`, `Problem.dyn_step`,
`Problem.dyn_expansion`). The slice ports the diagonal cost and
nonlinear dynamics; QuadraticCost, GenericCost and linear dynamics
arrays are still to be ported.

Conventions of the port:

* User callables (dynamics, constraint functions) take component-first
  tensors with any trailing batch dims: `x [n, *batch]`, `u [m, *batch]`.
  The knot index `k` is an int or an integer tensor that broadcasts
  against the batch dims. One lane is the case `batch = ()`.
* Cost methods take knot stacks in the solver's lane-minor layout,
  `x [K, n, B]`, `u [K, m, B]`, with `ks` the `[K]` knot indices; cost
  data are shared by all lanes (`Q [N+1, n]` etc.).
* Jacobians of user callables come from forward-mode automatic
  differentiation over the batch (`lane_jacobian`), the counterpart of
  `jax.jacfwd`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from altro_tpu_torch.cones import Cone

__all__ = [
    "DiagonalCost",
    "ConstraintSpec",
    "Problem",
    "lqr_cost_from_reference",
    "lane_jacobian",
]


def lane_jacobian(fn, x, u, *extra):
    """Per-lane Jacobians of `fn(x, u, *extra) -> [p]` on batched inputs.

    x: [n, *batch], u: [m, *batch]; each extra argument is a Python
    scalar or a tensor that broadcasts against the batch dims. Returns
    (Jx [p, n, *batch], Ju [p, m, *batch]).

    Forward mode, all n + m directions in one evaluation: the inputs gain
    a trailing replica axis of n + m copies, copy j carrying the tangent
    e_j, so fn runs once on dual tensors (it broadcasts over trailing
    dims by the port's convention) and the output tangent of copy j is
    the Jacobian's column j. The same products as `jax.jacfwd`, without
    a vmap per call.
    """
    import torch.autograd.forward_ad as fwad

    n, m = x.shape[0], u.shape[0]
    tensors = [e for e in extra if torch.is_tensor(e)]
    batch = torch.broadcast_shapes(x.shape[1:], u.shape[1:],
                                   *(e.shape for e in tensors))
    R = n + m
    eye = torch.eye(R, dtype=x.dtype, device=x.device)
    shape_t = (R,) + (1,) * len(batch) + (R,)
    # dual tensors need their own memory: materialize the broadcasts
    tx = eye[:n].reshape((n,) + shape_t[1:]).expand((n,) + batch + (R,)).contiguous()
    tu = eye[n:].reshape((m,) + shape_t[1:]).expand((m,) + batch + (R,)).contiguous()
    xr = x.expand((n,) + batch)[..., None].expand((n,) + batch + (R,)).contiguous()
    ur = u.expand((m,) + batch)[..., None].expand((m,) + batch + (R,)).contiguous()
    ext = [e[..., None] if torch.is_tensor(e) and e.ndim else e for e in extra]
    with fwad.dual_level():
        out = fn(fwad.make_dual(xr, tx), fwad.make_dual(ur, tu), *ext)
        tangent = fwad.unpack_dual(out).tangent
    if tangent is None:  # fn does not depend on (x, u)
        tangent = torch.zeros(out.shape, dtype=x.dtype, device=x.device)
    J = tangent.to(x.dtype).movedim(-1, 1)  # [p, n+m, *batch]
    return J[:, :n], J[:, n:]


def _rows(arr, ks):
    """Per-knot rows [K, w] of a shared [N+1, w] stack as [K, w, 1]."""
    return arr[ks][..., None]


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiagonalCost:
    """0.5 x'diag(Q)x + q'x + 0.5 u'diag(R)u + r'u + c, stacked over knots.

    Q, q: [N+1, n];  R, r: [N+1, m] (row N unused);  c: [N+1].
    """

    Q: torch.Tensor
    R: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor

    def stage_value(self, ks, x, u):
        """[K, B] stage costs at knots ks (x [K, n, B], u [K, m, B])."""
        Q, q, R, r = (_rows(a, ks) for a in (self.Q, self.q, self.R, self.r))
        return (
            0.5 * torch.sum(x * (Q * x), dim=1)
            + torch.sum(q * x, dim=1)
            + 0.5 * torch.sum(u * (R * u), dim=1)
            + torch.sum(r * u, dim=1)
            + self.c[ks][:, None]
        )

    def term_value(self, x):
        """[K, B] terminal cost of x [K, n, B]."""
        Q, q = self.Q[-1][:, None], self.q[-1][:, None]
        return 0.5 * torch.sum(x * (Q * x), dim=1) + torch.sum(q * x, dim=1) + self.c[-1]

    def stage_grad(self, ks, x, u):
        return (_rows(self.Q, ks) * x + _rows(self.q, ks),
                _rows(self.R, ks) * u + _rows(self.r, ks))

    def term_grad(self, x):
        return self.Q[-1][:, None] * x + self.q[-1][:, None]

    def stage_hess(self, ks, x, u):
        """Dense (lxx [K, n, n, B], luu [K, m, m, B], lux [K, m, n, B])."""
        B = x.shape[-1]
        lxx = torch.diag_embed(self.Q[ks])[..., None].expand(-1, -1, -1, B)
        luu = torch.diag_embed(self.R[ks])[..., None].expand(-1, -1, -1, B)
        lux = x.new_zeros((x.shape[0], u.shape[1], x.shape[1], B))
        return lxx, luu, lux

    def term_hess(self, x):
        return torch.diag(self.Q[-1])[None, :, :, None].expand(
            x.shape[0], -1, -1, x.shape[-1])


def lqr_cost_from_reference(Q_diag, R_diag, x_ref, u_ref, terminal_index=None) -> DiagonalCost:
    """Diagonal tracking cost 0.5|x-xref|^2_Q + 0.5|u-uref|^2_R expanded to
    (q, r, c); the terminal knot's constant has no input term.

    Args (stacked over knots): Q_diag [N+1, n], R_diag [N+1, m],
    x_ref [N+1, n], u_ref [N+1, m], all tensors on one device and dtype.
    """
    q = -Q_diag * x_ref
    r = -R_diag * u_ref
    c = 0.5 * torch.sum(Q_diag * x_ref * x_ref, dim=1)
    cu = 0.5 * torch.sum(R_diag * u_ref * u_ref, dim=1)
    Nt = Q_diag.shape[0] - 1 if terminal_index is None else terminal_index
    not_term = torch.arange(Q_diag.shape[0], device=Q_diag.device) != Nt
    c = c + cu * not_term.to(cu.dtype)
    return DiagonalCost(Q=Q_diag, R=R_diag, q=q, r=r, c=c)


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """One constraint group: fixed cone/dim, active over a knot mask.

    fn(x, u, k) -> [dim, *batch]; at the terminal knot fn receives
    u = zeros(m). `jac(x, u, k) -> [dim, n + m, *batch]` is optional and
    defaults to `lane_jacobian`. `diag_hessian` and `affine` are the same
    declarations as in the JAX package.
    """

    fn: Callable[..., torch.Tensor]
    cone: Cone
    dim: int
    active: torch.Tensor  # [N+1] bool
    jac: Optional[Callable[..., torch.Tensor]] = None
    label: str = ""
    diag_hessian: bool = False
    affine: bool = False

    def jacobian(self, x, u, k):
        if self.jac is not None:
            return self.jac(x, u, k)
        Jx, Ju = lane_jacobian(self.fn, x, u, k)
        return torch.cat([Jx, Ju], dim=1)


# ---------------------------------------------------------------------------
# Problem
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Problem:
    """min sum_k l_k(x_k, u_k) + l_N(x_N) s.t. x_{k+1} = f(x_k, u_k, h_k),
    x_0 = x0, c_j(x_k, u_k) in K_j on active knots.

    dynamics(x, u, h, k) -> x_next (component-first); dynamics_jac(x, u,
    h, k) -> [n, n+m, *batch] optional. x0: [n] for one lane, or [n, B]
    lane-minor for the batched solve. dynamics_cols: the column-form step
    (models/tile_steps.py) that the rollout kernel runs on the card.
    """

    N: int
    n: int
    m: int
    dynamics: Callable[..., torch.Tensor]
    dynamics_jac: Optional[Callable[..., torch.Tensor]]
    constraints: Tuple[ConstraintSpec, ...]
    cost: DiagonalCost
    h: torch.Tensor  # [N]
    x0: torch.Tensor
    dynamics_cols: Optional[Callable[..., tuple]] = None

    @property
    def dtype(self):
        return self.x0.dtype

    @property
    def device(self):
        return self.x0.device

    def dyn_step(self, k, x, u):
        """x_{k+1} = f(x_k, u_k) on component-first tensors."""
        return self.dynamics(x, u, self.h[k], k)

    def dyn_expansion(self, k, x, u):
        """(A [n, n, *batch], B [n, m, *batch]) of the dynamics at (x, u)."""
        if self.dynamics_jac is not None:
            J = self.dynamics_jac(x, u, self.h[k], k)
            return J[:, : self.n], J[:, self.n:]
        return lane_jacobian(self.dynamics, x, u, self.h[k], k)

    def init_duals(self) -> Tuple[torch.Tensor, ...]:
        """Zero dual variables, one [N+1, dim] tensor per constraint group."""
        return tuple(
            torch.zeros((self.N + 1, spec.dim), dtype=self.dtype, device=self.device)
            for spec in self.constraints
        )
