"""Problem definition: costs, constraints, dynamics (PyTorch port).

Counterpart: altro_tpu/problem.py (`Problem`, `Cost`, `DiagonalCost`,
`ConstraintSpec`, `lqr_cost_from_reference`, `Problem.dyn_step`,
`Problem.dyn_expansion`, `Problem.linear_dynamics`, and the pytree
registration, whose data leaves are `problem_leaves` /
`problem_with_leaves` here): the diagonal, quadratic and generic costs,
nonlinear dynamics and linear dynamics arrays (A, B, f_aff).

Conventions of the port:

* User callables (dynamics, constraint functions) take component-first
  tensors with any trailing batch dims: `x [n, *batch]`, `u [m, *batch]`.
  The knot index `k` is an int or an integer tensor that broadcasts
  against the batch dims. One lane is the case `batch = ()`.
* Cost methods take knot stacks in the solver's lane-minor layout,
  `x [K, n, B]`, `u [K, m, B]`, with `ks` the `[K]` knot indices. Each
  leaf of a cost is shared by all lanes (`Q [N+1, n]`, `c [N+1]`) or
  holds one row per lane on a trailing lane axis (`Q [N+1, n, B]`,
  `c [N+1, B]`), leaf by leaf, as JAX's `prob_axes` and `jax.vmap` batch
  any leaf; so do `Problem.h` (`[N]` or `[N, B]`), the linear dynamics
  arrays (`A [N, n, n, B]`, `B [N, n, m, B]`, `f_aff [N, n, B]`) and each
  `ConstraintSpec.active` (`[N+1]` or `[N+1, B]`): a leaf's one-lane
  dims plus one (`LEAF_DIMS`).
* Jacobians of user callables come from forward-mode automatic
  differentiation over the batch (`lane_jacobian`), the counterpart of
  `jax.jacfwd`; GenericCost's gradients and Hessians from `torch.func`'s
  forward mode, vmapped over the knots and lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from altro_tpu_torch.cones import Cone

__all__ = [
    "Cost",
    "DiagonalCost",
    "QuadraticCost",
    "GenericCost",
    "ConstraintSpec",
    "Problem",
    "lqr_cost_from_reference",
    "lane_jacobian",
    "problem_leaves",
    "problem_with_leaves",
    "LEAF_DIMS",
]

# The dims of each leaf on one lane; a leaf with one more holds one row per
# lane on its trailing axis.
LEAF_DIMS = {"DiagonalCost": {"Q": 2, "q": 2, "R": 2, "r": 2, "c": 1},
             "QuadraticCost": {"Q": 3, "R": 3, "H": 3, "q": 2, "r": 2, "c": 1},
             "Problem": {"h": 1, "A": 3, "B": 3, "f_aff": 2},
             "ConstraintSpec": {"active": 1}}


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
    """Per-knot rows of a stack at knots ks: a shared [N+1, w] stack as
    [K, w, 1], a per-lane [N+1, w, B] one as [K, w, B]."""
    return arr[ks] if arr.ndim == 3 else arr[ks][..., None]


def _last(arr):
    """The terminal row of a stack, [w, 1] shared or [w, B] per lane."""
    return arr[-1] if arr.ndim == 3 else arr[-1][:, None]


def _consts(c, ks):
    """Per-knot constants at knots ks: [K, 1] shared ([N+1]) or [K, B]
    per lane ([N+1, B])."""
    return c[ks] if c.ndim == 2 else c[ks][:, None]


def _diag_rows(rows, B):
    """Diagonal rows [K, w, 1 or B] as lane stacks of matrices [K, w, w, B]."""
    return torch.diag_embed(rows.movedim(-1, 1)).movedim(1, -1).expand(-1, -1, -1, B)


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------


def _lane_leaves(obj) -> Tuple[str, ...]:
    """The names of obj's leaves that hold one row per lane (`LEAF_DIMS`)."""
    dims = LEAF_DIMS.get(type(obj).__name__, {})
    return tuple(name for name, base in dims.items()
                 if getattr(obj, name) is not None and getattr(obj, name).ndim == base + 1)


class Cost:
    """Cost interface over knot stacks (lane-minor, see the module
    docstring): stage knots (k < N) have state and input terms, the
    terminal knot is state-only. A dataclass cost's floating-point tensor
    fields are its data leaves (`problem_leaves`)."""

    @property
    def lane_leaves(self) -> Tuple[str, ...]:
        """The names of the leaves that hold one row per lane."""
        return _lane_leaves(self)

    @property
    def per_lane(self) -> bool:
        """True when any leaf holds one row per lane."""
        return bool(self.lane_leaves)

    def stage_value(self, ks, x, u):
        raise NotImplementedError

    def term_value(self, x):
        raise NotImplementedError

    def stage_grad(self, ks, x, u):
        raise NotImplementedError

    def term_grad(self, x):
        raise NotImplementedError

    def stage_hess(self, ks, x, u):
        raise NotImplementedError

    def term_hess(self, x):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DiagonalCost(Cost):
    """0.5 x'diag(Q)x + q'x + 0.5 u'diag(R)u + r'u + c, stacked over knots.

    Q, q: [N+1, n];  R, r: [N+1, m] (row N unused);  c: [N+1]. On
    lane-minor data any leaf may carry a trailing lane axis, one row per
    lane (Q, q [N+1, n, B], R, r [N+1, m, B], c [N+1, B]), as JAX's
    `prob_axes` batches any leaf (altro_tpu/tile_solver.py:118-123,
    altro_tpu/parallel/batch.py:45-64); a leaf without it stays shared.
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
            + _consts(self.c, ks)
        )

    def term_value(self, x):
        """[K, B] terminal cost of x [K, n, B]."""
        Q, q = _last(self.Q), _last(self.q)
        return 0.5 * torch.sum(x * (Q * x), dim=1) + torch.sum(q * x, dim=1) + self.c[-1]

    def stage_grad(self, ks, x, u):
        return (_rows(self.Q, ks) * x + _rows(self.q, ks),
                _rows(self.R, ks) * u + _rows(self.r, ks))

    def term_grad(self, x):
        return _last(self.Q) * x + _last(self.q)

    def stage_hess(self, ks, x, u):
        """Dense (lxx [K, n, n, B], luu [K, m, m, B], lux [K, m, n, B])."""
        B = x.shape[-1]
        lxx = _diag_rows(_rows(self.Q, ks), B)
        luu = _diag_rows(_rows(self.R, ks), B)
        lux = x.new_zeros((x.shape[0], u.shape[1], x.shape[1], B))
        return lxx, luu, lux

    def stage_hess_diag(self, ks, B):
        """The Hessian diagonals (lxx [K, n, B], luu [K, m, B])."""
        return (_rows(self.Q, ks).expand(-1, -1, B), _rows(self.R, ks).expand(-1, -1, B))

    def term_hess_diag(self, K, B):
        """The terminal Hessian diagonal [K, n, B]."""
        return _last(self.Q)[None].expand(K, -1, B)

    def term_hess(self, x):
        return _diag_rows(_last(self.Q)[None], x.shape[-1]).expand(x.shape[0], -1, -1, -1)


def _mv(M, v):
    """Per-knot matrices times lane vectors: M [K, a, b] shared or
    [K, a, b, B] per lane, v [K, b, B] -> [K, a, B]."""
    if M.ndim == 4:
        return torch.einsum("kijb,kjb->kib", M, v)
    return torch.einsum("kij,kjb->kib", M, v)


def _lanes_of(M, B):
    """Knot-stacked matrices [K, a, b] shared by B lanes, as [K, a, b, B]
    (a per-lane stack [K, a, b, B] as it is)."""
    return M if M.ndim == 4 else M[..., None].expand(*M.shape, B)


def _last_mats(M, K):
    """The terminal matrix of a stack, repeated for K knots: [K, a, b]
    shared or [K, a, b, B] per lane."""
    return M[-1][None].expand((K,) + M.shape[1:])


@dataclasses.dataclass(frozen=True)
class QuadraticCost(Cost):
    """0.5 x'Qx + q'x + 0.5 u'Ru + r'u + u'Hx + c, stacked over knots.

    Q: [N+1, n, n];  R: [N+1, m, m];  H: [N+1, m, n];  q, r, c as in
    DiagonalCost. On lane-minor data any leaf may carry a trailing lane
    axis, one row per lane (Q [N+1, n, n, B], R [N+1, m, m, B],
    H [N+1, m, n, B], q [N+1, n, B], r [N+1, m, B], c [N+1, B]); a leaf
    without it stays shared. Its Hessians are dense, so the solve takes
    the dense expansions with lux (al.diag_expansion_eligible is False).
    """

    Q: torch.Tensor
    R: torch.Tensor
    H: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor


    def stage_value(self, ks, x, u):
        Q, R, H = self.Q[ks], self.R[ks], self.H[ks]
        return (
            0.5 * torch.sum(x * _mv(Q, x), dim=1)
            + torch.sum(_rows(self.q, ks) * x, dim=1)
            + 0.5 * torch.sum(u * _mv(R, u), dim=1)
            + torch.sum(_rows(self.r, ks) * u, dim=1)
            + torch.sum(u * _mv(H, x), dim=1)
            + _consts(self.c, ks)
        )

    def term_value(self, x):
        Q = _last_mats(self.Q, x.shape[0])
        return (0.5 * torch.sum(x * _mv(Q, x), dim=1) + torch.sum(_last(self.q) * x, dim=1)
                + self.c[-1])

    def stage_grad(self, ks, x, u):
        Q, R, H = self.Q[ks], self.R[ks], self.H[ks]
        lx = _mv(Q, x) + _rows(self.q, ks) + _mv(H.transpose(1, 2), u)
        lu = _mv(R, u) + _rows(self.r, ks) + _mv(H, x)
        return lx, lu

    def term_grad(self, x):
        return _mv(_last_mats(self.Q, x.shape[0]), x) + _last(self.q)

    def stage_hess(self, ks, x, u):
        B = x.shape[-1]
        return (_lanes_of(self.Q[ks], B), _lanes_of(self.R[ks], B),
                _lanes_of(self.H[ks], B))

    def term_hess(self, x):
        return _lanes_of(_last_mats(self.Q, x.shape[0]), x.shape[-1])


@dataclasses.dataclass(frozen=True)
class GenericCost(Cost):
    """User cost callables: `stage(x, u, k)` and `term(x)`, each on
    component-first tensors with trailing batch dims (`x [n, *batch]`,
    `u [m, *batch]`, k an int or an integer tensor broadcasting against
    them), returning one value per batch entry, `[*batch]`.

    Values evaluate the callables on whole knot stacks at once. Gradients
    and Hessians are forward-mode derivatives of the callable on one lane
    (`torch.func.jacfwd`), vmapped over every knot and lane; lux is the
    Jacobian in x of the u-gradient, as in JAX. Results are cast to the
    input dtype (forward mode through `torch.stack` can return float64
    for float32 inputs).
    """

    stage: Callable[..., torch.Tensor]
    term: Callable[..., torch.Tensor]


    def stage_value(self, ks, x, u):
        out = self.stage(x.movedim(1, 0), u.movedim(1, 0), ks[:, None])
        return out.to(x.dtype).expand(x.shape[0], x.shape[-1])

    def term_value(self, x):
        return self.term(x.movedim(1, 0)).to(x.dtype).expand(x.shape[0], x.shape[-1])

    def _stage_derivs(self, ks, x, u, order):
        """Per (knot, lane): the gradient of stage in (x, u) (order 1) or its
        Hessian (order 2), [K, B, n+m(, n+m)]."""
        from torch.func import jacfwd, vmap

        K, n, B = x.shape
        m = u.shape[1]
        z = torch.cat([x, u], dim=1).permute(0, 2, 1).reshape(K * B, n + m)
        kk = ks[:, None].expand(K, B).reshape(K * B)

        def f(zl, kl):
            return self.stage(zl[:n], zl[n:], kl)

        d = jacfwd(f) if order == 1 else jacfwd(jacfwd(f))
        out = vmap(d)(z, kk).to(x.dtype)
        return out.reshape((K, B) + out.shape[1:])

    def _term_derivs(self, x, order):
        from torch.func import jacfwd, vmap

        K, n, B = x.shape
        xl = x.permute(0, 2, 1).reshape(K * B, n)
        d = jacfwd(self.term) if order == 1 else jacfwd(jacfwd(self.term))
        out = vmap(d)(xl).to(x.dtype)
        return out.reshape((K, B) + out.shape[1:])

    def stage_grad(self, ks, x, u):
        n = x.shape[1]
        g = self._stage_derivs(ks, x, u, 1).permute(0, 2, 1)  # [K, n+m, B]
        return g[:, :n], g[:, n:]

    def term_grad(self, x):
        return self._term_derivs(x, 1).permute(0, 2, 1)

    def stage_hess(self, ks, x, u):
        n = x.shape[1]
        Hm = self._stage_derivs(ks, x, u, 2).permute(0, 2, 3, 1)  # [K, n+m, n+m, B]
        return Hm[:, :n, :n], Hm[:, n:, n:], Hm[:, n:, :n]

    def term_hess(self, x):
        return self._term_derivs(x, 2).permute(0, 2, 3, 1)


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
    declarations as in the JAX package. `active` is the knot mask, [N+1]
    shared by all lanes or [N+1, B] one column per lane (lane-minor data).
    """

    fn: Callable[..., torch.Tensor]
    cone: Cone
    dim: int
    active: torch.Tensor  # [N+1] bool, or [N+1, B] per lane
    jac: Optional[Callable[..., torch.Tensor]] = None
    label: str = ""
    diag_hessian: bool = False
    affine: bool = False

    @property
    def per_lane(self) -> bool:
        """True when the mask holds one column per lane."""
        return self.active.ndim == 2

    def mask(self, ks=None):
        """The mask at knots ks (every knot when None), to broadcast against
        a knot stack's [K, B]: [K, 1] shared or [K, B] per lane."""
        a = self.active if ks is None else self.active[ks]
        return a if a.ndim == 2 else a[:, None]

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
    h, k) -> [n, n+m, *batch] optional. Or dynamics=None and linear
    dynamics arrays A [N, n, n], B [N, n, m], f_aff [N, n]: x' = A x + B u
    + f (the reference's SetLinearDynamics); in the batched solves each may
    hold one row per lane (A [N, n, n, B], B [N, n, m, B], f_aff
    [N, n, B]). x0: [n] for one lane, or [n, B] lane-minor for the batched
    solve. h: [N], or [N, B] for one step length per lane and knot in the
    batched solves.
    dynamics_cols: the column-form step
    (models/tile_steps.py) that the batched rollout kernel runs on the
    card; dynamics_tile: the block-form step ([W, n] trial rows) that the
    single-lane trial rollout runs.
    """

    N: int
    n: int
    m: int
    dynamics: Optional[Callable[..., torch.Tensor]]
    dynamics_jac: Optional[Callable[..., torch.Tensor]]
    constraints: Tuple[ConstraintSpec, ...]
    cost: object  # DiagonalCost, QuadraticCost or GenericCost
    h: torch.Tensor  # [N], or [N, B] per lane
    x0: torch.Tensor
    A: Optional[torch.Tensor] = None  # [N, n, n], or [N, n, n, B] per lane
    B: Optional[torch.Tensor] = None  # [N, n, m], or [N, n, m, B] per lane
    f_aff: Optional[torch.Tensor] = None  # [N, n], or [N, n, B] per lane
    dynamics_cols: Optional[Callable[..., tuple]] = None
    dynamics_tile: Optional[Callable[..., torch.Tensor]] = None

    @property
    def dtype(self):
        return self.x0.dtype

    @property
    def device(self):
        return self.x0.device

    @property
    def linear_dynamics(self) -> bool:
        return self.dynamics is None

    @property
    def lane_leaves(self) -> Tuple[str, ...]:
        """The names of the leaves that hold one row per lane: the cost's
        (`cost.Q`, ...), h, A, B, f_aff and each group's mask
        (`constraints[j].active`); x0 carries the lanes themselves."""
        names = tuple(f"cost.{name}" for name in self.cost.lane_leaves) + _lane_leaves(self)
        return names + tuple(f"constraints[{j}].active"
                             for j, spec in enumerate(self.constraints) if spec.per_lane)

    def _knot_rows(self, M, k, batch, base):
        """M[k] with its trailing (row) axes leading, expanded to
        (rows..., *batch); k an int or a knot tensor that broadcasts
        against the batch dims (trailing-aligned). base: M's dims on one
        lane; a per-lane M (base + 1 dims) takes its lane from the last
        batch dim, whose entry in a knot tensor is 1, as in `h_at`."""
        if M.ndim == base + 1:
            if torch.is_tensor(k) and k.ndim and k.shape[-1] == 1:
                k = k[..., 0]
            Mk = M[k]  # [*knot dims, rows..., B]
            kd = Mk.ndim - M.ndim + 1
            rows = Mk.shape[kd:-1]
            Mk = Mk.movedim(tuple(range(kd)), tuple(range(len(rows), len(rows) + kd)))
            Mk = Mk.reshape(rows + (1,) * (len(batch) - 1 - kd) + Mk.shape[len(rows):])
            return Mk.expand(rows + batch)
        Mk = M[k]
        kd = Mk.ndim - (M.ndim - 1)  # the knot tensor's dims
        rows = Mk.shape[kd:]
        Mk = Mk.movedim(tuple(range(kd)), tuple(range(Mk.ndim - kd, Mk.ndim)))
        Mk = Mk.reshape(rows + (1,) * (len(batch) - kd) + Mk.shape[len(rows):])
        return Mk.expand(rows + batch)

    def dyn_step(self, k, x, u):
        """x_{k+1} = f(x_k, u_k) on component-first tensors."""
        if self.linear_dynamics:
            A, B = self.dyn_expansion(k, x, u)
            batch = A.shape[2:]
            return (torch.einsum("ij...,j...->i...", A, x.expand((self.n,) + batch))
                    + torch.einsum("ij...,j...->i...", B, u.expand((self.m,) + batch))
                    + self._knot_rows(self.f_aff, k, batch, 2))
        return self.dynamics(x, u, self.h_at(k), k)

    def h_at(self, k):
        """The step length at knot k, broadcasting against the batch dims:
        a shared h [N] gives h[k]; a per-lane h [N, B] gives [B] for an
        int k and [..., B] for a knot tensor [..., 1] (knots along the
        leading batch dims, the lanes last)."""
        if self.h.ndim == 1:
            return self.h[k]
        if torch.is_tensor(k) and k.ndim and k.shape[-1] == 1:
            return self.h[k[..., 0]]
        return self.h[k]

    def dyn_expansion(self, k, x, u):
        """(A [n, n, *batch], B [n, m, *batch]) of the dynamics at (x, u)
        (the linear arrays themselves when the dynamics are linear)."""
        if self.linear_dynamics:
            batch = torch.broadcast_shapes(x.shape[1:], u.shape[1:],
                                           k.shape if torch.is_tensor(k) else ())
            return (self._knot_rows(self.A, k, batch, 3),
                    self._knot_rows(self.B, k, batch, 3))
        if self.dynamics_jac is not None:
            J = self.dynamics_jac(x, u, self.h_at(k), k)
            return J[:, : self.n], J[:, self.n:]
        return lane_jacobian(self.dynamics, x, u, self.h_at(k), k)

    def init_duals(self) -> Tuple[torch.Tensor, ...]:
        """Zero dual variables, one [N+1, dim] tensor per constraint group."""
        return tuple(
            torch.zeros((self.N + 1, spec.dim), dtype=self.dtype, device=self.device)
            for spec in self.constraints
        )


# ---------------------------------------------------------------------------
# Data leaves
# ---------------------------------------------------------------------------


def _is_float(t) -> bool:
    return torch.is_tensor(t) and t.is_floating_point()


def _cost_leaf_names(cost) -> Tuple[str, ...]:
    if not dataclasses.is_dataclass(cost):
        return ()
    return tuple(f.name for f in dataclasses.fields(cost) if _is_float(getattr(cost, f.name)))


def problem_leaves(problem: Problem) -> Tuple[Tuple[str, torch.Tensor], ...]:
    """The problem's floating-point data leaves as (name, tensor) pairs, in
    the order of JAX's `tree_flatten` of a `Problem`: the cost's arrays in
    field order (DiagonalCost Q, R, q, r, c; QuadraticCost Q, R, H, q, r,
    c; none for GenericCost), then h, x0 and, when present, A, B, f_aff.
    The constraints' `active` masks are not floats and carry no gradient
    (JAX's float0 leaves): they stay with the problem."""
    leaves = [(f"cost.{name}", getattr(problem.cost, name))
              for name in _cost_leaf_names(problem.cost)]
    leaves += [("h", problem.h), ("x0", problem.x0)]
    leaves += [(name, getattr(problem, name)) for name in ("A", "B", "f_aff")
               if getattr(problem, name) is not None]
    return tuple(leaves)


def problem_with_leaves(problem: Problem, leaves) -> Problem:
    """The problem with its data leaves replaced, in `problem_leaves`'
    order (the counterpart of JAX's `tree_unflatten`)."""
    names = [name for name, _ in problem_leaves(problem)]
    if len(leaves) != len(names):
        raise ValueError(f"problem_with_leaves: {len(leaves)} leaves for {len(names)}")
    new = dict(zip(names, leaves))
    cost_kw = {name[5:]: t for name, t in new.items() if name.startswith("cost.")}
    cost = dataclasses.replace(problem.cost, **cost_kw) if cost_kw else problem.cost
    return dataclasses.replace(problem, cost=cost, **{
        name: t for name, t in new.items() if not name.startswith("cost.")})
