"""Stateful facade: `ALTROSolver` (PyTorch port).

Counterpart: altro_tpu/api.py (`ALTROSolver`, `LAST_INDEX`,
`ALL_INDICES`). The same define-then-solve surface as the C++ reference's
public API: per-knot problem definition over [k_start, k_stop) ranges with
the LAST_INDEX / ALL_INDICES sentinels, heterogeneous per-knot dimensions
(padded to (max n, max m) exactly as JAX pads them), initialize / solve,
the MPC updates, the getters and the trajectory printers. Everything is
built into the port's (Problem, SolverState) and solved by the
single-lane `solver.solve`, so on the card the backward pass runs the
latency kernel and, with a block step (`set_tile_dynamics`), the
phase-split grid runs the trial-rollout kernel, or the solve is refused
before it starts.

User callables take component-first tensors with trailing batch dims, as
everywhere in the port: dynamics(x [n, *batch], u [m, *batch], h, k),
constraint fn(x, u, k) -> [dim, *batch], the generic cost's stage(x, u, k)
-> [*batch] and terminal(x) -> [*batch]; k is an int or an integer tensor
that broadcasts against the batch dims.

Not ported: `_print_host_summary`, which exists for a JAX backend without
host callbacks; the port prints from its host loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from altro_tpu_torch.cones import Cone
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import (
    ConstraintSpec,
    DiagonalCost,
    GenericCost,
    Problem,
    QuadraticCost,
)
from altro_tpu_torch.solver import (
    SolverState,
    al_total_cost,
    init_state,
    open_loop_rollout,
    solve as _solve,
)
from altro_tpu_torch.status import AltroError, ErrorCode, SolveStatus

__all__ = ["ALTROSolver", "LAST_INDEX", "ALL_INDICES"]

LAST_INDEX = -1
ALL_INDICES = -2

# Statuses throw_errors does not raise on: MERIT_FUN_GRADIENT_TOO_SMALL is
# benign in the reference loop (solver.cpp:451), MAX_SOLVE_TIME is the
# budget working as intended.
_BENIGN_STATUSES = frozenset({
    SolveStatus.SUCCESS,
    SolveStatus.MAX_ITERATIONS,
    SolveStatus.MAX_SOLVE_TIME,
    SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL,
})

_STATUS_ERROR_CODES = {
    SolveStatus.BACKWARD_PASS_FAILED: ErrorCode.BACKWARD_PASS_FAILED,
    SolveStatus.LINE_SEARCH_FAILED: ErrorCode.LINE_SEARCH_FAILED,
}


def _column(v, x):
    """A [c] tensor shaped to broadcast against component-first x [c, *batch]."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


class ALTROSolver:
    """Define-then-solve API over the port's functional core.

        solver = ALTROSolver(N, device="cpu")   # device=None: the card
        solver.set_dimension(n, m)
        solver.set_time_step(h)
        solver.set_explicit_dynamics(dyn)        # dyn(x, u, h, k)
        solver.set_lqr_cost(Qd, Rd, xf, uf, 0, LAST_INDEX)
        solver.set_constraint(goal, n_goal, Cone.ZERO, "goal", N)
        solver.set_initial_state(x0)
        solver.initialize()
        status = solver.solve()

    dtype=None is torch.float32 (JAX's default without x64); device=None
    is "cuda".
    """

    def __init__(self, horizon_length: int, dtype=None, device=None):
        if horizon_length <= 0:
            raise AltroError(ErrorCode.BAD_INDEX, "horizon must be positive")
        self.N = horizon_length
        self.dtype = dtype or torch.float32
        self.device = torch.device("cuda" if device is None else device)
        self.n: Optional[int] = None
        self.m: Optional[int] = None
        # per-knot dims (heterogeneous problems), padded to (max n, max m)
        self._nk: Optional[np.ndarray] = None
        self._mk: Optional[np.ndarray] = None
        self._h = np.zeros(self.N)
        self._dynamics: list = [None] * self.N
        self._dynamics_jac: list = [None] * self.N
        self._dynamics_tile = None
        self._dynamics_cols = None
        self._cost_kind = None  # "diagonal" | "quadratic" | "generic"
        self._cost_rows = None
        self._generic_cost = None
        self._constraints: list = []
        self._x0 = None
        self._problem: Optional[Problem] = None
        self._state: Optional[SolverState] = None
        self._opts = SolverOptions()
        self._stats = None
        self._solve_time_ms = float("nan")

    def _t(self, a, dtype=None):
        """An array, a list or a tensor as a tensor of the solver's device
        (and dtype, unless another is given)."""
        if not torch.is_tensor(a):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=dtype or self.dtype, device=self.device)

    # ------------------------------------------------------------ ranges

    def _range(self, k_start: int, k_stop: int, inclusive: bool) -> range:
        """The reference's index semantics (altro_solver.cpp:385-433):
        [k_start, k_stop); (0, LAST_INDEX) or (ALL_INDICES, 0) the full
        range; k_stop <= 0 the single index k_start."""
        terminal = self.N if inclusive else self.N - 1
        if k_start == ALL_INDICES and k_stop == 0:
            k_start, k_stop = 0, LAST_INDEX
        if k_start == 0 and k_stop == LAST_INDEX:
            return range(0, terminal + 1)
        if k_stop <= 0:
            k_stop = k_start + 1
        if not (0 <= k_start <= terminal) or k_stop > terminal + 1:
            raise AltroError(ErrorCode.BAD_INDEX,
                             f"index range [{k_start},{k_stop}) out of [0,{terminal + 1})")
        return range(k_start, k_stop)

    def _require_dims(self):
        if self.n is None or self.m is None:
            raise AltroError(ErrorCode.DIMENSION_UNKNOWN, "call set_dimension first")

    # ----------------------------------------------------------- setters

    def set_dimension(self, num_states: int, num_inputs: int, k_start: int = 0,
                      k_stop: int = LAST_INDEX):
        """Set (n_k, m_k) over a knot range. Heterogeneous dims are padded
        to (max n, max m): sliced user callables, zero-filled padded next
        states, a unit input-cost diagonal on padded inputs. Call it before
        the dynamics, cost and constraint setters of the knots involved."""
        if num_states <= 0:
            raise AltroError(ErrorCode.STATE_DIM_UNKNOWN)
        if num_inputs <= 0:
            raise AltroError(ErrorCode.INPUT_DIM_UNKNOWN)
        if self._nk is None:
            self._nk = np.full(self.N + 1, -1, dtype=int)
            self._mk = np.full(self.N + 1, -1, dtype=int)
        for k in self._range(k_start, k_stop, inclusive=True):
            self._nk[k] = num_states
            self._mk[k] = num_inputs
        new_n, new_m = int(self._nk.max()), int(self._mk.max())
        grew = self.n is not None and (new_n > self.n or new_m > self.m)
        self.n, self.m = new_n, new_m
        if self._cost_rows is None:
            self._init_cost_rows()
        elif grew:
            self._grow_cost_rows()
        return self

    @property
    def _hetero(self) -> bool:
        if self._nk is None:
            return False
        known = self._nk >= 0
        return bool(np.any(self._nk[known] != self.n) or np.any(self._mk[known] != self.m))

    def _knot_dims(self, k: int):
        """(n_k, m_k): the knot's own dims (the max dims if unset)."""
        if self._nk is None or self._nk[k] < 0:
            return self.n, self.m
        return int(self._nk[k]), int(self._mk[k])

    def _dims_groups(self, ks):
        groups: dict = {}
        for k in ks:
            groups.setdefault(self._knot_dims(k), []).append(k)
        return groups

    def _grow_cost_rows(self):
        old = self._cost_rows
        self._init_cost_rows()
        for name, arr in old.items():
            self._cost_rows[name][tuple(slice(0, s) for s in arr.shape)] = arr

    def _init_cost_rows(self):
        n, m, N = self.n, self.m, self.N
        self._cost_rows = dict(
            Q=np.zeros((N + 1, n)), R=np.zeros((N + 1, m)),
            q=np.zeros((N + 1, n)), r=np.zeros((N + 1, m)), c=np.zeros(N + 1),
            Qfull=np.zeros((N + 1, n, n)), Rfull=np.zeros((N + 1, m, m)),
            H=np.zeros((N + 1, m, n)),
        )

    def set_time_step(self, h: float, k_start: int = 0, k_stop: int = LAST_INDEX):
        if h <= 0:
            raise AltroError(ErrorCode.TIMESTEP_NOT_POSITIVE)
        h = float(np.float32(h))  # the reference stores time steps as float32
        for k in self._range(k_start, k_stop, inclusive=False):
            self._h[k] = h
        return self

    def set_explicit_dynamics(self, dynamics: Callable, jacobian: Optional[Callable] = None,
                              k_start: int = 0, k_stop: int = LAST_INDEX):
        """dynamics(x, u, h, k) -> x_next; jacobian(x, u, h, k) ->
        [n, n+m, *batch] optional (default: forward-mode AD)."""
        for k in self._range(k_start, k_stop, inclusive=False):
            self._dynamics[k] = dynamics
            self._dynamics_jac[k] = jacobian
        return self

    def set_tile_dynamics(self, step_tile: Callable = None, *, step_cols: Callable = None):
        """The block step (Problem.dynamics_tile) that the single-lane trial
        rollout runs, and the column step (Problem.dynamics_cols) of the
        batched rollout (models/tile_steps.py). With a diagonal cost and
        affine NEGATIVE_ORTHANT groups (the bound setters declare theirs),
        the phase-split grid runs the trial rollout: its kernel on the card,
        where the block step names a device step."""
        if step_tile is not None:
            self._dynamics_tile = step_tile
        if step_cols is not None:
            self._dynamics_cols = step_cols
        if self._problem is not None:  # already initialized: swap in place
            self._problem = dataclasses.replace(self._problem, dynamics_tile=self._dynamics_tile,
                                                dynamics_cols=self._dynamics_cols)
        return self

    def set_linear_dynamics(self, A, B, f=None, k_start: int = 0, k_stop: int = LAST_INDEX):
        """x_next = A x + B u + f, as closures with a constant Jacobian."""
        A, B = np.asarray(A, float), np.asarray(B, float)
        f = np.zeros(A.shape[0]) if f is None else np.asarray(f, float)
        At, Bt, ft = self._t(A), self._t(B), self._t(f)
        J = torch.cat([At, Bt], dim=1)

        def dyn(x, u, h, k):
            return (torch.tensordot(At, x, dims=1) + torch.tensordot(Bt, u, dims=1)
                    + _column(ft, x))

        def jac(x, u, h, k):
            batch = torch.broadcast_shapes(x.shape[1:], u.shape[1:])
            return J.reshape(J.shape + (1,) * len(batch)).expand(J.shape + batch)

        return self.set_explicit_dynamics(dyn, jac, k_start, k_stop)

    def set_lqr_cost(self, Q_diag, R_diag, x_ref, u_ref, k_start: int = 0,
                     k_stop: int = LAST_INDEX):
        """Tracking cost 0.5|x-xref|^2_Q + 0.5|u-uref|^2_R, expanded into
        (q, r, c) as the reference does (altro_solver.cpp:138-172)."""
        self._require_dims()
        Qd, Rd = np.asarray(Q_diag, float), np.asarray(R_diag, float)
        xr, ur = np.asarray(x_ref, float), np.asarray(u_ref, float)
        rows = self._cost_rows
        for k in self._range(k_start, k_stop, inclusive=True):
            rows["Q"][k] = self._pad_row(Qd, self.n)
            rows["R"][k] = self._pad_row(Rd, self.m)
            rows["q"][k] = self._pad_row(-Qd * xr, self.n)
            rows["r"][k] = self._pad_row(-Rd * ur, self.m)
            c = 0.5 * float(xr @ (Qd * xr))
            if k != self.N:
                c += 0.5 * float(ur @ (Rd * ur))
            rows["c"][k] = c
        self._cost_kind = self._cost_kind or "diagonal"
        return self

    def set_diagonal_cost(self, Q_diag, R_diag, q, r, c: float = 0.0, k_start: int = 0,
                          k_stop: int = LAST_INDEX):
        self._require_dims()
        rows = self._cost_rows
        for k in self._range(k_start, k_stop, inclusive=True):
            rows["Q"][k] = self._pad_row(Q_diag, self.n)
            rows["R"][k] = self._pad_row(R_diag, self.m)
            rows["q"][k] = self._pad_row(q, self.n)
            rows["r"][k] = self._pad_row(r, self.m)
            rows["c"][k] = c
        self._cost_kind = self._cost_kind or "diagonal"
        return self

    @staticmethod
    def _pad_row(vec, size):
        """A knot-sized cost vector zero-padded to the max dimension."""
        vec = np.asarray(vec, float)
        if vec.shape[0] == size:
            return vec
        if vec.shape[0] > size:
            raise AltroError(ErrorCode.DIMENSION_MISMATCH,
                             f"cost term of size {vec.shape[0]} > {size}")
        return np.concatenate([vec, np.zeros(size - vec.shape[0])])

    @staticmethod
    def _pad_mat(mat, rows_, cols):
        mat = np.asarray(mat, float)
        if mat.shape == (rows_, cols):
            return mat
        out = np.zeros((rows_, cols))
        out[: mat.shape[0], : mat.shape[1]] = mat
        return out

    def set_quadratic_cost(self, Q, R, H, q, r, c: float = 0.0, k_start: int = 0,
                           k_stop: int = LAST_INDEX):
        self._require_dims()
        rows = self._cost_rows
        for k in self._range(k_start, k_stop, inclusive=True):
            rows["Qfull"][k] = self._pad_mat(Q, self.n, self.n)
            rows["Rfull"][k] = self._pad_mat(R, self.m, self.m)
            rows["H"][k] = self._pad_mat(H, self.m, self.n)
            rows["q"][k] = self._pad_row(q, self.n)
            rows["r"][k] = self._pad_row(r, self.m)
            rows["c"][k] = c
        self._cost_kind = "quadratic"
        return self

    def set_cost_function(self, stage: Callable, terminal: Callable):
        """Generic costs: stage(x, u, k) and terminal(x), differentiated by
        forward-mode AD (problem.GenericCost)."""
        self._generic_cost = GenericCost(stage=stage, term=terminal)
        self._cost_kind = "generic"
        return self

    def _wrap_hetero_constraint(self, fn, jac, nk, mk):
        """The user's constraint on a knot's own (n_k, m_k) slice of the
        padded (x, u); its Jacobian embedded in the padded frame."""
        n, m = self.n, self.m
        if (nk, mk) == (n, m):
            return fn, jac

        def fn2(x, u, k):
            return fn(x[:nk], u[:mk], k)

        if jac is None:
            return fn2, None

        def jac2(x, u, k):
            J = jac(x[:nk], u[:mk], k)  # [p, nk + mk, *batch]
            out = J.new_zeros((J.shape[0], n + m) + J.shape[2:])
            out[:, :nk] = J[:, :nk]
            out[:, n:n + mk] = J[:, nk:]
            return out

        return fn2, jac2

    def set_constraint(self, fn: Callable, dim: int, cone: Cone, label: str = "",
                       k_start: int = 0, k_stop: int = 0,
                       jacobian: Optional[Callable] = None):
        """fn(x, u, k) -> [dim, *batch] (u is zero at the terminal knot).
        With heterogeneous dims fn receives the knot's own (n_k, m_k)
        slices of the padded state and input."""
        if dim <= 0:
            raise AltroError(ErrorCode.INVALID_CONSTRAINT_DIM)
        ks = list(self._range(k_start, k_stop, inclusive=True))
        groups = self._dims_groups(ks) if self._hetero else {(self.n, self.m): ks}
        for (nk, mk), knots in groups.items():
            fn_w, jac_w = self._wrap_hetero_constraint(fn, jacobian, nk, mk)
            active = np.zeros(self.N + 1, bool)
            active[knots] = True
            self._constraints.append(ConstraintSpec(
                fn=fn_w, cone=cone, dim=dim, active=self._t(active, torch.bool), jac=jac_w,
                label=label))
        return self

    def set_state_bounds(self, x_lo=None, x_hi=None, k_start: int = 0,
                         k_stop: int = LAST_INDEX):
        """Bound constraints on the state (a masked NEGATIVE_ORTHANT group)."""
        self._require_dims()
        lo = np.full(self.n, -np.inf) if x_lo is None else np.asarray(x_lo, float)
        hi = np.full(self.n, np.inf) if x_hi is None else np.asarray(x_hi, float)
        lo, hi = self._pad_bounds(lo, hi, self.n, k_start, k_stop, True, True)
        if np.any(hi < lo):
            raise AltroError(ErrorCode.INVALID_BOUND_CONSTRAINT)
        return self._bound_constraint(lo, hi, on_state=True, label="state bounds",
                                      k_start=k_start, k_stop=k_stop, inclusive=True)

    def set_input_bounds(self, u_lo=None, u_hi=None, k_start: int = 0,
                         k_stop: int = LAST_INDEX):
        self._require_dims()
        lo = np.full(self.m, -np.inf) if u_lo is None else np.asarray(u_lo, float)
        hi = np.full(self.m, np.inf) if u_hi is None else np.asarray(u_hi, float)
        lo, hi = self._pad_bounds(lo, hi, self.m, k_start, k_stop, False, False)
        if np.any(hi < lo):
            raise AltroError(ErrorCode.INVALID_BOUND_CONSTRAINT)
        return self._bound_constraint(lo, hi, on_state=False, label="input bounds",
                                      k_start=k_start, k_stop=k_stop, inclusive=False)

    def _pad_bounds(self, lo, hi, size, k_start, k_stop, inclusive, on_state):
        """Knot-sized bound vectors extended to the padded max dimension
        (padded coordinates unbounded); the knot dims must be uniform over
        the range."""
        if lo.shape[0] == size:
            return lo, hi
        ks = list(self._range(k_start, k_stop, inclusive=inclusive))
        dims = {self._knot_dims(k)[0 if on_state else 1] for k in ks}
        if len(dims) != 1 or lo.shape[0] != next(iter(dims)):
            raise AltroError(ErrorCode.DIMENSION_MISMATCH,
                             "bound vector size must equal the knot dimension (uniform "
                             "over the range) or the padded max dimension")
        pad = size - lo.shape[0]
        return (np.concatenate([lo, np.full(pad, -np.inf)]),
                np.concatenate([hi, np.full(pad, np.inf)]))

    def _bound_constraint(self, lo, hi, on_state, label, k_start, k_stop, inclusive):
        """Rows v - hi and lo - v (an infinite bound's row is the constant
        -1, strictly feasible): affine, with a diagonal AL Hessian, so the
        trial rollout takes them."""
        finite_hi, finite_lo = np.isfinite(hi), np.isfinite(lo)
        hi_f = self._t(np.where(finite_hi, hi, 0.0))
        lo_f = self._t(np.where(finite_lo, lo, 0.0))
        mask_hi = self._t(finite_hi, torch.bool)
        mask_lo = self._t(finite_lo, torch.bool)

        def fn(x, u, k):
            v = x if on_state else u
            c_hi = torch.where(_column(mask_hi, v), v - _column(hi_f, v), -1.0)
            c_lo = torch.where(_column(mask_lo, v), _column(lo_f, v) - v, -1.0)
            return torch.cat([c_hi, c_lo])

        active = np.zeros(self.N + 1, bool)
        active[list(self._range(k_start, k_stop, inclusive=inclusive))] = True
        self._constraints.append(ConstraintSpec(
            fn=fn, cone=Cone.NEGATIVE_ORTHANT, dim=2 * len(lo),
            active=self._t(active, torch.bool), label=label, diag_hessian=True, affine=True))
        return self

    def set_initial_state(self, x0):
        self._x0 = np.asarray(x0, float)
        if self._problem is not None:
            self._problem = dataclasses.replace(self._problem, x0=self._t(self._x0))
        return self

    def set_options(self, opts: SolverOptions):
        self._opts = opts
        return self

    # ------------------------------------------------------ initialization

    def _build_cost(self):
        rows = self._cost_rows
        if self._hetero:
            # padded inputs get a unit cost diagonal: their B columns and
            # linear costs are zero, so u_pad stays 0 and Quu stays positive
            # definite; padded states keep zero cost
            for k in range(self.N):
                mk = self._knot_dims(k)[1]
                if mk < self.m:
                    rows["R"][k, mk:] = 1.0
                    rr = rows["Rfull"][k]
                    rr[mk:, :] = 0.0
                    rr[:, mk:] = 0.0
                    rr[range(mk, self.m), range(mk, self.m)] = 1.0
        if self._cost_kind == "generic":
            return self._generic_cost
        if self._cost_kind == "quadratic":
            Q, R = rows["Qfull"].copy(), rows["Rfull"].copy()
            # knots set through the diagonal API fold into the full matrices
            for k in np.where(np.abs(Q).sum(axis=(1, 2)) == 0)[0]:
                Q[k] = np.diag(rows["Q"][k])
                R[k] = np.diag(rows["R"][k])
            return QuadraticCost(Q=self._t(Q), R=self._t(R), H=self._t(rows["H"]),
                                 q=self._t(rows["q"]), r=self._t(rows["r"]),
                                 c=self._t(rows["c"]))
        return DiagonalCost(Q=self._t(rows["Q"]), R=self._t(rows["R"]), q=self._t(rows["q"]),
                            r=self._t(rows["r"]), c=self._t(rows["c"]))

    def _wrap_hetero_dynamics(self, f, j, nk, mk, nk1):
        """A (n_k, m_k) -> n_{k+1} dynamics callable padded to the max
        dims: the real coordinates sliced in, the padded next-state
        coordinates zero-filled (zero cost, zero Jacobian rows: inert)."""
        n, m = self.n, self.m
        if (nk, mk, nk1) == (n, m, n):
            return f, j

        def dyn(x, u, h, k):
            xn = f(x[:nk], u[:mk], h, k)
            if nk1 < n:
                xn = torch.cat([xn, xn.new_zeros((n - nk1,) + xn.shape[1:])])
            return xn

        if j is None:
            return dyn, None

        def jac(x, u, h, k):
            J = j(x[:nk], u[:mk], h, k)  # [nk1, nk + mk, *batch]
            out = J.new_zeros((n, n + m) + J.shape[2:])
            out[:nk1, :nk] = J[:, :nk]
            out[:nk1, n:n + mk] = J[:, nk:]
            return out

        return dyn, jac

    def _build_dynamics(self):
        fns, jacs = self._dynamics, self._dynamics_jac
        if any(f is None for f in fns):
            raise AltroError(ErrorCode.DYNAMICS_FUN_NOT_SET)
        hetero = self._hetero
        unique, keys = [], []
        index = np.zeros(self.N, np.int64)
        for k, f in enumerate(fns):
            nk, mk = self._knot_dims(k)
            nk1 = self._knot_dims(k + 1)[0]
            key = (id(f), id(jacs[k]), nk, mk, nk1) if hetero else (id(f), id(jacs[k]))
            if key in keys:
                index[k] = keys.index(key)
                continue
            index[k] = len(unique)
            keys.append(key)
            unique.append(self._wrap_hetero_dynamics(f, jacs[k], nk, mk, nk1) if hetero
                          else (f, jacs[k]))
        if len(unique) == 1:
            return unique[0]
        # per-knot dynamics: an int k calls its knot's callable; an integer
        # tensor k evaluates each distinct callable and selects by the
        # knot's index (JAX's lax.switch on a static index map)
        idx = torch.as_tensor(index, device=self.device)

        def dispatch(callables):
            def call(x, u, h, k):
                if not torch.is_tensor(k) or k.ndim == 0:
                    return callables[int(index[int(k)])](x, u, h, k)
                sel = idx[k]
                out = callables[0](x, u, h, k)
                for i in range(1, len(callables)):
                    out = torch.where(sel == i, callables[i](x, u, h, k), out)
                return out
            return call

        dyn = dispatch([f for f, _ in unique])
        if any(j is None for _, j in unique):
            return dyn, None
        return dyn, dispatch([j for _, j in unique])

    def initialize(self):
        # preconditions in the reference's order (knotpoint_data.cpp:229-276):
        # dimensions -> timestep -> dynamics -> cost
        self._require_dims()
        if self._nk is not None and np.any(self._nk < 0):
            raise AltroError(ErrorCode.STATE_DIM_UNKNOWN, "set_dimension left knots %s unset"
                             % np.where(self._nk < 0)[0].tolist())
        if self._hetero and self._cost_kind == "generic":
            raise AltroError(ErrorCode.DIMENSION_MISMATCH,
                             "generic costs are not supported with heterogeneous dimensions "
                             "(unknown cost terms cannot be masked on padded coordinates); "
                             "use diagonal or quadratic costs")
        if np.any(self._h <= 0):
            raise AltroError(ErrorCode.TIMESTEP_NOT_POSITIVE)
        dyn, jac = self._build_dynamics()
        if self._cost_kind is None:
            raise AltroError(ErrorCode.COST_FUN_NOT_SET)
        if self._x0 is None:
            self._x0 = np.zeros(self.n)
        elif self._x0.shape[0] < self.n:
            if self._x0.shape[0] != self._knot_dims(0)[0]:
                raise AltroError(ErrorCode.DIMENSION_MISMATCH,
                                 "x0 must match the knot-0 state dimension")
            self._x0 = np.concatenate([self._x0, np.zeros(self.n - self._x0.shape[0])])
        self._problem = Problem(
            N=self.N, n=self.n, m=self.m, dynamics=dyn, dynamics_jac=jac,
            constraints=tuple(self._constraints), cost=self._build_cost(),
            h=self._t(self._h), x0=self._t(self._x0),
            dynamics_cols=self._dynamics_cols, dynamics_tile=self._dynamics_tile)
        self._state = init_state(self._problem)
        return self

    def is_initialized(self) -> bool:
        return self._problem is not None

    def _require_init(self):
        if not self.is_initialized():
            raise AltroError(ErrorCode.SOLVER_NOT_INITIALIZED)

    # ------------------------------------------------------------- running

    @property
    def problem(self) -> Problem:
        self._require_init()
        return self._problem

    @property
    def state(self) -> SolverState:
        self._require_init()
        return self._state

    def _set_rows(self, name, value, ks):
        t = getattr(self._state, name).clone()
        t[torch.as_tensor(ks, device=self.device)] = self._t(value)
        self._state = dataclasses.replace(self._state, **{name: t})

    def set_state(self, x, k_start: int = 0, k_stop: int = LAST_INDEX):
        self._require_init()
        self._set_rows("x", x, list(self._range(k_start, k_stop, inclusive=True)))
        return self

    def set_input(self, u, k_start: int = 0, k_stop: int = LAST_INDEX):
        self._require_init()
        self._set_rows("u", u, list(self._range(k_start, k_stop, inclusive=False)))
        return self

    def set_dual_dynamics(self, y, k_start: int = 0, k_stop: int = LAST_INDEX):
        """Warm-start the TVLQR duals (SetDualDynamics)."""
        self._require_init()
        self._set_rows("y", y, list(self._range(k_start, k_stop, inclusive=True)))
        return self

    def set_dual_constraint(self, constraint_index: int, z, k_start: int = 0,
                            k_stop: int = LAST_INDEX):
        """Warm-start a constraint group's AL duals (SetDualGeneric)."""
        self._require_init()
        ks = torch.as_tensor(list(self._range(k_start, k_stop, inclusive=True)),
                             device=self.device)
        zs = list(self._state.z)
        zj = zs[constraint_index].clone()
        zj[ks] = self._t(z)
        zs[constraint_index] = zj
        self._state = dataclasses.replace(self._state, z=tuple(zs))
        return self

    def open_loop_rollout(self):
        self._require_init()
        self._state = dataclasses.replace(
            self._state, x=open_loop_rollout(self._problem, self._state.u))
        return self

    def calc_cost(self) -> float:
        """Objective + AL penalty terms at the current trajectory (the
        reference's CalcCost, solver.cpp:163-174)."""
        self._require_init()
        s = self._state
        return float(al_total_cost(self._problem, s.x, s.u, s.z, s.rho))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _raise_on(self, status):
        if self._opts.throw_errors and status not in _BENIGN_STATUSES:
            raise AltroError(_STATUS_ERROR_CODES.get(status, ErrorCode.LINE_SEARCH_FAILED),
                             f"solve failed: {status.name}")

    def solve(self) -> SolveStatus:
        """One solve from the carried state; the clock is read with the
        device synchronised."""
        self._require_init()
        if self._opts.max_solve_time != float("inf"):
            return self._solve_timed()
        self._sync()
        t0 = time.perf_counter()
        self._state, self._stats = _solve(self._problem, self._state, self._opts)
        self._sync()
        self._solve_time_ms = (time.perf_counter() - t0) * 1e3
        status = SolveStatus(int(self._stats.status))
        self._raise_on(status)
        return status

    def _solve_timed(self) -> SolveStatus:
        """options.max_solve_time, enforced on the host: chunks of at most
        10 iterations, the clock read between chunks. Every chunk warm-starts
        the penalty (a cold start's reset is reproduced by seeding rho so
        that clip(rho * decay, penalty_initial, penalty_max) is
        penalty_initial); on an exhausted budget the status is
        MAX_SOLVE_TIME and the iterates so far are kept."""
        opts = self._opts
        chunk = max(1, min(opts.iterations_max, 10))
        total_iters = 0
        opts_chunk = opts.replace(iterations_max=chunk, max_solve_time=float("inf"),
                                  throw_errors=False, penalty_warm_start=True)
        if not opts.penalty_warm_start:
            decay = opts.penalty_warm_start_decay
            seed = opts.penalty_initial / decay if decay > 0 else opts.penalty_initial
            self._state = dataclasses.replace(
                self._state, rho=torch.full_like(self._state.rho, seed))
        self._sync()
        t0 = time.perf_counter()
        while True:
            self._state, self._stats = _solve(self._problem, self._state, opts_chunk)
            self._sync()
            total_iters += int(self._stats.iterations)
            status = SolveStatus(int(self._stats.status))
            if status not in (SolveStatus.MAX_ITERATIONS,
                              SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL):
                break  # converged or failed inside the chunk
            if total_iters >= opts.iterations_max:
                break
            if time.perf_counter() - t0 >= opts.max_solve_time:
                status = SolveStatus.MAX_SOLVE_TIME
                break
        self._solve_time_ms = (time.perf_counter() - t0) * 1e3
        dev = self._stats.status.device
        self._stats = dataclasses.replace(
            self._stats, status=torch.tensor(int(status), dtype=torch.int32, device=dev),
            iterations=torch.tensor(total_iters, dtype=torch.int32, device=dev))
        self._raise_on(status)
        return status

    # ------------------------------------------------------------- getters

    def get_state(self, k: int) -> np.ndarray:
        self._require_init()
        return self._state.x[k].cpu().numpy()[: self._knot_dims(k)[0]]

    def get_input(self, k: int) -> np.ndarray:
        self._require_init()
        return self._state.u[k].cpu().numpy()[: self._knot_dims(k)[1]]

    def get_dual_dynamics(self, k: int) -> np.ndarray:
        self._require_init()
        return self._state.y[k].cpu().numpy()

    def get_dual_constraint(self, constraint_index: int, k: int) -> np.ndarray:
        """The AL dual of constraint group `constraint_index` at knot k."""
        self._require_init()
        return self._state.z[constraint_index][k].cpu().numpy()

    def get_feedback_gain(self, k: int) -> np.ndarray:
        self._require_init()
        return self._state.K[k].cpu().numpy()

    def get_feedforward_gain(self, k: int) -> np.ndarray:
        self._require_init()
        return self._state.d[k].cpu().numpy()

    def get_iterations(self) -> int:
        return int(self._stats.iterations)

    def get_status(self) -> SolveStatus:
        return SolveStatus(int(self._stats.status))

    def get_solve_time_ms(self) -> float:
        return self._solve_time_ms

    def get_final_objective(self) -> float:
        return float(self._stats.objective_value)

    def get_primal_feasibility(self) -> float:
        return float(self._stats.primal_feasibility)

    def get_stationarity(self) -> float:
        return float(self._stats.stationarity)

    @property
    def stats(self):
        return self._stats

    def get_time_step(self, k: int) -> float:
        return float(self._h[k])

    def get_final_time(self) -> float:
        return float(self._h.sum())

    def get_horizon_length(self) -> int:
        return self.N

    def get_state_dim(self, k: Optional[int] = None) -> int:
        """The state dimension of knot k (the padded max when k is None)."""
        return self.n if k is None else self._knot_dims(k)[0]

    def get_input_dim(self, k: Optional[int] = None) -> int:
        return self.m if k is None else self._knot_dims(k)[1]

    # ----------------------------------------------------------------- MPC

    def update_linear_costs(self, q=None, r=None, c=None, k_start: int = 0,
                            k_stop: int = LAST_INDEX):
        """Slide the linear cost terms (altro_solver.cpp:266-281)."""
        self._require_init()
        cost = self._problem.cost
        if not isinstance(cost, (DiagonalCost, QuadraticCost)):
            raise AltroError(ErrorCode.COST_NOT_QUADRATIC)
        ks = torch.as_tensor(list(self._range(k_start, k_stop, inclusive=True)),
                             device=self.device)
        kw = {}
        for name, v in (("q", q), ("r", r), ("c", c)):
            if v is not None:
                t = getattr(cost, name).clone()
                t[ks] = self._t(v)
                kw[name] = t
        self._problem = dataclasses.replace(self._problem, cost=dataclasses.replace(cost, **kw))
        return self

    def update_initial_state(self, x0):
        self._require_init()
        self._problem = dataclasses.replace(self._problem, x0=self._t(x0))
        return self

    def shift_trajectory(self):
        """Warm-start shift (altro_solver.cpp:283-293)."""
        self._require_init()
        from altro_tpu_torch.mpc import shift_trajectory

        self._state = shift_trajectory(self._state)
        return self

    # ------------------------------------------------------------ printing

    def print_state_trajectory(self):
        """ALTROSolver::PrintStateTrajectory (altro_solver.cpp:464-470)."""
        self._require_init()
        print("STATE TRAJECTORY:")
        x = self._state.x.cpu().numpy()
        for k in range(self.N + 1):
            print(f" x[{k:3d}]: " + np.array2string(x[k], precision=4))

    def print_input_trajectory(self):
        self._require_init()
        print("INPUT TRAJECTORY:")
        u = self._state.u.cpu().numpy()
        for k in range(self.N):
            print(f" u[{k:3d}]: " + np.array2string(u[k], precision=4))
