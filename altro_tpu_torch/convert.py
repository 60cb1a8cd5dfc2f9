"""Problem data and solver state carried between the two packages.

No single JAX counterpart: these are the port's weight loaders. The JAX
package's "weights" are its problem data and its SolverState; after
`np.asarray` on each leaf they load here unchanged (batch-major), so a
test hands both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from altro_tpu_torch.problem import ConstraintSpec, DiagonalCost, Problem, QuadraticCost
from altro_tpu_torch.solver import SolverState

__all__ = ["problem_from_numpy", "state_from_numpy", "state_to_numpy"]

_STATE_FIELDS = ("x", "u", "y", "rho", "K", "d", "P", "p", "reg")


def problem_from_numpy(arrays: dict, *, N: int, n: int, m: int, dynamics,
                       constraints: Sequence[ConstraintSpec] = (),
                       dynamics_cols=None, batched: Sequence[str] = (),
                       dtype=torch.float64, device="cuda") -> Problem:
    """Problem from numpy arrays: the cost's Q, R, q, r, c (DiagonalCost
    rows; with "H" as well a QuadraticCost, Q [N+1, n, n], R [N+1, m, m],
    H [N+1, m, n]), h, x0, optionally linear dynamics arrays "A", "B",
    "f_aff" (with `dynamics=None`) and "active", one [N+1] mask per
    constraint group (it replaces that group's `active`). `batched` names
    the leaves given one row per lane, batch-major as JAX's `prob_axes`
    and `jax.vmap` batch them ([B, ...]: Q [B, N+1, n], c [B, N+1],
    h [B, N], x0 [B, n], A [B, N, n, n], ...; "active" in it: each
    group's mask [B, N+1]); they land lane-minor ([..., B]). Lands on the
    card unless `device` says otherwise."""
    kw = dict(dtype=dtype, device=device)

    def lanes(a, name):
        a = np.array(a)
        return np.ascontiguousarray(np.moveaxis(a, 0, -1)) if name in batched else a

    def t(name):
        return None if name not in arrays else torch.as_tensor(lanes(arrays[name], name), **kw)

    names = ("Q", "R", "H", "q", "r", "c") if "H" in arrays else ("Q", "R", "q", "r", "c")
    cost = (QuadraticCost if "H" in arrays else DiagonalCost)(**{k: t(k) for k in names})
    actives = arrays.get("active")
    specs = []
    for j, spec in enumerate(constraints):
        act = spec.active if actives is None else lanes(actives[j], "active")
        act = torch.as_tensor(np.array(act), dtype=torch.bool, device=device)
        specs.append(dataclasses.replace(spec, active=act))
    return Problem(N=N, n=n, m=m, dynamics=dynamics, dynamics_jac=None,
                   constraints=tuple(specs), cost=cost, h=t("h"), x0=t("x0"),
                   A=t("A"), B=t("B"), f_aff=t("f_aff"), dynamics_cols=dynamics_cols)


def state_from_numpy(arrays: dict, *, dtype=torch.float64, device="cuda") -> SolverState:
    """SolverState (batch-major) from a dict of numpy arrays with the JAX
    SolverState's leaf names; "z" is a sequence, one array per group."""
    kw = dict(dtype=dtype, device=device)
    vals = {f: torch.as_tensor(np.array(arrays[f]), **kw) for f in _STATE_FIELDS}
    vals["z"] = tuple(torch.as_tensor(np.array(zj), **kw) for zj in arrays["z"])
    return SolverState(**vals)


def state_to_numpy(state: SolverState) -> dict:
    """Dict of numpy arrays, the inverse of `state_from_numpy`."""
    out = {f: getattr(state, f).detach().cpu().numpy() for f in _STATE_FIELDS}
    out["z"] = tuple(zj.detach().cpu().numpy() for zj in state.z)
    return out
