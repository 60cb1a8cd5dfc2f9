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

from altro_tpu_torch.problem import ConstraintSpec, DiagonalCost, Problem
from altro_tpu_torch.solver import SolverState

__all__ = ["problem_from_numpy", "state_from_numpy", "state_to_numpy"]

_STATE_FIELDS = ("x", "u", "y", "rho", "K", "d", "P", "p", "reg")


def problem_from_numpy(arrays: dict, *, N: int, n: int, m: int, dynamics,
                       constraints: Sequence[ConstraintSpec] = (),
                       dynamics_cols=None, dtype=torch.float64,
                       device="cpu") -> Problem:
    """Problem from numpy arrays: Q, R, q, r, c (DiagonalCost rows), h, x0,
    and optionally "active", one [N+1] mask per constraint group (it
    replaces that group's `active`)."""
    kw = dict(dtype=dtype, device=device)

    def t(name):
        return torch.as_tensor(np.array(arrays[name]), **kw)

    cost = DiagonalCost(Q=t("Q"), R=t("R"), q=t("q"), r=t("r"), c=t("c"))
    actives = arrays.get("active")
    specs = []
    for j, spec in enumerate(constraints):
        act = spec.active if actives is None else actives[j]
        act = torch.as_tensor(np.array(act), dtype=torch.bool, device=device)
        specs.append(dataclasses.replace(spec, active=act))
    return Problem(N=N, n=n, m=m, dynamics=dynamics, dynamics_jac=None,
                   constraints=tuple(specs), cost=cost, h=t("h"), x0=t("x0"),
                   dynamics_cols=dynamics_cols)


def state_from_numpy(arrays: dict, *, dtype=torch.float64, device="cpu") -> SolverState:
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
