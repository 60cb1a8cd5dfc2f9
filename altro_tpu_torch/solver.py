"""Solver state, statistics and optimality measures (PyTorch port, subset).

Counterpart: altro_tpu/solver.py (`SolverState`, `SolveStats`,
`init_state`, `stationarity`, `feasibility`, `complementarity`,
`total_cost`). The per-lane `solve` with its strong-Wolfe search is not
ported yet; the batched solve is tile_solver.solve_tiled.

`SolverState` and `SolveStats` hold tensors in either layout: batch-major
([B, ...], the public one) or lane-minor ([..., B], inside the batched
solve); tile_solver converts between them. The measures below take
lane-minor stacks and return one value per lane, [B].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from altro_tpu_torch import cones
from altro_tpu_torch.problem import Problem

__all__ = [
    "SolverState",
    "SolveStats",
    "init_state",
    "stationarity",
    "feasibility",
    "complementarity",
    "total_cost",
]


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Everything that persists across warm-started solves (one lane's
    shapes shown; a batch adds the lane axis)."""

    x: torch.Tensor  # [N+1, n]
    u: torch.Tensor  # [N, m]
    y: torch.Tensor  # [N+1, n]
    z: Tuple[torch.Tensor, ...]  # per-group [N+1, p]
    rho: torch.Tensor  # scalar penalty
    K: torch.Tensor  # [N, m, n]
    d: torch.Tensor  # [N, m]
    P: torch.Tensor  # [N+1, n, n]
    p: torch.Tensor  # [N+1, n]
    reg: torch.Tensor  # scalar Quu regularization in effect

    def map(self, fn) -> "SolverState":
        """Apply fn to every tensor (the duals one by one)."""
        return SolverState(**{
            f.name: (tuple(fn(t) for t in getattr(self, f.name)) if f.name == "z"
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class SolveStats:
    status: torch.Tensor  # int32 SolveStatus
    iterations: torch.Tensor  # int32
    objective_value: torch.Tensor
    merit_value: torch.Tensor
    stationarity: torch.Tensor
    primal_feasibility: torch.Tensor
    complementarity: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    ls_iterations: torch.Tensor  # int32
    dphi: torch.Tensor
    bp_fail_index: torch.Tensor  # int32


def init_state(problem: Problem) -> SolverState:
    """Cold start for one lane (problem.x0 is [n])."""
    N, n, m = problem.N, problem.n, problem.m
    kw = dict(dtype=problem.dtype, device=problem.device)
    return SolverState(
        x=problem.x0[None].repeat(N + 1, 1),
        u=torch.zeros((N, m), **kw),
        y=torch.zeros((N + 1, n), **kw),
        z=problem.init_duals(),
        rho=torch.tensor(1.0, **kw),
        K=torch.zeros((N, m, n), **kw),
        d=torch.zeros((N, m), **kw),
        P=torch.zeros((N + 1, n, n), **kw),
        p=torch.zeros((N + 1, n), **kw),
        reg=torch.tensor(0.0, **kw),
    )


def _lane_max(t):
    """max over every axis but the last (lanes)."""
    return torch.amax(t.reshape(-1, t.shape[-1]), dim=0)


def stationarity(A, B, lx, lu, y):
    """max-norm KKT stationarity residual per lane."""
    N = A.shape[0]
    res_x = lx[:N] + torch.einsum("kijb,kib->kjb", A, y[1:]) - y[:N]
    res_u = lu + torch.einsum("kijb,kib->kjb", B, y[1:])
    res_term = lx[N] - y[N]
    return torch.maximum(
        torch.maximum(_lane_max(torch.abs(res_x)), _lane_max(torch.abs(res_u))),
        _lane_max(torch.abs(res_term)),
    )


def feasibility(problem: Problem, convals):
    """max over knots/groups of ||P_K(c) - c||_inf per lane; convals per
    group [N+1, p, B]."""
    B = problem.x0.shape[-1]
    viol = torch.zeros(B, dtype=problem.dtype, device=problem.device)
    for spec, c_j in zip(problem.constraints, convals):
        v = cones.project(spec.cone, c_j.movedim(1, 0)).movedim(0, 1) - c_j
        masked = torch.where(spec.active[:, None, None], torch.abs(v), torch.zeros_like(v))
        if masked.numel():
            viol = torch.maximum(viol, _lane_max(masked))
    return viol


def complementarity(problem: Problem, convals, z):
    B = problem.x0.shape[-1]
    comp = torch.zeros(B, dtype=problem.dtype, device=problem.device)
    for spec, c_j, z_j in zip(problem.constraints, convals, z):
        cz = torch.abs(c_j * z_j)
        masked = torch.where(spec.active[:, None, None], cz, torch.zeros_like(cz))
        if masked.numel():
            comp = torch.maximum(comp, _lane_max(masked))
    return comp


def total_cost(problem: Problem, x, u):
    """Original objective (no AL terms) per lane."""
    N = problem.N
    ks = torch.arange(N, device=x.device)
    stage = problem.cost.stage_value(ks, x[:N], u)
    return torch.sum(stage, dim=0) + problem.cost.term_value(x[N:])[0]
