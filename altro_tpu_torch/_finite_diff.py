"""Central finite differences of a loss of the solution, the check that
`diff.implicit_solve`'s gradients are held to (its tests and
chip_smoke.py's `implicit_grad` phase); not part of the package's API.
All 2 * size solves run as the lanes of one batched solve."""

from __future__ import annotations

import dataclasses

import torch

from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.parallel.batch import solve_lanes
from altro_tpu_torch.problem import problem_leaves, problem_with_leaves
from altro_tpu_torch.solver import SolverState, init_state


def cold_lanes(problems):
    """Single-lane problems of one structure (their data leaves differ) as
    the lanes of one batched solve: (the problem lane-minor, every data
    leaf of `problem.problem_leaves` one row per lane; the state
    lane-minor, each lane's cold start). The batched solve takes any leaf
    per lane."""
    leaves = [torch.stack(lv, dim=-1)
              for lv in zip(*([t for _, t in problem_leaves(p)] for p in problems))]
    states = [init_state(p) for p in problems]
    lanes = {f.name: (tuple(torch.stack(z, dim=-1) for z in zip(*(s.z for s in states)))
                      if f.name == "z" else torch.stack([getattr(s, f.name) for s in states], -1))
             for f in dataclasses.fields(SolverState)}
    return problem_with_leaves(problems[0], leaves), SolverState(**lanes)


def fd_grad(build, theta0: torch.Tensor, loss, opts: SolverOptions, eps: float = 1e-6):
    """Central differences of loss(x*, u*) of the solve of build(theta) in
    every entry of theta0, shaped as theta0."""
    flat = theta0.reshape(-1)
    thetas = []
    for i in range(flat.numel()):
        for s in (1.0, -1.0):
            tp = flat.clone()
            tp[i] += s * eps
            thetas.append(tp.reshape(theta0.shape))
    st, _ = solve_lanes(*cold_lanes([build(th) for th in thetas]), opts)
    vals = torch.stack([loss(st.x[..., b], st.u[..., b]) for b in range(len(thetas))])
    return ((vals[0::2] - vals[1::2]) / (2 * eps)).reshape(theta0.shape)
