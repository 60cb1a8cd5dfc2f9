"""Batched initial solver state (PyTorch port).

Counterpart: altro_tpu/parallel/batch.py::batch_init_state. The vmapped
solve wrappers of that module are not ported: the batched solve is
tile_solver.solve_tiled.
"""

from __future__ import annotations

from altro_tpu_torch.problem import Problem
from altro_tpu_torch.solver import SolverState, init_state

__all__ = ["batch_init_state"]


def batch_init_state(problem: Problem, batch: int) -> SolverState:
    """SolverState with a leading lane axis [B, ...] (batch-major)."""
    s = init_state(problem)
    return s.map(lambda a: a.expand((batch,) + a.shape).contiguous())
