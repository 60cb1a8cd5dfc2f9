"""d-dimensional double integrator / point mass (PyTorch port).

Counterpart: altro_tpu/models/double_integrator.py
(`double_integrator_dynamics`, `double_integrator_linear`). Exact
discrete dynamics:

  pos' = pos + vel h + u h^2/2;  vel' = vel + u h.

State [pos(d), vel(d)], input [acc(d)]. The step takes component-first
tensors (`x [2d, *batch]`, `u [d, *batch]`); `h` broadcasts against the
batch dims.
"""

from __future__ import annotations

import numpy as np
import torch


def double_integrator_dynamics(dim: int = 2):
    """Discrete dynamics callable (x, u, h, k) -> x_next."""

    def step(x, u, h, k):
        b = h * h / 2.0
        pos, vel = x[:dim], x[dim:]
        return torch.cat([pos + vel * h + u * b, vel + u * h])

    return step


def double_integrator_linear(dim: int = 2, h: float = 0.1):
    """(A, B) of the exact discrete dynamics (numpy, for problem setup)."""
    n = 2 * dim
    A = np.eye(n)
    B = np.zeros((n, dim))
    b = h * h / 2.0
    for i in range(dim):
        A[i, i + dim] = h
        B[i, i] = b
        B[i + dim, i] = h
    return A, B
