"""Explicit integrators: continuous xdot = f(x, u) to discrete
x' = F(x, u, h, k) (PyTorch port).

Counterpart: altro_tpu/models/integrators.py::midpoint. Tensors are
component-first (`x [n, *batch]`); `h` broadcasts against the batch dims.
"""

from __future__ import annotations


def midpoint(f):
    """Midpoint (explicit RK2): x' = x + h f(x + h/2 f(x, u), u)."""

    def step(x, u, h, k):
        xm = x + 0.5 * h * f(x, u)
        return x + h * f(xm, u)

    return step
