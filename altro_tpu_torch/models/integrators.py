"""Explicit integrators: continuous xdot = f(x, u) to discrete
x' = F(x, u, h, k) (PyTorch port).

Counterpart: altro_tpu/models/integrators.py (`midpoint`, `rk4`). Tensors
are component-first (`x [n, *batch]`); `h` broadcasts against the batch
dims.
"""

from __future__ import annotations


def midpoint(f):
    """Midpoint (explicit RK2): x' = x + h f(x + h/2 f(x, u), u)."""

    def step(x, u, h, k):
        xm = x + 0.5 * h * f(x, u)
        return x + h * f(xm, u)

    return step


def rk4(f):
    """Classic RK4."""

    def step(x, u, h, k):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    return step
