"""3-DOF point-mass rocket (PyTorch port).

Counterpart: examples/rocket_landing.py::rocket_continuous (the JAX
package's rocket-landing example; the port keeps its own copy). State
[rx, ry, rz, vx, vy, vz], input the thrust acceleration [ux, uy, uz]:

  r_dot = v,  v_dot = u - (0, 0, g)

`f(x, u)` takes component-first tensors, `x [6, *batch]`, `u [3, *batch]`.
"""

from __future__ import annotations

import torch

GRAVITY = 9.81


def rocket_continuous(gravity=GRAVITY):
    def f(x, u):
        vx, vy, vz = x[3], x[4], x[5]
        return torch.stack([vx, vy, vz, u[0], u[1], u[2] - gravity])

    return f
