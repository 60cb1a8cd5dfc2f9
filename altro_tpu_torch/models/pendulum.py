"""Torque-actuated pendulum (PyTorch port).

Counterpart: altro_tpu/models/pendulum.py::pendulum_continuous, with the
same defaults. State [theta, omega], input [torque]; theta = 0 hanging
down, pi upright.

  omega_dot = u / (m l^2) - g sin(theta) / l - b omega / (m l^2)

`f(x, u)` takes component-first tensors, `x [2, *batch]`, `u [1, *batch]`.
"""

from __future__ import annotations

import torch

MASS = 1.0
LENGTH = 0.5
FRICTION = 0.1
GRAVITY = 9.81


def pendulum_continuous(mass=MASS, length=LENGTH, friction=FRICTION, gravity=GRAVITY):
    ml2 = mass * length * length

    def f(x, u):
        theta, omega = x[0], x[1]
        omega_dot = u[0] / ml2 - gravity * torch.sin(theta) / length - friction * omega / ml2
        return torch.stack([omega, omega_dot])

    return f
