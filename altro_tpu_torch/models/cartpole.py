"""Cart-pole (PyTorch port).

Counterpart: altro_tpu/models/cartpole.py::cartpole_continuous, with the
same defaults and the same expression order. State [x, theta, xdot,
thetadot], input [force]; theta = 0 hanging down, pi upright.

`f(x, u)` takes component-first tensors, `x [4, *batch]`, `u [1, *batch]`.
"""

from __future__ import annotations

import torch


def cartpole_continuous(mass_cart=1.0, mass_pole=0.2, length=0.5, gravity=9.81):
    def f(x, u):
        q, theta, qd, thetad = x[0], x[1], x[2], x[3]
        st, ct = torch.sin(theta), torch.cos(theta)
        mt = mass_cart + mass_pole
        # the standard underactuated-robotics cart-pole equations
        temp = (u[0] + mass_pole * length * thetad**2 * st) / mt
        thetadd = (gravity * st - ct * temp) / (
            length * (4.0 / 3.0 - mass_pole * ct * ct / mt)
        )
        qdd = temp - mass_pole * length * thetadd * ct / mt
        return torch.stack([qd, thetad, qdd, thetadd])

    return f
