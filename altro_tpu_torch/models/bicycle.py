"""Kinematic bicycle model, three reference frames (PyTorch port).

Counterpart: altro_tpu/models/bicycle.py::bicycle_continuous. State
[px, py, theta (heading), delta (steering)], input [v, delta_dot].
`f(x, u)` takes component-first tensors, `x [4, *batch]`, `u [2, *batch]`,
so the same function serves one lane (`[4]`) and a stack of lanes.
"""

from __future__ import annotations

import enum

import torch

LENGTH = 2.7  # wheelbase
REAR = 1.5  # distance CoG -> rear axle


class BicycleFrame(enum.Enum):
    CENTER_OF_GRAVITY = "cog"
    REAR = "rear"
    FRONT = "front"


def bicycle_continuous(frame: BicycleFrame = BicycleFrame.CENTER_OF_GRAVITY,
                       length: float = LENGTH, rear: float = REAR):
    def f(x, u):
        v, delta_dot = u[0], u[1]
        theta, delta = x[2], x[3]
        if frame is BicycleFrame.CENTER_OF_GRAVITY:
            beta = torch.atan2(rear * delta, torch.full_like(delta, length))
            omega = v * torch.cos(beta) * torch.tan(delta) / length
            ang = theta + beta
        elif frame is BicycleFrame.REAR:
            omega = v * torch.tan(delta) / length
            ang = theta
        else:  # FRONT
            omega = v * torch.sin(delta) / length
            ang = theta + delta
        return torch.stack([v * torch.cos(ang), v * torch.sin(ang), omega, delta_dot])

    return f
