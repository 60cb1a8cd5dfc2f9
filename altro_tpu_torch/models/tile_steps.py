"""Column-form dynamics steps (PyTorch port).

Counterpart: altro_tpu/models/tile_steps.py (`bicycle_cols`,
`midpoint_cols`). A column-form function takes tuples of per-component
tensors that broadcast against each other (one `[B]` lane vector per
state component in the port) and returns a tuple of components.

Each step also names its twin on the card: `device_step`, a `DeviceStep`
that the rollout kernel's wrapper (ops/rollout_grid.py) maps onto the
`__device__` step of csrc/rollout_grid.cu. A column step without one has
no kernel twin, and the kernel path refuses it.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceStep", "bicycle_cols", "midpoint_cols"]

# Model and integrator codes shared with csrc/rollout_grid.cu.
MODEL_BICYCLE = 0
INTEGRATOR_MIDPOINT = 0
BICYCLE_FRAMES = {"cog": 0, "CENTER_OF_GRAVITY": 0, "rear": 1, "REAR": 1,
                  "front": 2, "FRONT": 2}


@dataclasses.dataclass(frozen=True)
class DeviceStep:
    """Names the CUDA `__device__` step that equals a column step."""

    model: int
    integrator: int
    n: int
    m: int
    params: tuple  # model parameters, e.g. (frame code, length, rear)


def midpoint_cols(f):
    """Explicit midpoint on column tuples (== integrators.midpoint)."""

    def step(x, u, h):
        fx = f(x, u)
        xm = tuple(xi + 0.5 * h * fi for xi, fi in zip(x, fx))
        fm = f(xm, u)
        return tuple(xi + h * fi for xi, fi in zip(x, fm))

    model = getattr(f, "device_model", None)
    if model is not None:
        code, n, m, params = model
        step.device_step = DeviceStep(code, INTEGRATOR_MIDPOINT, n, m, params)
    return step


def bicycle_cols(frame="cog", length=2.7, rear=1.5):
    """Column form of models.bicycle.bicycle_continuous (all 3 frames).

    cos/sin of the slip angle beta = atan(rear*delta/length) come from the
    triangle identity, as in the JAX twin, so the kernel's step and this
    one compute the same expression."""
    frame_code = BICYCLE_FRAMES[frame]

    def f(x, u):
        v, delta_dot = u[0], u[1]
        theta, delta = x[2], x[3]
        if frame_code == 0:
            rd = rear * delta
            inv_hyp = torch.rsqrt(length * length + rd * rd)
            cosb = length * inv_hyp
            sinb = rd * inv_hyp
            ct, st = torch.cos(theta), torch.sin(theta)
            cos_ang = ct * cosb - st * sinb
            sin_ang = st * cosb + ct * sinb
            omega = v * cosb * torch.tan(delta) / length
        elif frame_code == 1:
            omega = v * torch.tan(delta) / length
            cos_ang, sin_ang = torch.cos(theta), torch.sin(theta)
        else:
            omega = v * torch.sin(delta) / length
            ang = theta + delta
            cos_ang, sin_ang = torch.cos(ang), torch.sin(ang)
        return (v * cos_ang, v * sin_ang, omega, delta_dot)

    f.device_model = (MODEL_BICYCLE, 4, 2, (frame_code, float(length), float(rear)))
    return f
