"""Column-form and block-form dynamics steps (PyTorch port).

Counterpart: altro_tpu/models/tile_steps.py (`bicycle_cols`,
`midpoint_cols`, `block_from_cols`, `block_step_from_cols`,
`midpoint_tile`, `bicycle_tile`).

* Column form: a function takes tuples of per-component tensors that
  broadcast against each other (one `[B]` lane vector per state
  component in the batched solve) and returns a tuple of components.
* Block form: `step(x [W, n], u [W, m], h [W, 1])` on rows of
  independent trials whose last axis holds the components (the
  single-lane trial rollout). Derived from the column form: components
  come out with `unbind(-1)` and go back with `stack(-1)`.

Each step also names its twin on the card: `device_step`, a `DeviceStep`
that a kernel wrapper (ops/rollout_grid.py, ops/trial_rollout.py) maps
onto a `__device__` step of csrc/device_steps.cuh. A step without one has
no kernel twin, and the kernel paths refuse it.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "DeviceStep",
    "bicycle_cols",
    "midpoint_cols",
    "block_from_cols",
    "block_step_from_cols",
    "midpoint_tile",
    "bicycle_tile",
]

# Model and integrator codes shared with csrc/device_steps.cuh.
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


def block_from_cols(f_cols):
    """Column-form continuous dynamics -> block form f(x [W, n], u [W, m])."""

    def f(x, u):
        return torch.stack(f_cols(x.unbind(-1), u.unbind(-1)), dim=-1)

    f.device_model = getattr(f_cols, "device_model", None)
    return f


def block_step_from_cols(step_cols):
    """Column-form discrete step -> block form step(x, u, h [W, 1])."""

    def step(x, u, h):
        hc = h[..., 0] if torch.is_tensor(h) and h.ndim == x.ndim else h
        return torch.stack(step_cols(x.unbind(-1), u.unbind(-1), hc), dim=-1)

    step.device_step = getattr(step_cols, "device_step", None)
    return step


def midpoint_tile(f):
    """Explicit midpoint on [W, n] blocks (== integrators.midpoint)."""

    def step(x, u, h):
        xm = x + 0.5 * h * f(x, u)
        return x + h * f(xm, u)

    model = getattr(f, "device_model", None)
    step.device_step = None
    if model is not None:
        code, n, m, params = model
        step.device_step = DeviceStep(code, INTEGRATOR_MIDPOINT, n, m, params)
    return step


def bicycle_tile(frame="cog", length=2.7, rear=1.5):
    """Block form of models.bicycle.bicycle_continuous (all 3 frames)."""
    return block_from_cols(bicycle_cols(frame, length, rear))
