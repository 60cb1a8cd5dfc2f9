"""Column-form and block-form dynamics steps (PyTorch port).

Counterpart: altro_tpu/models/tile_steps.py (`bicycle_cols`,
`midpoint_cols`, `rk4_cols`, `quadrotor_cols`, `block_from_cols`,
`block_step_from_cols`, `midpoint_tile`, `rk4_tile`, `bicycle_tile`,
`quadrotor_tile`, `pendulum_cols`, `pendulum_tile`, `double_integrator_cols`,
`double_integrator_tile`), each with the same expression order as there.

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
    "rk4_cols",
    "rk4_tile",
    "quadrotor_cols",
    "quadrotor_tile",
    "pendulum_cols",
    "pendulum_tile",
    "double_integrator_cols",
    "double_integrator_tile",
]

# Model and integrator codes shared with csrc/device_steps.cuh.
MODEL_BICYCLE = 0
MODEL_QUADROTOR = 1
MODEL_PENDULUM = 2
MODEL_DOUBLE_INTEGRATOR = 3
INTEGRATOR_MIDPOINT = 0
INTEGRATOR_RK4 = 1
INTEGRATOR_DISCRETE = 2  # an exact discrete step: no integrator around the model
BICYCLE_FRAMES = {"cog": 0, "CENTER_OF_GRAVITY": 0, "rear": 1, "REAR": 1,
                  "front": 2, "FRONT": 2}


@dataclasses.dataclass(frozen=True)
class DeviceStep:
    """Names the CUDA `__device__` step that equals a column step."""

    model: int
    integrator: int
    n: int
    m: int
    params: tuple  # model parameters: (frame code, length, rear) for the bicycle,
    # (mass, gravity, arm, kf, km, Jx, Jy, Jz) for the quadrotor, (mass,
    # length, b, g) for the pendulum, none for the double integrator


def _with_device_step(step, f, integrator):
    """Attach the DeviceStep of `integrator` over f's model (None when f
    names no device model)."""
    model = getattr(f, "device_model", None)
    step.device_step = None
    if model is not None:
        code, n, m, params = model
        step.device_step = DeviceStep(code, integrator, n, m, params)
    return step


def midpoint_cols(f):
    """Explicit midpoint on column tuples (== integrators.midpoint)."""

    def step(x, u, h):
        fx = f(x, u)
        xm = tuple(xi + 0.5 * h * fi for xi, fi in zip(x, fx))
        fm = f(xm, u)
        return tuple(xi + h * fi for xi, fi in zip(x, fm))

    return _with_device_step(step, f, INTEGRATOR_MIDPOINT)


def rk4_cols(f):
    """Classic RK4 on column tuples (== integrators.rk4)."""

    def step(x, u, h):
        k1 = f(x, u)
        k2 = f(tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k1)), u)
        k3 = f(tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k2)), u)
        k4 = f(tuple(xi + h * ki for xi, ki in zip(x, k3)), u)
        return tuple(
            xi + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
            for xi, a, b, c, d in zip(x, k1, k2, k3, k4)
        )

    return _with_device_step(step, f, INTEGRATOR_RK4)


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

    return _with_device_step(step, f, INTEGRATOR_MIDPOINT)


def rk4_tile(f):
    """Classic RK4 on [W, n] blocks (== integrators.rk4)."""

    def step(x, u, h):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return _with_device_step(step, f, INTEGRATOR_RK4)


def bicycle_tile(frame="cog", length=2.7, rear=1.5):
    """Block form of models.bicycle.bicycle_continuous (all 3 frames)."""
    return block_from_cols(bicycle_cols(frame, length, rear))


def quadrotor_cols(mass=0.5, gravity=9.81, arm=0.1750, kf=1.0, km=0.0245,
                   inertia=(0.0023, 0.0023, 0.004)):
    """Column form of models.quadrotor.quadrotor_continuous (n=12:
    [pos(3), rpy(3), vel(3), omega(3)], u = 4 rotor thrusts), the same
    scalar expressions on component columns."""
    Jx, Jy, Jz = inertia

    def f(x, u):
        r, p, y = x[3], x[4], x[5]
        vx, vy, vz = x[6], x[7], x[8]
        wx, wy, wz = x[9], x[10], x[11]
        w0, w1, w2, w3 = (kf * u[i] for i in range(4))

        cr, sr = torch.cos(r), torch.sin(r)
        cp, sp = torch.cos(p), torch.sin(p)
        cy, sy = torch.cos(y), torch.sin(y)

        T = (w0 + w1 + w2 + w3) / mass
        ax = (cy * sp * cr + sy * sr) * T
        ay = (sy * sp * cr - cy * sr) * T
        az = cp * cr * T - gravity

        tx = arm * (w1 - w3)
        ty = arm * (w2 - w0)
        tz = km * (w0 - w1 + w2 - w3)
        wdx = (tx - (wy * Jz * wz - wz * Jy * wy)) / Jx
        wdy = (ty - (wz * Jx * wx - wx * Jz * wz)) / Jy
        wdz = (tz - (wx * Jy * wy - wy * Jx * wx)) / Jz

        tp = sp / cp
        rd = wx + sr * tp * wy + cr * tp * wz
        pd = cr * wy - sr * wz
        yd = (sr * wy + cr * wz) / cp

        return (vx, vy, vz, rd, pd, yd, ax, ay, az, wdx, wdy, wdz)

    f.device_model = (MODEL_QUADROTOR, 12, 4,
                      tuple(float(v) for v in (mass, gravity, arm, kf, km, Jx, Jy, Jz)))
    return f


def quadrotor_tile(mass=0.5, gravity=9.81, arm=0.1750, kf=1.0, km=0.0245,
                   inertia=(0.0023, 0.0023, 0.004)):
    """Block form of models.quadrotor.quadrotor_continuous."""
    return block_from_cols(quadrotor_cols(mass, gravity, arm, kf, km, inertia))


def pendulum_cols(mass=1.0, length=0.5, b=0.1, g=9.81):
    """Column form of models.pendulum.pendulum_continuous (JAX's
    expression: alpha = (tau - b omega) / (m l^2) - (g / l) sin(theta))."""

    def f(x, u):
        theta, omega = x[0], x[1]
        tau = u[0]
        alpha = (tau - b * omega) / (mass * length * length) - (g / length) * torch.sin(theta)
        return (omega, alpha)

    f.device_model = (MODEL_PENDULUM, 2, 1, tuple(float(v) for v in (mass, length, b, g)))
    return f


def pendulum_tile(mass=1.0, length=0.5, b=0.1, g=9.81):
    """Block form of models.pendulum.pendulum_continuous;
    midpoint_tile(pendulum_tile(...)) names its device step."""
    return block_from_cols(pendulum_cols(mass, length, b, g))


def double_integrator_cols(dim=2):
    """Column form of models.double_integrator.double_integrator_dynamics.
    That model is an exact discrete step, so this returns step(x, u, h)
    itself, with no integrator around it:
    pos' = pos + vel h + u h^2/2;  vel' = vel + u h.
    At dim=2 it names its device step (`INTEGRATOR_DISCRETE`,
    csrc/device_steps.cuh's DoubleIntegrator); other dims have none."""

    def step(x, u, h):
        b = 0.5 * h * h
        cols = []
        for i in range(dim):
            cols.append(x[i] + x[dim + i] * h + u[i] * b)
        for i in range(dim):
            cols.append(x[dim + i] + u[i] * h)
        return tuple(cols)

    step.device_step = (DeviceStep(MODEL_DOUBLE_INTEGRATOR, INTEGRATOR_DISCRETE, 4, 2, ())
                        if dim == 2 else None)
    return step


def double_integrator_tile(dim=2):
    """Block form of the exact double-integrator discrete step."""
    return block_step_from_cols(double_integrator_cols(dim))
