"""Planar-attitude 3D quadrotor (PyTorch port).

Counterpart: altro_tpu/models/quadrotor.py::quadrotor_continuous, the
scalar form with the same defaults. State [pos(3), rpy(3), vel(3),
omega(3)] with Euler roll-pitch-yaw attitude, input the 4 rotor thrusts.
`f(x, u)` takes component-first tensors, `x [12, *batch]`, `u [4, *batch]`,
so the same function serves one lane and a stack of lanes; its Jacobians
come from `problem.lane_jacobian` (forward mode over the 16 directions).
"""

from __future__ import annotations

import torch


def quadrotor_continuous(mass=0.5, gravity=9.81, arm=0.1750, kf=1.0, km=0.0245,
                         inertia=(0.0023, 0.0023, 0.004)):
    Jx, Jy, Jz = inertia

    def f(x, u):
        # [pos(0:3), rpy(3:6), vel(6:9), omega(9:12)]
        r, p, y = x[3], x[4], x[5]
        vx, vy, vz = x[6], x[7], x[8]
        wx, wy, wz = x[9], x[10], x[11]
        w0, w1, w2, w3 = kf * u[0], kf * u[1], kf * u[2], kf * u[3]

        cr, sr = torch.cos(r), torch.sin(r)
        cp, sp = torch.cos(p), torch.sin(p)
        cy, sy = torch.cos(y), torch.sin(y)

        # acc = [0, 0, -g] + R_zyx @ [0, 0, T] / mass (third column of R)
        T = (w0 + w1 + w2 + w3) / mass
        ax = (cy * sp * cr + sy * sr) * T
        ay = (sy * sp * cr - cy * sr) * T
        az = cp * cr * T - gravity

        # torque - omega x (J omega), J diagonal
        tx = arm * (w1 - w3)
        ty = arm * (w2 - w0)
        tz = km * (w0 - w1 + w2 - w3)
        wdx = (tx - (wy * Jz * wz - wz * Jy * wy)) / Jx
        wdy = (ty - (wz * Jx * wx - wx * Jz * wz)) / Jy
        wdz = (tz - (wx * Jy * wy - wy * Jx * wx)) / Jz

        # rpy_dot = E(r, p) @ omega (ZYX Euler rate matrix)
        tp = sp / cp
        rd = wx + sr * tp * wy + cr * tp * wz
        pd = cr * wy - sr * wz
        yd = (sr * wy + cr * wz) / cp

        return torch.stack([vx, vy, vz, rd, pd, yd, ax, ay, az, wdx, wdy, wdz])

    return f
