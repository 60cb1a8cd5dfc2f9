"""The C++ reference's small test problems, as the port's solve takes them.

Counterparts: the problem constructors of the JAX package's oracle tests,
each re-hosting a reference test (they live in tests/, so the port keeps
its own copy): tests/test_solver_double_integrator.py (`make_problem`,
`goal_constraint`, `control_bounds`, `soc_control_bound`;
double_integrator_test.cpp), tests/test_pendulum.py (`make_problem`,
`goal_constraint`; pendulum_test.cpp) and tests/test_status_surface.py
(`make_problem`). The Scotty MPC problem is `mpc.scotty_reference_problem`.

Every function here makes its tensors on the card unless `device` says
otherwise. Constraint functions broadcast over trailing batch dims
(component-first, the port's convention).
"""

from __future__ import annotations

import numpy as np
import torch

from altro_tpu_torch.cones import Cone
from altro_tpu_torch.models.double_integrator import double_integrator_dynamics
from altro_tpu_torch.models.integrators import midpoint
from altro_tpu_torch.models.pendulum import pendulum_continuous
from altro_tpu_torch.problem import (
    ConstraintSpec,
    DiagonalCost,
    Problem,
    lqr_cost_from_reference,
)

__all__ = [
    "DI_N",
    "double_integrator_problem",
    "di_goal_constraint",
    "di_control_bounds",
    "di_soc_control_bound",
    "pendulum_problem",
    "pendulum_goal_constraint",
]

DI_N, DI_DIM, DI_H = 10, 2, 0.5  # tf = 5


def _column(v, x):
    """v [p] as [p, 1, ...], broadcasting against x [p, *batch]."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def _mask(N, device, *, terminal):
    """Active knots: the terminal knot only, or every knot but it."""
    act = torch.zeros(N + 1, dtype=torch.bool, device=device)
    if terminal:
        act[N] = True
    else:
        act[:N] = True
    return act


def double_integrator_problem(x0, constraints=(), *, r=1e-2, dtype=torch.float32,
                              device="cuda") -> Problem:
    """The 2D double integrator of double_integrator_test.cpp (N=10, h=0.5,
    Q=1, R=r, no linear terms) from x0."""
    N, n, m = DI_N, 2 * DI_DIM, DI_DIM
    kw = dict(dtype=dtype, device=device)
    cost = DiagonalCost(Q=torch.ones((N + 1, n), **kw), R=torch.full((N + 1, m), r, **kw),
                        q=torch.zeros((N + 1, n), **kw), r=torch.zeros((N + 1, m), **kw),
                        c=torch.zeros(N + 1, **kw))
    return Problem(N=N, n=n, m=m, dynamics=double_integrator_dynamics(DI_DIM),
                   dynamics_jac=None, constraints=tuple(constraints), cost=cost,
                   h=torch.full((N,), DI_H, **kw), x0=torch.as_tensor(x0, **kw))


def di_goal_constraint(xf, *, dtype=torch.float32, device="cuda") -> ConstraintSpec:
    """x_N - xf = 0 (ZERO cone, terminal knot)."""
    xf = torch.as_tensor(xf, dtype=dtype, device=device)
    return ConstraintSpec(fn=lambda x, u, k: x - _column(xf, x), cone=Cone.ZERO,
                          dim=xf.shape[0], active=_mask(DI_N, device, terminal=True),
                          label="goal")


def di_control_bounds(u_bnd: float, *, device="cuda") -> ConstraintSpec:
    """-u_bnd <= u <= u_bnd (NEGATIVE_ORTHANT, every stage knot)."""
    return ConstraintSpec(fn=lambda x, u, k: torch.cat([u - u_bnd, -u_bnd - u]),
                          cone=Cone.NEGATIVE_ORTHANT, dim=2 * DI_DIM,
                          active=_mask(DI_N, device, terminal=False), label="control bounds")


def di_soc_control_bound(u_bnd: float, *, device="cuda") -> ConstraintSpec:
    """||u|| <= u_bnd (SECOND_ORDER, every stage knot)."""
    def fn(x, u, k):
        return torch.cat([u, torch.full((1,) + tuple(u.shape[1:]), u_bnd, dtype=u.dtype,
                                        device=u.device)])
    return ConstraintSpec(fn=fn, cone=Cone.SECOND_ORDER, dim=DI_DIM + 1,
                          active=_mask(DI_N, device, terminal=False), label="soc bound")


def pendulum_problem(N: int, tf: float, constraints=(), q_term_weight: float = 1.0, *,
                     dtype=torch.float32, device="cuda") -> Problem:
    """The pendulum swing-up of pendulum_test.cpp: midpoint, h =
    float32(tf / N) as the reference stores it, from rest hanging down to
    xf = (pi, 0); Q = 1e-2 (terminal q_term_weight), R = 1e-3."""
    n, m = 2, 1
    kw = dict(dtype=dtype, device=device)
    Qd = np.concatenate([np.full((N, n), 1e-2), np.full((1, n), q_term_weight)])
    xf = np.tile(np.array([np.pi, 0.0]), (N + 1, 1))
    cost = lqr_cost_from_reference(torch.as_tensor(Qd, **kw), torch.full((N + 1, m), 1e-3, **kw),
                                   torch.as_tensor(xf, **kw), torch.zeros((N + 1, m), **kw))
    return Problem(N=N, n=n, m=m, dynamics=midpoint(pendulum_continuous()), dynamics_jac=None,
                   constraints=tuple(constraints), cost=cost,
                   h=torch.full((N,), float(np.float32(tf / N)), **kw),
                   x0=torch.zeros(n, **kw))


def pendulum_goal_constraint(N: int, xf=(np.pi, 0.0), *, dtype=torch.float32,
                             device="cuda") -> ConstraintSpec:
    """xf - x_N = 0 (ZERO cone), the reference's form (pendulum_test.cpp:160-172)."""
    xf = torch.as_tensor(xf, dtype=dtype, device=device)
    return ConstraintSpec(fn=lambda x, u, k: _column(xf, x) - x, cone=Cone.ZERO, dim=2,
                          active=_mask(N, device, terminal=True), label="goal")
