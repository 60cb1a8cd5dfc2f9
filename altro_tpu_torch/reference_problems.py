"""The C++ reference's small test problems, as the port's solve takes them.

Counterparts: the problem constructors of the JAX package's oracle tests,
each re-hosting a reference test (they live in tests/, so the port keeps
its own copy): tests/test_solver_double_integrator.py (`make_problem`,
`goal_constraint`, `control_bounds`, `soc_control_bound`;
double_integrator_test.cpp), tests/test_pendulum.py (`make_problem`,
`goal_constraint`; pendulum_test.cpp) and tests/test_status_surface.py
(`make_problem`), and the rocket landing of examples/rocket_landing.py
(`build_problem`), whose three second-order-cone groups, min-thrust
orthant row and touchdown equality the SOC rows of scripts/bench_all.py
solve. The Scotty MPC problem is `mpc.scotty_reference_problem`.

The differentiable solve's and the vmapped rescue's oracles have theirs
here too: tests/test_diff.py's problems (`_di_problem`,
`_pendulum_problem` with its `rebuilt`, the control-bounded `build`) as
functions of the data their gradients are taken in (`diff_di_problem`,
`diff_pendulum_problem`, `diff_bounded_problem`), and tests/
test_rescue.py's (`_problem`, `_batch`, `OPTS`: `rescue_pendulum_problem`,
`rescue_pendulum_batch`, `rescue_pendulum_options`).

A problem with every leaf per lane is made here too: the fleet
of double integrators (`fleet_arrays`, `fleet_problem`,
`fleet_options`), each lane with its own linear dynamics, QuadraticCost
and control-bound mask, the data JAX's `prob_axes` / `jax.vmap` batch
leaf by leaf; numpy arrays from a seed, so both packages solve the same
numbers.

The single-lane rows of scripts/bench_all.py and the JAX package's
cart-pole oracle have theirs here too: `cartpole_swingup_problem`
(tests/test_models_extra.py::test_cartpole_swing_up),
`double_integrator_goal_problem` (`double_integrator_goal_N100`,
bench_all.py:100-118) and `pendulum_bounded_problem`
(`pendulum_swingup_bounded`, :120-141); the row
`bicycle_scotty_window_N30` solves `mpc.scotty_reference_problem`.

Every function here makes its tensors on the card unless `device` says
otherwise. Constraint functions broadcast over trailing batch dims
(component-first, the port's convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from altro_tpu_torch.cones import Cone
from altro_tpu_torch.convert import problem_from_numpy
from altro_tpu_torch.models.cartpole import cartpole_continuous
from altro_tpu_torch.models.double_integrator import double_integrator_dynamics
from altro_tpu_torch.models.integrators import midpoint, rk4
from altro_tpu_torch.models.pendulum import pendulum_continuous
from altro_tpu_torch.models.rocket import GRAVITY, rocket_continuous
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import (
    ConstraintSpec,
    DiagonalCost,
    Problem,
    lqr_cost_from_reference,
)
from altro_tpu_torch.solver import init_state

__all__ = [
    "DI_N",
    "double_integrator_problem",
    "di_goal_constraint",
    "di_control_bounds",
    "di_soc_control_bound",
    "pendulum_problem",
    "pendulum_goal_constraint",
    "rocket_landing_problem",
    "cartpole_swingup_problem",
    "double_integrator_goal_problem",
    "pendulum_bounded_problem",
    "DIFF_TIGHT",
    "diff_di_start",
    "diff_di_problem",
    "diff_pendulum_problem",
    "diff_bounded_problem",
    "rescue_pendulum_problem",
    "rescue_pendulum_batch",
    "rescue_pendulum_options",
    "FLEET_LEAVES",
    "fleet_arrays",
    "fleet_bound",
    "fleet_problem",
    "fleet_options",
]

DI_N, DI_DIM, DI_H = 10, 2, 0.5  # tf = 5


def _column(v, x):
    """v [p] as [p, 1, ...] in x's dtype and device, broadcasting against
    x [p, *batch]."""
    return v.to(dtype=x.dtype, device=x.device).reshape((-1,) + (1,) * (x.ndim - 1))


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


def rocket_landing_problem(N: int = 60, tf: float = 6.0, *, theta_max_deg: float = 25.0,
                           gamma_deg: float = 45.0, u_max: float = 20.0, u_min: float = 2.0,
                           dtype=torch.float32, device="cuda"):
    """examples/rocket_landing.py::build_problem: the 3-DOF rocket
    (midpoint, h = tf / N) from x0 = (20, -10, 50, 1, 2, -8) to rest at the
    pad, Q = (1e-2 x 3, 1e-1 x 3) (terminal x 10), R = 1e-1 about hover,
    and five constraint groups: the thrust pointing cone ||(ux, uy)|| <=
    tan(theta_max) uz and the thrust ball ||u|| <= u_max (SECOND_ORDER,
    stage knots), u_min - uz <= 0 (NEGATIVE_ORTHANT, stage knots), the
    glide slope ||(rx, ry)|| <= tan(gamma) rz (SECOND_ORDER, every knot)
    and the touchdown x_N = 0 (ZERO, the terminal knot). Returns (problem,
    hover input [3])."""
    n, m = 6, 3
    kw = dict(dtype=dtype, device=device)
    h = tf / N
    xf = torch.zeros(n, **kw)
    hover = torch.tensor([0.0, 0.0, GRAVITY], **kw)
    Qd = np.tile(np.concatenate([np.full(3, 1e-2), np.full(3, 1e-1)]), (N + 1, 1))
    Qd[N] *= 10.0
    cost = lqr_cost_from_reference(torch.as_tensor(Qd, **kw), torch.full((N + 1, m), 1e-1, **kw),
                                   xf.expand(N + 1, n), hover.expand(N + 1, m))
    tan_th = float(np.tan(np.deg2rad(theta_max_deg)))
    tan_ga = float(np.tan(np.deg2rad(gamma_deg)))
    stage = _mask(N, device, terminal=False)
    every = torch.ones(N + 1, dtype=torch.bool, device=device)
    terminal = _mask(N, device, terminal=True)
    constraints = (
        ConstraintSpec(fn=lambda x, u, k: torch.stack([u[0], u[1], tan_th * u[2]]),
                       cone=Cone.SECOND_ORDER, dim=3, active=stage,
                       label="thrust pointing cone"),
        ConstraintSpec(fn=lambda x, u, k: torch.stack(
            [u[0], u[1], u[2], torch.full_like(u[2], u_max)]),
            cone=Cone.SECOND_ORDER, dim=4, active=stage, label="max thrust"),
        ConstraintSpec(fn=lambda x, u, k: torch.stack([u_min - u[2]]),
                       cone=Cone.NEGATIVE_ORTHANT, dim=1, active=stage, label="min thrust"),
        ConstraintSpec(fn=lambda x, u, k: torch.stack([x[0], x[1], tan_ga * x[2]]),
                       cone=Cone.SECOND_ORDER, dim=3, active=every, label="glide slope"),
        ConstraintSpec(fn=lambda x, u, k: x - _column(xf, x), cone=Cone.ZERO, dim=n,
                       active=terminal, label="touchdown"),
    )
    problem = Problem(N=N, n=n, m=m, dynamics=midpoint(rocket_continuous()), dynamics_jac=None,
                      constraints=constraints, cost=cost, h=torch.full((N,), h, **kw),
                      x0=torch.tensor([20.0, -10.0, 50.0, 1.0, 2.0, -8.0], **kw))
    return problem, hover


def cartpole_swingup_problem(N: int = 100, *, dtype=torch.float32, device="cuda"):
    """tests/test_models_extra.py::test_cartpole_swing_up: the cart-pole
    (rk4, h = 0.05) from rest hanging down to xf = (0, pi, 0, 0), Q = 1e-2
    (terminal (10, 400, 10, 10)), R = 1e-3, no constraints. Returns
    (problem, state) with u = 0.2 at every knot."""
    n, m = 4, 1
    kw = dict(dtype=dtype, device=device)
    xf = np.array([0.0, np.pi, 0.0, 0.0])
    Qd = np.tile(np.full(n, 1e-2), (N + 1, 1))
    Qd[N] = [10.0, 400.0, 10.0, 10.0]
    cost = lqr_cost_from_reference(torch.as_tensor(Qd, **kw), torch.full((N + 1, m), 1e-3, **kw),
                                   torch.as_tensor(np.tile(xf, (N + 1, 1)), **kw),
                                   torch.zeros((N + 1, m), **kw))
    problem = Problem(N=N, n=n, m=m, dynamics=rk4(cartpole_continuous()), dynamics_jac=None,
                      constraints=(), cost=cost, h=torch.full((N,), 0.05, **kw),
                      x0=torch.zeros(n, **kw))
    st = init_state(problem)
    return problem, dataclasses.replace(st, u=torch.full((N, m), 0.2, **kw))


def double_integrator_goal_problem(N: int = 100, *, dtype=torch.float32, device="cuda"):
    """`double_integrator_goal_N100` (bench_all.py:100-118): the 2D double
    integrator, h = 0.05, from x0 = (1, 2, 0, 0) to the origin, Q = 1,
    R = 1e-2, the goal x_N = 0 (ZERO cone, terminal knot). Returns
    (problem, state), the state at init_state's zeros."""
    n, m = 2 * DI_DIM, DI_DIM
    kw = dict(dtype=dtype, device=device)
    cost = lqr_cost_from_reference(torch.ones((N + 1, n), **kw),
                                   torch.full((N + 1, m), 1e-2, **kw),
                                   torch.zeros((N + 1, n), **kw), torch.zeros((N + 1, m), **kw))
    xf = torch.zeros(n, **kw)
    goal = ConstraintSpec(fn=lambda x, u, k: x - _column(xf, x), cone=Cone.ZERO, dim=n,
                          active=_mask(N, device, terminal=True), label="goal")
    problem = Problem(N=N, n=n, m=m, dynamics=double_integrator_dynamics(DI_DIM),
                      dynamics_jac=None, constraints=(goal,), cost=cost,
                      h=torch.full((N,), 0.05, **kw),
                      x0=torch.tensor([1.0, 2.0, 0.0, 0.0], **kw))
    return problem, init_state(problem)


def pendulum_bounded_problem(N: int = 50, u_bound: float = 8.0, *, dtype=torch.float32,
                             device="cuda"):
    """`pendulum_swingup_bounded` (bench_all.py:120-141): the pendulum
    swing-up of `pendulum_problem` (tf = 3, terminal Q = 1) with the torque
    bound |u| <= u_bound as two NEGATIVE_ORTHANT rows on every stage knot.
    Returns (problem, state) with u = 0.1 at every knot."""
    torque = ConstraintSpec(fn=lambda x, u, k: torch.cat([u - u_bound, -u_bound - u]),
                            cone=Cone.NEGATIVE_ORTHANT, dim=2,
                            active=_mask(N, device, terminal=False), label="torque bound")
    problem = pendulum_problem(N, 3.0, (torque,), dtype=dtype, device=device)
    st = init_state(problem)
    return problem, dataclasses.replace(st, u=torch.full_like(st.u, 0.1))


# tests/test_diff.py's options of its pendulum and control-bounded cases
DIFF_TIGHT = dict(tol_stationarity=1e-9, tol_primal_feasibility=1e-9)
_DIFF_N, _DIFF_H = 10, 0.1


def diff_di_start(*, dtype=torch.float64, device="cuda"):
    """(q[0], x0) of tests/test_diff.py's `_di_problem()`: (-1, -0.5, 0, 0)
    and (1, 2, 0, 0)."""
    kw = dict(dtype=dtype, device=device)
    return torch.tensor([-1.0, -0.5, 0.0, 0.0], **kw), torch.tensor([1.0, 2.0, 0.0, 0.0], **kw)


def diff_di_problem(q_row0, x0) -> Problem:
    """tests/test_diff.py's `_di_problem` (the planar double integrator,
    N=10, h=0.1, Q=(1, 1, 0.1, 0.1), R=1e-2, q=(-1, -0.5, 0, 0)) with q[0]
    and x0 given: tensors on one device and dtype, so gradients flow into
    them."""
    N, n, m = _DIFF_N, 4, 2
    kw = dict(dtype=x0.dtype, device=x0.device)
    q_rest, _ = diff_di_start(**kw)
    cost = DiagonalCost(Q=torch.tensor([1.0, 1.0, 0.1, 0.1], **kw).repeat(N + 1, 1),
                        R=torch.full((N + 1, m), 1e-2, **kw),
                        q=torch.cat([q_row0[None], q_rest.repeat(N, 1)]),
                        r=torch.zeros((N + 1, m), **kw), c=torch.zeros(N + 1, **kw))
    return Problem(N=N, n=n, m=m, dynamics=double_integrator_dynamics(), dynamics_jac=None,
                   constraints=(), cost=cost, h=torch.full((N,), _DIFF_H, **kw), x0=x0)


def diff_pendulum_problem(Qd) -> Problem:
    """tests/test_diff.py's near-upright pendulum (`_pendulum_problem`,
    N=20, h=0.05, terminal Q=(30, 30), R=0.1, goal (pi, 0), from
    (pi - 0.4, 0.3)) with stage weights Qd [2] (its `rebuilt(Qd)`: q and c
    of the goal cost follow Qd); on Qd's device and dtype."""
    N, n, m = 20, 2, 1
    kw = dict(dtype=Qd.dtype, device=Qd.device)
    Q = torch.cat([Qd.expand(N, n), torch.tensor([[30.0, 30.0]], **kw)])
    xg = torch.tensor([np.pi, 0.0], **kw)
    cost = DiagonalCost(Q=Q, R=torch.full((N + 1, m), 1e-1, **kw), q=-Q * xg,
                        r=torch.zeros((N + 1, m), **kw), c=0.5 * torch.sum(Q * xg * xg, dim=1))
    return Problem(N=N, n=n, m=m, dynamics=midpoint(pendulum_continuous()), dynamics_jac=None,
                   constraints=(), cost=cost, h=torch.full((N,), 0.05, **kw),
                   x0=torch.tensor([np.pi - 0.4, 0.3], **kw))


def diff_bounded_problem(q_row0, u_bnd: float = 0.5) -> Problem:
    """tests/test_diff.py's control-bounded double integrator (`build`):
    `diff_di_problem` from its x0 with |u| <= u_bnd at every stage knot."""
    _, x0 = diff_di_start(dtype=q_row0.dtype, device=q_row0.device)
    prob = diff_di_problem(q_row0, x0)
    bound = ConstraintSpec(fn=lambda x, u, k: torch.cat([u - u_bnd, -u_bnd - u]),
                           cone=Cone.NEGATIVE_ORTHANT, dim=4,
                           active=_mask(prob.N, q_row0.device, terminal=False))
    return dataclasses.replace(prob, constraints=(bound,))


_RESCUE_N = 30


def rescue_pendulum_problem(*, dtype=torch.float64, device="cuda") -> Problem:
    """tests/test_rescue.py's `_problem()`: the pendulum swing-up (midpoint,
    N=30, h=0.06) to (pi, 0) with |torque| <= 6 (affine rows on u)."""
    N, n, m = _RESCUE_N, 2, 1
    kw = dict(dtype=dtype, device=device)
    Qd = torch.full((N + 1, n), 1e-1, **kw)
    Qd[N] *= 100.0
    torque = ConstraintSpec(fn=lambda x, u, k: torch.cat([u - 6.0, -6.0 - u]),
                            cone=Cone.NEGATIVE_ORTHANT, dim=2,
                            active=_mask(N, device, terminal=False), label="torque",
                            diag_hessian=True, affine=True)
    cost = lqr_cost_from_reference(Qd, torch.full((N + 1, m), 1e-3, **kw),
                                   torch.tensor([np.pi, 0.0], **kw).repeat(N + 1, 1),
                                   torch.zeros((N + 1, m), **kw))
    return Problem(N=N, n=n, m=m, dynamics=midpoint(pendulum_continuous()), dynamics_jac=None,
                   constraints=(torque,), cost=cost, h=torch.full((N,), 0.06, **kw),
                   x0=torch.zeros(n, **kw))


def rescue_pendulum_batch(problem: Problem, lanes: int = 8):
    """tests/test_rescue.py's `_batch` at `lanes` lanes: (x0 [B, 2], state
    [B, ...]), the first half at the upright equilibrium with zero torque
    (converges at once), the second hanging with a poor guess (u = 0.1)."""
    kw = dict(dtype=problem.dtype, device=problem.device)
    half = lanes // 2
    x0 = torch.cat([torch.tensor([np.pi, 0.0], **kw).expand(half, 2),
                    torch.zeros((lanes - half, 2), **kw)])
    st = init_state(problem)
    u = torch.cat([torch.zeros((half,) + tuple(st.u.shape), **kw),
                   torch.full((lanes - half,) + tuple(st.u.shape), 0.1, **kw)])
    state = st.map(lambda a: a.expand((lanes,) + tuple(a.shape)).contiguous())
    return x0, dataclasses.replace(state, u=u)


def rescue_pendulum_options() -> SolverOptions:
    """tests/test_rescue.py's `OPTS`: a budget of 3, the phase-split
    Armijo-only grid of 8."""
    return SolverOptions(
        iterations_max=3, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
        throw_errors=False, use_backtracking_linesearch=True, parallel_linesearch=True,
        ls_phase_split=True, ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8)


# the fleet's per-lane leaves (arrays of `fleet_arrays`)
FLEET_LEAVES = ("A", "B", "f_aff", "Q", "R", "H", "q", "r", "c", "active")
FLEET_U_MAX = 2.0  # binds on 57.5% of fleet_arrays(1024)'s lanes


def fleet_arrays(B: int, *, N: int = 30, h: float = 0.1, seed: int = 0) -> dict:
    """A fleet of B planar double integrators (n=4: position, velocity;
    m=2: force), each lane its own data, batch-major numpy ([B, ...]):

    * linear dynamics with the lane's mass M (0.5-1.5), linear drag D
      (0-0.5) and constant wind force w: p' = p + h v + h^2 / (2M) (u + w),
      v' = (1 - h D / M) v + h / M (u + w); A [B, N, 4, 4], B [B, N, 4, 2],
      f_aff [B, N, 4] (the wind's term);
    * a QuadraticCost 0.5 (x - g)'Q(x - g) + (x - g)'H'u + 0.5 u'Ru to the
      lane's goal g (a position, at rest), from a random positive definite
      [[Q, H'], [H, R]] per lane (terminal Q ten times the stage's, no H
      there): Q, R, H, q = -Q g, r = -H g, c = 0.5 g'Qg;
    * x0 [B, 4] and the mask of the control bound |u_i| <= FLEET_U_MAX
      (`fleet_bound`), active from the lane's first knot s in 0..3 to
      N - 1, and nowhere on one lane in eight: active [1, B, N+1] (one
      group).
    """
    rng = np.random.default_rng(seed)
    n, m = 4, 2
    mass = 0.5 + rng.random(B)
    drag = 0.5 * rng.random(B)
    wind = 0.3 * rng.standard_normal((B, 2))
    A = np.tile(np.eye(n), (B, 1, 1))
    A[:, 0, 2] = A[:, 1, 3] = h
    A[:, 2, 2] = A[:, 3, 3] = 1.0 - h * drag / mass
    Bm = np.zeros((B, n, m))
    Bm[:, 0, 0] = Bm[:, 1, 1] = h * h / (2.0 * mass)
    Bm[:, 2, 0] = Bm[:, 3, 1] = h / mass
    f = np.einsum("bij,bj->bi", Bm, wind)
    L = 0.1 * rng.standard_normal((B, n + m, n + m))
    W = L @ L.transpose(0, 2, 1) + np.diag([1.0, 1.0, 0.1, 0.1, 1e-2, 1e-2])
    Qs, Rs, Hs = W[:, :n, :n], W[:, n:, n:], W[:, n:, :n]
    Q = np.repeat(Qs[:, None], N + 1, axis=1)
    Q[:, N] *= 10.0
    R = np.repeat(Rs[:, None], N + 1, axis=1)
    H = np.repeat(Hs[:, None], N + 1, axis=1)
    H[:, N] = 0.0
    goal = np.concatenate([rng.uniform(-1.0, 1.0, (B, 2)), np.zeros((B, 2))], axis=1)
    q = -np.einsum("bkij,bj->bki", Q, goal)
    r = -np.einsum("bkij,bj->bki", H, goal)
    c = 0.5 * np.einsum("bi,bkij,bj->bk", goal, Q, goal)
    x0 = np.concatenate([rng.uniform(-2.0, 2.0, (B, 2)), 0.5 * rng.standard_normal((B, 2))],
                        axis=1)
    first = rng.integers(0, 4, size=B)
    k = np.arange(N + 1)
    active = (k[None] >= first[:, None]) & (k[None] < N) & (rng.random(B) >= 0.125)[:, None]
    rep = lambda a: np.repeat(a[:, None], N, axis=1)  # noqa: E731
    return dict(A=rep(A), B=rep(Bm), f_aff=rep(f), Q=Q, R=R, H=H, q=q, r=r, c=c,
                h=np.full((B, N), h), x0=x0, active=active[None])


def fleet_bound(N: int, *, device="cuda") -> ConstraintSpec:
    """The fleet's control bound |u_i| <= FLEET_U_MAX: one affine
    NEGATIVE_ORTHANT group of 4 rows (its mask is the problem's leaf)."""
    return ConstraintSpec(fn=lambda x, u, k: torch.cat([u - FLEET_U_MAX, -FLEET_U_MAX - u]),
                          cone=Cone.NEGATIVE_ORTHANT, dim=4,
                          active=_mask(N, device, terminal=False), label="control_bound",
                          diag_hessian=True, affine=True)


def fleet_problem(arrays: dict, *, batched=FLEET_LEAVES, lane: int = 0, dtype=torch.float32,
                  device="cuda") -> Problem:
    """The fleet's problem from `fleet_arrays`: the leaves in `batched`
    one row per lane (lane-minor), every other leaf lane `lane`'s, shared;
    x0 [n, B] always."""
    N = arrays["A"].shape[1]
    data = {k: (v if k in batched or k == "x0" else v[:, lane] if k == "active" else v[lane])
            for k, v in arrays.items()}
    return problem_from_numpy(data, N=N, n=4, m=2, dynamics=None,
                              constraints=(fleet_bound(N, device=device),),
                              batched=tuple(batched) + ("x0",), dtype=dtype, device=device)


def fleet_options():
    """The fleet's options, at the bench's tolerances (1e-3: the default
    1e-4 stationarity lies under float32's floor, where JAX's own f32
    solve of the fleet ends 63 of 1,024 lanes LINE_SEARCH_FAILED): (the
    vmapped solve's, with `pallas_backward` under the default strong-Wolfe
    search; `solve_tiled`'s, the phase-split x-only Armijo-only grid with
    the plain grid: linear dynamics have no column-form step)."""
    tol = dict(tol_stationarity=1e-3, tol_primal_feasibility=1e-3)
    lanes = SolverOptions(pallas_backward=True, **tol)
    tiled = SolverOptions(use_backtracking_linesearch=True, parallel_linesearch=True,
                          ls_phase_split=True, ls_grid_x_only=True, ls_armijo_only=True,
                          pallas_rollout_tiled=False, **tol)
    return lanes, tiled
