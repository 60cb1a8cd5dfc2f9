"""The port's facade (`altro_tpu_torch.api.ALTROSolver`) against altro_tpu's,
on tests/test_api.py's solves.

Each case builds both facades from the same numpy arrays, with each
callable written once in `jnp` and once in `torch`, solves both in f64 on
the CPU, and holds the port to JAX's: status, iterations and
ls_iterations equal; x, u, K, d, the dynamics duals and every constraint
group's duals to 1e-8. The JAX test's own assertions hold on the port's
facade too. The other cases of tests/test_api.py are in
test_torch_api_surface.py and test_torch_api_block_step.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.api import ALTROSolver as JSolver  # noqa: E402
from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.double_integrator import double_integrator_dynamics as jdi  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu_torch import LAST_INDEX, ALTROSolver, Cone, SolverOptions  # noqa: E402
from altro_tpu_torch.models.double_integrator import double_integrator_dynamics  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402

N, DIM = 10, 2
NX, NU = 2 * DIM, DIM
ATOL = 1e-8


def new_solver(lib, horizon=N):
    """An empty facade of either package (the port's in f64 on the CPU)."""
    if lib == "jax":
        return JSolver(horizon)
    return ALTROSolver(horizon, dtype=torch.float64, device="cpu")


def options(lib, **kw):
    return JOpts(**kw) if lib == "jax" else SolverOptions(**kw)


def cone(lib, name):
    return getattr(JCone if lib == "jax" else Cone, name)


def goal_fn(lib, xf=None):
    """x - xf, component-first in the port."""
    xf = np.zeros(NX) if xf is None else np.asarray(xf, float)
    if lib == "jax":
        xj = jnp.asarray(xf)
        return lambda x, u, k: x - xj
    xt = torch.as_tensor(xf)
    return lambda x, u, k: x - xt.reshape((-1,) + (1,) * (x.ndim - 1))


def build_solver(lib, x0, penalty_scaling=100.0, penalty_initial=1.0):
    """tests/test_api.py's build_solver."""
    s = new_solver(lib)
    s.set_dimension(NX, NU)
    s.set_time_step(0.5)
    s.set_explicit_dynamics(jdi(DIM) if lib == "jax" else double_integrator_dynamics(DIM))
    s.set_lqr_cost(np.ones(NX), np.full(NU, 1e-2), np.zeros(NX), np.zeros(NU), 0, LAST_INDEX)
    s.set_initial_state(x0)
    s.set_options(options(lib, penalty_initial=penalty_initial, penalty_scaling=penalty_scaling))
    return s


def both(build):
    """(JAX facade, port facade) from one build function taking the package."""
    return build("jax"), build("torch")


def assert_same_solve(js, ts, atol=ATOL):
    """The port's facade solved as JAX's: statuses, iteration counts, the
    trajectories, gains and duals. ls_iterations is compared unless the
    last iteration's merit gradient was below tol_meritfun_gradient: that
    iteration discards its search (alpha = 0), whose trials then compare
    merits equal to roundoff (dphi(0) near 1e-30), so the count is noise."""
    keys = ("status", "iterations", "ls_iterations")
    if abs(float(js.stats.dphi)) < js._opts.tol_meritfun_gradient:
        keys = keys[:2]
    for k in keys:
        assert int(getattr(ts.stats, k)) == int(getattr(js.stats, k)), k
    for k in ("x", "u", "K", "d", "y"):
        np.testing.assert_allclose(getattr(ts.state, k).numpy(), np.asarray(getattr(js.state, k)),
                                   rtol=0, atol=atol, err_msg=k)
    assert len(ts.state.z) == len(js.state.z)
    for zt, zj in zip(ts.state.z, js.state.z):
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=atol)


def test_goal_constrained_via_api():
    def build(lib):
        s = build_solver(lib, [1.0, 2.0, 0.0, 0.0])
        s.set_constraint(goal_fn(lib), NX, cone(lib, "ZERO"), "goal", N)
        s.initialize()
        return s

    js, ts = both(build)
    assert ts.is_initialized()
    assert js.solve() == ts.solve() == SolveStatus.SUCCESS
    assert_same_solve(js, ts)
    assert ts.get_iterations() == 3
    assert np.linalg.norm(ts.get_state(N)) < 1e-4
    assert ts.get_primal_feasibility() < 1e-4
    assert ts.get_stationarity() < 1e-4
    assert np.isfinite(ts.get_final_objective())
    assert ts.get_solve_time_ms() > 0
    assert ts.get_feedback_gain(0).shape == (NU, NX)
    assert ts.get_feedforward_gain(0).shape == (NU,)
    assert ts.get_dual_dynamics(N).shape == (NX,)
    np.testing.assert_allclose(ts.calc_cost(), js.calc_cost(), rtol=1e-10)


def test_input_bounds_via_api():
    def build(lib):
        s = build_solver(lib, [2.0, 2.0, 0.0, 0.0], penalty_initial=100.0)
        s.set_constraint(goal_fn(lib), NX, cone(lib, "ZERO"), "goal", N)
        s.set_input_bounds(u_lo=[-1.0, -1.0], u_hi=[1.0, 1.0])
        s.initialize()
        return s

    js, ts = both(build)
    assert js.solve() == ts.solve() == SolveStatus.SUCCESS
    assert_same_solve(js, ts)
    assert ts.get_iterations() == 5
    np.testing.assert_allclose(ts.get_input(0), [-1.0, -1.0], atol=1e-4)


def test_state_bounds_via_api():
    v_max = 0.8

    def build(lib):
        s = build_solver(lib, [2.0, 2.0, 0.0, 0.0], penalty_initial=10.0)
        s.set_constraint(goal_fn(lib), NX, cone(lib, "ZERO"), "goal", N)
        s.set_state_bounds(x_lo=[-np.inf, -np.inf, -v_max, -v_max],
                           x_hi=[np.inf, np.inf, v_max, v_max])
        s.initialize()
        return s

    js, ts = both(build)
    assert js.solve() == ts.solve() == SolveStatus.SUCCESS
    assert_same_solve(js, ts)
    xs = np.stack([ts.get_state(k) for k in range(N + 1)])
    assert np.abs(xs[:, 2:]).max() <= v_max + 1e-4
    assert np.linalg.norm(ts.get_state(N)) < 1e-3
    assert ts.get_dual_constraint(0, N).shape == (NX,)
    assert ts.get_dual_constraint(1, 3).shape == (2 * NX,)


def test_generic_cost():
    def build(lib):
        s = new_solver(lib)
        s.set_dimension(NX, NU)
        s.set_time_step(0.5)
        if lib == "jax":
            s.set_explicit_dynamics(jdi(DIM))
            s.set_cost_function(
                stage=lambda x, u, k: 0.5 * jnp.sum(x * x) + 0.5e-2 * jnp.sum(u * u),
                terminal=lambda x: 0.5 * jnp.sum(x * x))
        else:
            s.set_explicit_dynamics(double_integrator_dynamics(DIM))
            s.set_cost_function(
                stage=lambda x, u, k: (0.5 * torch.sum(x * x, dim=0)
                                       + 0.5e-2 * torch.sum(u * u, dim=0)),
                terminal=lambda x: 0.5 * torch.sum(x * x, dim=0))
        s.set_initial_state([1.0, 2.0, 0.0, 0.0])
        s.set_options(options(lib, iterations_max=10))
        s.initialize()
        return s

    js, ts = both(build)
    assert js.solve() == ts.solve() == SolveStatus.SUCCESS
    assert_same_solve(js, ts)
    assert np.linalg.norm(ts.get_state(N)) < np.linalg.norm([1.0, 2.0, 0.0, 0.0])


def test_quadratic_cost_with_cross_term():
    def build(lib):
        s = new_solver(lib)
        s.set_dimension(NX, NU)
        s.set_time_step(0.5)
        s.set_explicit_dynamics(jdi(DIM) if lib == "jax" else double_integrator_dynamics(DIM))
        s.set_quadratic_cost(np.eye(NX), 1e-2 * np.eye(NU), np.full((NU, NX), 1e-3),
                             np.zeros(NX), np.zeros(NU), 0.0, 0, LAST_INDEX)
        s.set_initial_state([1.0, 2.0, 0.0, 0.0])
        s.set_options(options(lib, iterations_max=10))
        s.initialize()
        return s

    js, ts = both(build)
    assert js.solve() == ts.solve() == SolveStatus.SUCCESS
    assert_same_solve(js, ts)


def test_mpc_methods():
    def build(lib):
        s = build_solver(lib, [1.0, 2.0, 0.0, 0.0])
        s.initialize()
        return s

    js, ts = both(build)
    js.solve()
    ts.solve()
    assert_same_solve(js, ts)
    for s in (js, ts):
        x1 = s.get_state(1)
        s.update_linear_costs(q=np.full(NX, 0.1), k_start=0, k_stop=LAST_INDEX)
        s.set_initial_state(x1)
        s.shift_trajectory()
        np.testing.assert_allclose(s.get_state(0), x1, atol=1e-12)
    np.testing.assert_allclose(ts.problem.cost.q.numpy(), np.asarray(js.problem.cost.q),
                               rtol=0, atol=0)
    assert js.solve() == ts.solve()
    assert ts.get_status() in (SolveStatus.SUCCESS, SolveStatus.MAX_ITERATIONS)
    assert_same_solve(js, ts)
