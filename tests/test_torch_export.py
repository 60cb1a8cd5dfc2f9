"""The port's AOT export (altro_tpu_torch/export.py) against altro_tpu/export.py:
tests/test_export.py's round trips in f64 on the CPU.

The artifact is a `torch.export` program of the warm-started tick
(graph_solve.py's unrolled, masked solve), saved as a `.pt2` file and
loaded back. Over tests/test_export.py's 5 closed-loop ticks (its
problem, options and inputs) the loaded artifact gives JAX's live
`mpc_step` and the port's live `mpc_step` to 1e-8, with equal
iterations.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.export import state_to_arrays as jstate_to_arrays  # noqa: E402
from altro_tpu.mpc import mpc_step as jmpc_step  # noqa: E402
from altro_tpu.options import SolverOptions as JSolverOptions  # noqa: E402
from altro_tpu.solver import init_state as jinit_state  # noqa: E402
from altro_tpu_torch.cones import Cone  # noqa: E402
from altro_tpu_torch.export import (  # noqa: E402
    arrays_to_state,
    call_exported,
    export_mpc_server,
    load_exported,
    save_exported,
    state_to_arrays,
)
from altro_tpu_torch.io.scotty import synthetic_scotty  # noqa: E402
from altro_tpu_torch.models.bicycle import bicycle_continuous  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.mpc import mpc_step  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.problem import ConstraintSpec, Problem, lqr_cost_from_reference  # noqa: E402
from altro_tpu_torch.solver import init_state  # noqa: E402
from test_export import _bicycle_problem as _jproblem  # noqa: E402

F64 = torch.float64
# tests/test_export.py:68-72
LIVE_OPTS = dict(iterations_max=6, use_backtracking_linesearch=True, tol_stationarity=1e-6,
                 tol_primal_feasibility=1e-6, throw_errors=False, penalty_warm_start=True)


def port_problem(N=12, dtype=F64):
    """tests/test_export.py::_bicycle_problem on the port (one lane, CPU)."""
    ref = synthetic_scotty(N=100)
    n, m = 4, 2
    kw = dict(dtype=dtype, device="cpu")
    cost = lqr_cost_from_reference(
        torch.full((N + 1, n), 1e-2, **kw), torch.full((N + 1, m), 1e-3, **kw),
        torch.as_tensor(ref.x[: N + 1], **kw), torch.as_tensor(ref.u[: N + 1], **kw))
    delta_max = 60 * np.pi / 180.0
    steering = ConstraintSpec(
        fn=lambda x, u, k: torch.stack([x[3] - delta_max, -delta_max - x[3]]),
        cone=Cone.NEGATIVE_ORTHANT, dim=2, active=torch.ones(N + 1, dtype=torch.bool),
        label="steering bound")
    return Problem(N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
                   constraints=(steering,), cost=cost, h=torch.full((N,), 0.1, **kw),
                   x0=torch.as_tensor(ref.x[0], **kw)), ref


def test_state_arrays_round_trip():
    """tests/test_export.py:58: the plain-array ABI, JAX's keys in JAX's order."""
    problem, _ = port_problem()
    state = init_state(problem)
    arrays = state_to_arrays(state)
    jproblem, _ = _jproblem()
    assert list(arrays) == list(jstate_to_arrays(jinit_state(jproblem)))
    back = arrays_to_state(arrays)
    for name, value in arrays.items():
        got = getattr(back, name) if not name.startswith("z") else back.z[int(name[1:])]
        assert torch.equal(got, value)


def test_export_round_trip_matches_live_solvers(tmp_path):
    """tests/test_export.py:66-106: 5 closed-loop ticks through the loaded
    artifact, JAX's live `mpc_step` and the port's, on the same numpy
    inputs: u0 to 1e-8 and equal iterations every tick, the carried x, u
    and rho to 1e-8 at the end."""
    problem, ref = port_problem()
    jproblem, _ = _jproblem()
    opts = SolverOptions(**LIVE_OPTS)
    jopts = JSolverOptions(**LIVE_OPTS)
    N, m = problem.N, problem.m

    art = export_mpc_server(problem, opts, batch=None, platforms=("cpu",))
    path = str(tmp_path / "controller.pt2")
    save_exported(art, path)
    srv = load_exported(path)
    assert srv.platforms == ("cpu",)

    jstep = jax.jit(lambda s, xm, xr, ur: jmpc_step(jproblem, s, xm, xr, ur, jopts))
    state_jax = jinit_state(jproblem)
    state_live = init_state(problem)
    state_srv = state_to_arrays(init_state(problem))
    x_meas = np.asarray(ref.x[0]) + 0.01
    for t in range(5):
        x_ref = np.asarray(ref.x[t + 1: t + N + 2])
        u_ref = np.zeros((N + 1, m))
        u_jax, state_jax, stats_jax = jstep(state_jax, jnp.asarray(x_meas), jnp.asarray(x_ref),
                                            jnp.asarray(u_ref))
        args = [torch.as_tensor(a, dtype=F64) for a in (x_meas, x_ref, u_ref)]
        u_live, state_live, stats_live = mpc_step(problem, state_live, *args, opts)
        u_srv, state_srv, stats_srv = call_exported(srv, *args, state_srv)
        np.testing.assert_allclose(u_srv.numpy(), np.asarray(u_jax), rtol=0, atol=1e-8)
        np.testing.assert_allclose(u_srv.numpy(), u_live.numpy(), rtol=0, atol=1e-8)
        assert int(stats_srv["iterations"]) == int(stats_jax.iterations) == int(
            stats_live.iterations)
        assert int(stats_srv["status"]) == int(stats_jax.status)
        x_meas = np.asarray(jproblem.dynamics(jnp.asarray(x_meas), u_jax, jnp.asarray(0.1), 0))
    for f in ("x", "u", "rho"):
        np.testing.assert_allclose(state_srv[f].numpy(), np.asarray(getattr(state_jax, f)),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(state_srv[f].numpy(), getattr(state_live, f).numpy(),
                                   rtol=0, atol=1e-8)
    assert np.isfinite(u_srv.numpy()).all()
