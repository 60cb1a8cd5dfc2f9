"""The port's auxiliary modules against tests/test_aux.py's oracles and
the JAX package, in f64: implicit dynamics (`implicit_dynamics`,
`implicit_midpoint_residual`: the Newton step to a zero residual, the
implicit-function Jacobian against JAX's and against finite differences,
one lane and a batch, and the pendulum swing-up through the implicit
midpoint rule held to JAX's solve: test_torch_aux_implicit_solve.py),
checkpoint / resume (`save_state`,
`load_state`: a round trip, a resume equal to the in-memory warm start,
and archives that load in the other package) and the timing harness
(`profiling.time_fn`, `benchmark_solves`, `trace`)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.checkpoint import load_state as jload_state  # noqa: E402
from altro_tpu.checkpoint import save_state as jsave_state  # noqa: E402
from altro_tpu.implicit import implicit_dynamics as jimplicit  # noqa: E402
from altro_tpu.implicit import implicit_midpoint_residual as jres  # noqa: E402
from altro_tpu.models.pendulum import pendulum_continuous as jpendulum  # noqa: E402
from altro_tpu_torch import profiling  # noqa: E402
from altro_tpu_torch.checkpoint import load_state, save_state  # noqa: E402
from altro_tpu_torch.implicit import implicit_dynamics, implicit_midpoint_residual  # noqa: E402
from altro_tpu_torch.models.pendulum import pendulum_continuous  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.solver import init_state, solve  # noqa: E402

X, U, H = [0.3, -0.2], [0.5], 0.05


def _port_implicit():
    f = pendulum_continuous()
    return f, implicit_dynamics(implicit_midpoint_residual(f))


def test_newton_converges_and_matches_jax():
    f, (step, jac) = _port_implicit()
    x, u = torch.tensor(X, dtype=torch.float64), torch.tensor(U, dtype=torch.float64)
    x2 = step(x, u, H, 0)
    assert float((x2 - x - H * f(0.5 * (x + x2), u)).abs().max()) < 1e-12
    jstep, jjac = jimplicit(jres(jpendulum()))
    np.testing.assert_allclose(x2.numpy(), np.asarray(jstep(jnp.asarray(X), jnp.asarray(U), H, 0)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(jac(x, u, H, 0).numpy(),
                               np.asarray(jjac(jnp.asarray(X), jnp.asarray(U), H, 0)),
                               rtol=0, atol=1e-12)


def test_ift_jacobian_matches_finite_differences_batched():
    _, (step, jac) = _port_implicit()
    rng = np.random.default_rng(0)
    xb = torch.as_tensor(rng.standard_normal((2, 5)))
    ub = torch.as_tensor(rng.standard_normal((1, 5)))
    J = jac(xb, ub, H, 0)
    assert J.shape == (2, 3, 5)
    eps = 1e-7
    for i in range(3):
        e = torch.zeros(3, 1, dtype=torch.float64)
        e[i] = eps
        xp, up = xb + e[:2], ub + e[2:]
        xm, um = xb - e[:2], ub - e[2:]
        fd = (step(xp, up, H, 0) - step(xm, um, H, 0)) / (2 * eps)
        np.testing.assert_allclose(J[:, i].numpy(), fd.numpy(), atol=1e-6)
    for b in range(5):
        np.testing.assert_allclose(J[..., b].numpy(), jac(xb[:, b], ub[:, b], H, 0).numpy(),
                                   rtol=0, atol=1e-14)


def _small_solved_state():
    """test_aux.py's `_small_solved_state` in the port: the double
    integrator's goal oracle (tests/test_solver_double_integrator.py)."""
    from altro_tpu_torch.reference_problems import di_goal_constraint, double_integrator_problem

    goal = di_goal_constraint(np.zeros(4), dtype=torch.float64, device="cpu")
    problem = double_integrator_problem([1.0, 2.0, 0.0, 0.0], (goal,), dtype=torch.float64,
                                        device="cpu")
    opts = SolverOptions(penalty_scaling=100.0)
    state, _ = solve(problem, init_state(problem), opts)
    return problem, state, opts


def test_checkpoint_roundtrip_and_resume(tmp_path):
    problem, state, opts = _small_solved_state()
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    restored = load_state(path, device="cpu")
    for f_ in ("x", "u", "y", "K", "d", "P", "p", "rho", "reg"):
        assert torch.equal(getattr(restored, f_), getattr(state, f_)), f_
    for a, b in zip(restored.z, state.z):
        assert torch.equal(a, b)
    s1, st1 = solve(problem, restored, opts)
    s2, st2 = solve(problem, state, opts)
    assert int(st1.iterations) == int(st2.iterations)
    assert torch.equal(s1.x, s2.x)
    assert load_state(path, dtype=torch.float32, device="cpu").x.dtype == torch.float32


def test_checkpoint_archives_cross_packages(tmp_path):
    """An archive the port writes loads in JAX and the other way round."""
    _, state, _ = _small_solved_state()
    path = str(tmp_path / "port.npz")
    save_state(path, state)
    js = jload_state(path)
    np.testing.assert_array_equal(np.asarray(js.K), state.K.numpy())
    jpath = str(tmp_path / "jax.npz")
    jsave_state(jpath, js)
    back = load_state(jpath, device="cpu")
    assert torch.equal(back.x, state.x) and torch.equal(back.z[0], state.z[0])


def test_profiling_harness(tmp_path):
    problem, state, opts = _small_solved_state()
    stats = profiling.benchmark_solves(lambda s: solve(problem, s, opts), state, batch=1, iters=3)
    assert stats["p50_ms"] > 0 and stats["solves_per_s"] > 0 and stats["iters"] == 3
    assert stats["p99_ms"] >= stats["p50_ms"] and stats["batch"] == 1
    with profiling.trace(str(tmp_path / "trace")):
        solve(problem, state, opts)
    assert (tmp_path / "trace" / "trace.json").exists()


def test_load_state_defaults_to_the_card(tmp_path):
    """`load_state` puts the state on the card unless asked otherwise, like
    the port's other entry points; without a card a call that names no
    device raises instead of loading onto the CPU."""
    _, state, _ = _small_solved_state()
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    if torch.cuda.is_available():
        assert load_state(path).x.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_state(path)
    assert load_state(path, device="cpu").x.device.type == "cpu"
