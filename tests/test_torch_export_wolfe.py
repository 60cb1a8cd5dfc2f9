"""The exported tick under the default SolverOptions(): the strong-Wolfe
cubic search (altro_tpu/linesearch.py:171) in the artifact, one lane, in
f64 on the CPU against JAX's live `mpc_step` and the port's.

tests/test_export.py's problem over 5 closed-loop ticks, its options
with the default search: the loaded artifact gives JAX's u0, x, u and
rho to 1e-8 and the port's live tick to 1e-8, with iterations,
ls_iterations and statuses equal, and at least one tick's search goes
past its first trial. The graph runs the live machine's own pass
(`linesearch.lanes_pass`), not a copy of it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.mpc import mpc_step as jmpc_step  # noqa: E402
from altro_tpu.options import SolverOptions as JSolverOptions  # noqa: E402
from altro_tpu.solver import init_state as jinit_state  # noqa: E402
from altro_tpu_torch import graph_solve, linesearch  # noqa: E402
from altro_tpu_torch.export import (  # noqa: E402
    call_exported,
    export_mpc_server,
    load_exported,
    save_exported,
    state_to_arrays,
)
from altro_tpu_torch.mpc import mpc_step  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.solver import init_state  # noqa: E402
from test_export import _bicycle_problem as _jproblem  # noqa: E402
from test_torch_export import port_problem  # noqa: E402

F64 = torch.float64
# tests/test_export.py:68-72's options, the search left at its default
LIVE = dict(iterations_max=6, tol_stationarity=1e-6, tol_primal_feasibility=1e-6,
            throw_errors=False, penalty_warm_start=True)


def closed_loop(problem, jproblem, ref, over, ticks, path=None, atol=1e-8):
    """`ticks` closed-loop ticks of one lane through the artifact (saved to
    `path` and loaded back, when given), JAX's live `mpc_step` and the
    port's, on the same numpy inputs (tests/test_export.py:84-106), with
    tests/test_export.py's options and `over`: u0 within atol and equal
    iterations, ls_iterations and statuses every tick, the carried x, u
    and rho within atol at the end. Returns (each tick's (ls_iterations,
    status), the artifact)."""
    opts = SolverOptions(**{**LIVE, **over})
    jopts = JSolverOptions(**{**LIVE, **over})
    N, m = problem.N, problem.m
    srv = export_mpc_server(problem, opts, batch=None, platforms=("cpu",))
    if path is not None:
        save_exported(srv, path)
        srv = load_exported(path)
    jstep = jax.jit(lambda s, xm, xr, ur: jmpc_step(jproblem, s, xm, xr, ur, jopts))
    state_jax, state_live = jinit_state(jproblem), init_state(problem)
    state_srv = state_to_arrays(init_state(problem))
    x_meas = np.asarray(ref.x[0]) + 0.01
    trials = []
    for t in range(ticks):
        x_ref = np.asarray(ref.x[t + 1: t + N + 2])
        u_ref = np.zeros((N + 1, m))
        u_jax, state_jax, stats_jax = jstep(state_jax, jnp.asarray(x_meas), jnp.asarray(x_ref),
                                            jnp.asarray(u_ref))
        args = [torch.as_tensor(a, dtype=F64) for a in (x_meas, x_ref, u_ref)]
        u_live, state_live, stats_live = mpc_step(problem, state_live, *args, opts)
        u_srv, state_srv, stats_srv = call_exported(srv, *args, state_srv)
        np.testing.assert_allclose(u_srv.numpy(), np.asarray(u_jax), rtol=0, atol=atol)
        np.testing.assert_allclose(u_srv.numpy(), u_live.numpy(), rtol=0, atol=atol)
        for f in ("iterations", "ls_iterations", "status"):
            assert int(stats_srv[f]) == int(getattr(stats_jax, f)) == int(
                getattr(stats_live, f)), f
        trials.append((int(stats_srv["ls_iterations"]), int(stats_srv["status"])))
        x_meas = np.asarray(jproblem.dynamics(jnp.asarray(x_meas), u_jax, jnp.asarray(0.1), 0))
    for f in ("x", "u", "rho"):
        np.testing.assert_allclose(state_srv[f].numpy(), np.asarray(getattr(state_jax, f)),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(state_srv[f].numpy(), getattr(state_live, f).numpy(),
                                   rtol=0, atol=atol)
    return trials, srv


def test_default_options_artifact_matches_live_solvers(tmp_path):
    problem, ref = port_problem()
    jproblem, _ = _jproblem()
    trials, _ = closed_loop(problem, jproblem, ref, {}, 5, str(tmp_path / "wolfe.pt2"))
    assert max(t for t, _ in trials) > 1  # a search went past its first trial


def test_graph_runs_the_live_machine_pass(monkeypatch):
    """One copy of the transitions: the graph calls `linesearch.lanes_pass`
    itself, and so does the live machine, pass by pass."""
    assert graph_solve.lanes_pass is linesearch.lanes_pass
    calls = []
    real = linesearch.lanes_pass

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(linesearch, "lanes_pass", counted)
    phi0 = torch.tensor([1.0, 2.0], dtype=F64)
    dphi0 = torch.tensor([-1.0, -4.0], dtype=F64)
    res = linesearch.wolfe_line_search_lanes(
        lambda a: ((a - 0.3) ** 2 + phi0 - 0.09, 2 * (a - 0.3)), phi0, dphi0)
    assert calls and len(calls) == int(res.n_iters.max())
