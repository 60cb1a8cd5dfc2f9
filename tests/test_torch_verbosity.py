"""The port's verbosity tiers and `iteration_callback` against altro_tpu's.

tests/test_verbosity.py's five printing cases (SILENT, OUTER, INNER,
LINE_SEARCH under the strong-Wolfe search and under the phase-split
grid) on its goal-constrained double integrator, and
tests/test_models_extra.py::test_iteration_callback. The port prints from
its host loop with JAX's format strings; each case runs the same solve
through `altro_tpu.solver.solve` and the port's `solver.solve` (f64, CPU)
and compares the count of each tier's lines, not their digits, and the
JAX test's own assertions. At SILENT without a callback the port's loop
makes no host read for reporting.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.double_integrator import double_integrator_dynamics as jdi  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.options import Verbosity as JVerbosity  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import DiagonalCost as JCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch.options import SolverOptions, Verbosity  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402

N, DIM = 10, 2
NX, NU = 2 * DIM, DIM
X0 = [1.0, 1.0, 0.0, 0.0]
# each tier's line, as the JAX package prints it
MARKS = ("STARTING ALTRO iLQR SOLVE", "ALTRO SOLVE FINISHED", "  iter = ", "  outer: iter = ",
         "Starting Cubic Line Search", "    ls trial ", "    ls grid block ")


def _jax_problem(x0):
    cost = JCost(Q=jnp.ones((N + 1, NX)), R=jnp.full((N + 1, NU), 1e-2),
                 q=jnp.zeros((N + 1, NX)), r=jnp.zeros((N + 1, NU)), c=jnp.zeros(N + 1))
    goal = JSpec(fn=lambda x, u, k: x - jnp.zeros(NX), cone=JCone.ZERO, dim=NX,
                 active=jnp.zeros(N + 1, bool).at[N].set(True), label="goal")
    return JProblem(N=N, n=NX, m=NU, dynamics=jdi(DIM), dynamics_jac=None,
                    constraints=(goal,), cost=cost, h=jnp.full(N, 0.5), x0=jnp.asarray(x0))


def _port_problem(x0):
    return rp.double_integrator_problem(
        x0, (rp.di_goal_constraint(np.zeros(NX), dtype=torch.float64, device="cpu"),),
        dtype=torch.float64, device="cpu")


def _counts(out):
    lines = out.splitlines()
    return {mark: sum(ln.startswith(mark) for ln in lines) for mark in MARKS}


def _run_both(verbose, capsys, **kw):
    jprob = _jax_problem(X0)
    state, stats = jsolve(jprob, jinit(jprob), JOpts(verbose=JVerbosity(int(verbose)), **kw))
    jax.block_until_ready(state)
    jax.effects_barrier()
    assert int(stats.status) == SolveStatus.SUCCESS
    jout = capsys.readouterr().out
    prob = _port_problem(X0)
    _, tstats = solver.solve(prob, solver.init_state(prob),
                             SolverOptions(verbose=verbose, **kw))
    assert int(tstats.status) == SolveStatus.SUCCESS
    assert int(tstats.iterations) == int(stats.iterations)
    tout = capsys.readouterr().out
    assert _counts(tout) == _counts(jout), (tout, jout)
    return tout


def test_silent_prints_nothing(capsys, monkeypatch):
    def no_read(*vals):
        raise AssertionError("a host read for reporting at SILENT")

    monkeypatch.setattr(solver, "_read", no_read)
    out = _run_both(Verbosity.SILENT, capsys)
    assert out == ""


def test_outer_prints_banner_and_dual_rounds_only(capsys):
    out = _run_both(Verbosity.OUTER, capsys)
    assert "STARTING ALTRO iLQR SOLVE" in out
    assert "ALTRO SOLVE FINISHED" in out
    assert "outer:" in out
    assert "iter = " not in out.replace("outer: iter = ", "")
    assert "ls trial" not in out and "ls grid" not in out


def test_inner_prints_per_iteration_line(capsys):
    out = _run_both(Verbosity.INNER, capsys)
    assert "STARTING ALTRO iLQR SOLVE" in out
    assert out.count("  iter = ") == 3
    assert "dual update?" in out
    assert "ls trial" not in out and "ls grid" not in out


def test_line_search_level_adds_trial_trace(capsys):
    out = _run_both(Verbosity.LINE_SEARCH, capsys)
    assert out.count("  iter = ") == 3
    assert "Starting Cubic Line Search" in out
    assert "ls trial" in out


def test_line_search_level_traces_parallel_grid(capsys):
    out = _run_both(Verbosity.LINE_SEARCH, capsys, use_backtracking_linesearch=True,
                    parallel_linesearch=True, ls_phase_split=True, ls_try_cubic_first=False,
                    ls_max_iters=8)
    assert "ls grid block 0" in out


def test_iteration_callback():
    """tests/test_models_extra.py::test_iteration_callback: one call an
    iteration, (iter, phi, stat, feas, alpha, rho), as JAX's."""
    seen = {"jax": [], "torch": []}

    def cb(lib):
        def f(it, phi, stat, feas, alpha, rho):
            seen[lib].append((int(it), float(phi), float(stat), float(feas), float(alpha),
                              float(rho)))
        return f

    x0 = [1.0, 2.0, 0.0, 0.0]
    jprob = _jax_problem(x0)
    _, jstats = jsolve(jprob, jinit(jprob), JOpts(penalty_scaling=100.0,
                                                   iteration_callback=cb("jax")))
    jax.effects_barrier()
    prob = _port_problem(x0)
    _, stats = solver.solve(prob, solver.init_state(prob),
                            SolverOptions(penalty_scaling=100.0, iteration_callback=cb("torch")))
    assert int(stats.status) == int(jstats.status) == SolveStatus.SUCCESS
    assert len(seen["torch"]) == int(stats.iterations) == 3
    assert [s[0] for s in seen["torch"]] == [0, 1, 2]
    np.testing.assert_allclose(np.array(seen["torch"]), np.array(seen["jax"]), rtol=1e-8,
                               atol=1e-10)
