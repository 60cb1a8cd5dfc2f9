"""The port's facade against altro_tpu's: tests/test_api.py's error paths,
index ranges, cost-tolerance criterion and solve-time budget.

The precondition and error cases compare the `ErrorCode` each facade
raises, step for step; the range sentinels compare the knot ranges; the
two solve cases hold the port's facade to JAX's in f64 on the CPU
(statuses, iteration counts, trajectories, gains and duals to 1e-8, as
test_torch_api.py does), and the JAX test's own assertions hold too.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.status import AltroError as JAltroError  # noqa: E402
from altro_tpu_torch import ALL_INDICES, LAST_INDEX  # noqa: E402
from altro_tpu_torch.status import AltroError, ErrorCode, SolveStatus  # noqa: E402
from test_torch_api import (  # noqa: E402
    NU,
    NX,
    N,
    assert_same_solve,
    both,
    build_solver,
    cone,
    goal_fn,
    new_solver,
    options,
)


def _code(call):
    """The ErrorCode `call` raises (either package's AltroError), as an int."""
    with pytest.raises((AltroError, JAltroError)) as e:
        call()
    return int(e.value.code)


def test_initialize_precondition_order():
    """dimension -> timestep -> dynamics -> cost, as the reference
    (knotpoint_data_test.cpp:71-93), in both facades."""
    seen = {}
    for lib in ("jax", "torch"):
        s = new_solver(lib)
        codes = [_code(s.initialize)]
        s.set_dimension(NX, NU)
        codes.append(_code(s.initialize))
        s.set_time_step(0.1)
        codes.append(_code(s.initialize))
        if lib == "jax":
            s.set_explicit_dynamics(lambda x, u, h, k: x + h * jnp.concatenate([x[2:], u]))
        else:
            s.set_explicit_dynamics(lambda x, u, h, k: x + h * torch.cat([x[2:], u]))
        codes.append(_code(s.initialize))
        seen[lib] = codes
    assert seen["torch"] == seen["jax"] == [
        ErrorCode.DIMENSION_UNKNOWN, ErrorCode.TIMESTEP_NOT_POSITIVE,
        ErrorCode.DYNAMICS_FUN_NOT_SET, ErrorCode.COST_FUN_NOT_SET]


def test_error_paths():
    seen = {}
    for lib in ("jax", "torch"):
        s = new_solver(lib)
        codes = [_code(s.initialize)]  # no dims or cost
        s.set_dimension(NX, NU)
        codes.append(_code(lambda: s.set_time_step(-1.0)))
        codes.append(_code(s.initialize))  # cost not set
        codes.append(_code(lambda: s.set_input_bounds(u_lo=[1.0, 1.0], u_hi=[-1.0, -1.0])))
        codes.append(_code(lambda: new_solver(lib, 0)))
        codes.append(_code(lambda: s.get_state(0)))  # not initialized
        seen[lib] = codes
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][3] == ErrorCode.INVALID_BOUND_CONSTRAINT
    assert seen["torch"][5] == ErrorCode.SOLVER_NOT_INITIALIZED


def test_range_sentinels():
    for lib in ("jax", "torch"):
        s = new_solver(lib)
        s.set_dimension(NX, NU)
        assert list(s._range(0, LAST_INDEX, True)) == list(range(N + 1))
        assert list(s._range(0, LAST_INDEX, False)) == list(range(N))
        assert list(s._range(ALL_INDICES, 0, True)) == list(range(N + 1))
        assert list(s._range(3, 0, True)) == [3]
        assert list(s._range(3, 7, True)) == [3, 4, 5, 6]
        assert _code(lambda: s._range(N + 1, 0, True)) == ErrorCode.BAD_INDEX


def test_cost_tolerance_criterion():
    """enable_cost_tolerance stops on the merit plateau with SUCCESS."""
    base = dict(iterations_max=30, tol_stationarity=0.0, throw_errors=False)

    def build_off(lib):
        s = build_solver(lib, [1.0, 2.0, 0.0, 0.0])
        s.set_options(options(lib, **base))
        s.initialize()
        return s

    def build_on(lib):
        s = build_solver(lib, [1.0, 2.0, 0.0, 0.0])
        s.set_options(options(lib, **base, enable_cost_tolerance=True, tol_cost=1e-10))
        s.initialize()
        return s

    js, ts = both(build_off)
    js2, ts2 = both(build_on)
    assert js.solve() == ts.solve()
    assert js2.solve() == ts2.solve()
    assert_same_solve(js, ts)
    assert_same_solve(js2, ts2)
    assert ts.get_status() in (SolveStatus.MAX_ITERATIONS,
                               SolveStatus.MERIT_FUN_GRADIENT_TOO_SMALL)
    assert ts2.get_status() == SolveStatus.SUCCESS
    assert ts2.get_iterations() < ts.get_iterations()
    np.testing.assert_allclose(ts.get_input(0), ts2.get_input(0), atol=1e-6)


def test_max_solve_time_budget():
    """max_solve_time in chunks of at most 10 iterations: a zero budget
    stops after the first chunk, a generous one solves as untimed."""

    def build_zero(lib):
        s = build_solver(lib, [1.0, 2.0, 0.0, 0.0])
        s.set_constraint(goal_fn(lib), NX, cone(lib, "ZERO"), "goal", N)
        s.set_options(options(lib, iterations_max=200, tol_stationarity=0.0,
                              max_solve_time=0.0, throw_errors=False))
        s.initialize()
        return s

    def build_generous(lib):
        s = build_solver(lib, [1.0, 2.0, 0.0, 0.0])
        s.set_constraint(goal_fn(lib), NX, cone(lib, "ZERO"), "goal", N)
        s.set_options(options(lib, max_solve_time=120.0))
        s.initialize()
        return s

    js, ts = both(build_zero)
    assert js.solve() == ts.solve() == SolveStatus.MAX_SOLVE_TIME
    assert_same_solve(js, ts)
    assert 0 < ts.get_iterations() <= 10
    assert np.isfinite(ts.get_state(N)).all()

    js2, ts2 = both(build_generous)
    assert js2.solve() == ts2.solve() == SolveStatus.SUCCESS
    assert_same_solve(js2, ts2)
    assert np.linalg.norm(ts2.get_state(N)) < 1e-4
