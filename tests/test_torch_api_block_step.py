"""The port's facade against altro_tpu's on tests/test_api.py:250-293, the
pendulum with the block step, and the README's Quick start.

tests/test_api.py::test_set_tile_dynamics_fast_path_matches_plain solves
the pendulum swing-up (midpoint, N=30, h=0.06, input bounds |u| <= 6 from
`set_input_bounds`: two affine NEGATIVE_ORTHANT rows on u) under the
phase-split Armijo-only grid, with and without
`set_tile_dynamics(midpoint_tile(pendulum_tile()))`. With the block step
the port's solve runs its trial rollout (on the CPU the plain twin,
`trial_rollout_ref`; on the card the pendulum kernel of
csrc/trial_rollout.cu), without it the problem's own grid. Each is held
to JAX's facade with the same setting in f64 (status, iterations,
ls_iterations, x, u, K, d and duals to 1e-8), and the JAX test's own
assertions hold. The README's Quick start runs verbatim on the port
(`device="cpu"`, the default float32) to the reference's golden x_N.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.pendulum import pendulum_continuous as jpendulum  # noqa: E402
from altro_tpu.models.tile_steps import midpoint_tile as jmidpoint_tile  # noqa: E402
from altro_tpu.models.tile_steps import pendulum_tile as jpendulum_tile  # noqa: E402
from altro_tpu_torch.mpc import pendulum_block_step_solver  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402
from test_torch_api import assert_same_solve, new_solver, options  # noqa: E402

N, n, m = 30, 2, 1
KW = dict(iterations_max=12, use_backtracking_linesearch=True, parallel_linesearch=True,
          ls_phase_split=True, ls_try_cubic_first=False, ls_armijo_only=True, ls_max_iters=8,
          throw_errors=False)
PENDULUM_XN = (3.12099917161669, 0.0011966258762942175)  # pendulum_test.cpp's golden


def build(lib, with_tile):
    """tests/test_api.py's build(with_tile): JAX's facade here, the port's
    from `mpc.pendulum_block_step_solver` in f64 on the CPU."""
    if lib == "torch":
        return pendulum_block_step_solver(with_tile, torch.float64, "cpu")
    dyn = jmidpoint(jpendulum())
    s = new_solver(lib, N)
    s.set_dimension(n, m)
    s.set_time_step(0.06)
    s.set_explicit_dynamics(lambda x, u, h, k: dyn(x, u, h, k))
    s.set_lqr_cost(np.full(n, 1e-1), np.full(m, 1e-3), np.array([np.pi, 0.0]), np.zeros(m))
    s.set_input_bounds(u_lo=[-6.0], u_hi=[6.0])
    s.set_initial_state(np.zeros(n))
    if with_tile:
        s.set_tile_dynamics(jmidpoint_tile(jpendulum_tile()))
    s.initialize()
    s.set_input(np.full((m,), 0.1), 0, N)
    s.set_options(options(lib, **KW))
    return s


def test_set_tile_dynamics_fast_path_matches_plain(monkeypatch):
    calls = []
    ref = tr.trial_rollout_ref
    monkeypatch.setattr(tr, "trial_rollout_ref", lambda *a, **k: calls.append(1) or ref(*a, **k))
    s_plain, s_tile = build("torch", False), build("torch", True)
    assert s_tile.problem.dynamics_tile is not None
    assert tr.problem_ineligibility(s_tile.problem) is None  # the bounds' rows are affine
    assert sum(spec.dim for spec in s_tile.problem.constraints) == 2
    before = (rl.LAUNCHES, tr.LAUNCHES)
    st0 = s_plain.solve()
    assert not calls  # without the block step: the problem's own grid
    st1 = s_tile.solve()
    assert calls  # with it: the trial rollout, here its plain twin
    assert (rl.LAUNCHES, tr.LAUNCHES) == before  # CPU tensors: nothing launched
    assert st0 == st1
    assert s_plain.get_iterations() == s_tile.get_iterations()
    np.testing.assert_allclose(s_plain.state.u.numpy(), s_tile.state.u.numpy(), atol=5e-5)
    assert float(s_tile.state.u.abs().max()) > 5.9  # the bound is in play

    for with_tile, ts in ((False, s_plain), (True, s_tile)):
        js = build("jax", with_tile)
        assert js.solve() == ts.get_status()
        assert_same_solve(js, ts)


def test_block_step_and_rows_match_the_jax_facade():
    """The facade's block step names the pendulum's device step, and the
    affine rows the trial rollout reads from the bound group are JAX's."""
    from altro_tpu.ops.pallas_rollout import affine_constraint_stacks as jstacks

    ts, js = build("torch", True), build("jax", True)
    ds = ts.problem.dynamics_tile.device_step
    assert (ds.model, ds.integrator, ds.n, ds.m) == (2, 0, n, m)
    assert tr.ineligibility(ts.problem.dynamics_tile, n, m, 8, 2) is None
    for got, want in zip(rg.affine_constraint_stacks(ts.problem), jstacks(js.problem)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_readme_quick_start_runs_verbatim():
    """README.md's Quick start with `altro_tpu_torch` (and device="cpu")."""
    import numpy as np  # noqa: F811 (the Quick start's own imports)
    from altro_tpu_torch import (ALTROSolver, Cone, SolverOptions, LAST_INDEX)  # noqa: F401
    from altro_tpu_torch.models import midpoint, pendulum_continuous

    N, n, m = 50, 2, 1
    solver = ALTROSolver(N, device="cpu")
    solver.set_dimension(n, m)
    solver.set_time_step(3.0 / N)
    solver.set_explicit_dynamics(midpoint(pendulum_continuous()))
    solver.set_lqr_cost(np.full(n, 1e-2), np.full(m, 1e-3),
                        x_ref=[np.pi, 0.0], u_ref=[0.0], k_start=0, k_stop=N)
    solver.set_lqr_cost(np.ones(n), np.full(m, 1e-3), [np.pi, 0.0], [0.0], N)
    solver.set_initial_state([0.0, 0.0])
    solver.initialize()
    solver.set_input([0.1])
    status = solver.solve()
    xN = solver.get_state(N)

    assert status == SolveStatus.SUCCESS
    assert solver.problem.dtype == torch.float32
    np.testing.assert_allclose(xN, PENDULUM_XN, atol=1e-4)


def test_pendulum_example_prints_one_line_an_iteration(capsys):
    """`mpc.run_pendulum_example`, examples/pendulum_swingup.py's solve
    through the facade at Verbosity.INNER: SUCCESS in the 10 iterations
    JAX's facade takes (tools/jax_f32_reference.py --facade), one
    "iter = " line each, x_N at the reference's golden."""
    from altro_tpu_torch.mpc import run_pendulum_example

    res = run_pendulum_example(torch.float64, "cpu")
    out = capsys.readouterr().out
    assert res.status == SolveStatus.SUCCESS and res.iterations == 10
    assert sum(ln.startswith("  iter = ") for ln in out.splitlines()) == res.iterations
    np.testing.assert_allclose(res.x_N, PENDULUM_XN, atol=1e-4)
    assert np.isfinite(res.objective) and res.ms > 0.0
