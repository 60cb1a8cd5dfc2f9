"""The single-lane solve under the light-payload grid and
`pallas_backward`, against altro_tpu's `solve` in float64 on the CPU, on
the double integrator oracles of tests/test_solver_double_integrator.py
(the goal, the control bounds, the SOC bound): the phase-split
light-payload grid (`ls_grid_x_only=False`, altro_tpu/solver.py:957-975)
with and without `ls_armijo_only`, and `pallas_backward` (JAX's fused
dispatcher runs its serial scan on one lane, :635-641) with the default
search and the grid: status, iterations, ls_iterations and alpha equal
JAX's, x and u within 1e-8. `pallas_backward` with `symmetrize_ctg`
raises JAX's ValueError. `rti_mode`: tests/test_torch_single_lane_
options_rti.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402

refsolves = pytest.importorskip("test_torch_reference_solves")

GRID = dict(use_backtracking_linesearch=True, parallel_linesearch=True, ls_phase_split=True)
VARIANTS = {
    "light_grid": dict(GRID, ls_grid_x_only=False),
    "light_grid_armijo_only": dict(GRID, ls_grid_x_only=False, ls_armijo_only=True),
    "pallas_backward": dict(pallas_backward=True),
    "pallas_backward_grid": dict(GRID, pallas_backward=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", list(refsolves.CASES))
def test_double_integrator_matches_jax(case, variant):
    x0, kinds, kw, _ = refsolves.CASES[case]
    kw = dict(kw, **VARIANTS[variant])
    jprob = refsolves._jax_problem(x0, kinds)
    j_state, j_stats = jsolve(jprob, jinit(jprob), JOpts(**kw))

    prob = refsolves._port_problem(x0, kinds)
    before = rl.LAUNCHES
    state, stats = solver.solve(prob, solver.init_state(prob), SolverOptions(**kw))
    assert rl.LAUNCHES == before  # CPU: the plain backward
    assert int(stats.status) == int(j_stats.status)
    assert int(stats.iterations) == int(j_stats.iterations)
    assert int(stats.ls_iterations) == int(j_stats.ls_iterations)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(stats.alpha), float(j_stats.alpha), rtol=0, atol=1e-12)


def test_pallas_backward_exclusive_with_symmetrize():
    x0, kinds, kw, _ = refsolves.CASES["goal"]
    prob = refsolves._port_problem(x0, kinds)
    opts = SolverOptions(**kw, pallas_backward=True, symmetrize_ctg=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        solver.solve(prob, solver.init_state(prob), opts)
    jprob = refsolves._jax_problem(x0, kinds)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jsolve(jprob, jinit(jprob), JOpts(**kw, pallas_backward=True, symmetrize_ctg=True))
