"""The single-lane solve under `rti_mode` (the full step, altro_tpu/
solver.py:865-893: the phase-split x-only or light payload, or
`merit_function` without the phase split), against altro_tpu's `solve` in
float64 on the CPU, on the double integrator oracles of
tests/test_solver_double_integrator.py (the goal, the control bounds, the
SOC bound): status, iterations, ls_iterations and alpha equal JAX's, x
and u within 1e-8.
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

VARIANTS = {
    "rti_x_only": dict(rti_mode=True, ls_phase_split=True, ls_grid_x_only=True),
    "rti_light": dict(rti_mode=True, ls_phase_split=True, ls_grid_x_only=False,
                      ls_armijo_only=True),
    "rti_full": dict(rti_mode=True, ls_phase_split=False),
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
