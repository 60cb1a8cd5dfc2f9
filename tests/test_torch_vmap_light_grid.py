"""The vmapped solve's light-payload grid (`ls_grid_x_only=False`) and its
RTI step with the phase split and the light payload, against
`jax.vmap(solve)` in float64 on the CPU: the double integrator's goal and
control-bounds oracles on 3 lanes (three starts), status, iterations and
ls_iterations equal JAX's lane for lane, x and u within 1e-8.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.parallel import batch  # noqa: E402

refsolves = pytest.importorskip("test_torch_reference_solves")


def _jax_run(problem, x0s, opts):
    run = jax.jit(jax.vmap(lambda x0, s: jsolve(dataclasses.replace(problem, x0=x0), s, opts)))
    out = run(jnp.asarray(x0s), jbatch_init(problem, x0s.shape[0]))
    jax.block_until_ready(out)
    return out


GRID = dict(use_backtracking_linesearch=True, parallel_linesearch=True, ls_phase_split=True,
            ls_grid_x_only=False)
LIGHT = {"light_grid": GRID, "light_grid_armijo_only": dict(GRID, ls_armijo_only=True),
         "rti_light": dict(GRID, rti_mode=True, iterations_max=5)}


@pytest.mark.parametrize("name", list(LIGHT))
@pytest.mark.parametrize("case", ["goal", "control_bounds"])
def test_vmapped_light_grid_matches_jax(case, name):
    x0, kinds, kw, _ = refsolves.CASES[case]
    kw = dict(kw, **LIGHT[name])
    x0s = np.asarray(x0)[None] + np.asarray([[0.0] * 4, [0.3, -0.2, 0.0, 0.1],
                                             [-0.5, 0.4, 0.1, 0.0]])
    j_state, j_stats = _jax_run(refsolves._jax_problem(x0, kinds), x0s, JOpts(**kw))
    prob = refsolves._port_problem(x0, kinds)
    state, stats = batch.vmap_solve(prob, SolverOptions(**kw))(
        torch.as_tensor(x0s), batch.batch_init_state(prob, 3))
    for f in ("status", "iterations", "ls_iterations"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), np.asarray(getattr(j_stats, f)))
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
