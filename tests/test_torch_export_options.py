"""Every option JAX's `export_mpc_server` carries, in the port's exported
tick: each case exports tests/test_export.py's problem (one lane, f64 on
the CPU) under tests/test_export.py's options with the case's on top and
runs 3 closed-loop ticks against JAX's live `mpc_step` and the port's,
u0, x, u and rho to 1e-8, iterations, ls_iterations and statuses equal
(`test_torch_export_wolfe.closed_loop`).

The exact AL Hessian's case adds a disc keep-out group the path crosses
(DISC), whose curvature term the Hessian then carries. One case a file,
so that each file runs in well under a minute:
CASES names them all; this file runs `rti_mode` (the full step, one
iteration a tick as a real-time iteration runs), and
test_torch_export_options_*.py one case each.
"""

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_export import _bicycle_problem as _jproblem  # noqa: E402
from test_torch_export import port_problem  # noqa: E402
from test_torch_export_wolfe import closed_loop  # noqa: E402

GRID = dict(use_backtracking_linesearch=True, parallel_linesearch=True)
CASES = {
    "rti_mode": dict(rti_mode=True, iterations_max=1),
    # one trial (alpha = 1, Armijo and strong Wolfe): where it fails, the
    # fallback takes it when it decreases the merit (BEST_DECREASE)
    "ls_best_decrease_fallback": dict(GRID, ls_phase_split=True, ls_best_decrease_fallback=True,
                                      ls_max_iters=1, ls_parallel_width=1),
    "non_split_grid": GRID,
    "light_grid": dict(GRID, ls_phase_split=True, ls_grid_x_only=False),
    "exact_al_hessian": dict(exact_al_hessian=True),
    "parallel_riccati": dict(parallel_riccati=True),
    "parallel_riccati_chunked": dict(parallel_riccati=True, parallel_riccati_chunk=4),
}


# a disc the reference path crosses (its knot 5 is 0.72 from the center):
# a constraint with curvature, so the exact Hessian's term -sum w nabla^2 c
# is not zero once its dual is
DISC = (9.5, 9.5, 0.8)


def _with_disc(problem, jproblem):
    import dataclasses

    import jax.numpy as jnp

    cx, cy, r = DISC
    port = dataclasses.replace(problem.constraints[0], label="disc", dim=1, fn=lambda x, u, k: (
        r * r - (x[0] - cx) ** 2 - (x[1] - cy) ** 2)[None])
    jax_spec = dataclasses.replace(jproblem.constraints[0], label="disc", dim=1,
                                   fn=lambda x, u, k: jnp.stack(
                                       [r * r - (x[0] - cx) ** 2 - (x[1] - cy) ** 2]))
    return (dataclasses.replace(problem, constraints=problem.constraints + (port,)),
            dataclasses.replace(jproblem, constraints=jproblem.constraints + (jax_spec,)))


def run_case(name):
    problem, ref = port_problem(N=8)
    jproblem, _ = _jproblem(N=8)
    if name == "exact_al_hessian":
        problem, jproblem = _with_disc(problem, jproblem)
    return closed_loop(problem, jproblem, ref, CASES[name], 3)


@pytest.mark.parametrize("name", ["rti_mode"])
def test_option_artifact_matches_live_solvers(name):
    run_case(name)
