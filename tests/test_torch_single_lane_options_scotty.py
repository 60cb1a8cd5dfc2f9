"""tests/test_rti.py's closed loop on the Scotty path through the port's
single-lane solve against altro_tpu's in float64 on the CPU: the
reference's problem, one RTI iteration a tick under each RTI form (the
x-only and the light payload with the phase split, `merit_function`
without it; 8 ticks), and the light-payload grid at the loop's
80-iteration backtracking (3 ticks): statuses and iterations equal tick
for tick, the plant's tracking errors within 1e-9.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.mpc import set_initial_state as jset_x0  # noqa: E402
from altro_tpu.mpc import shift_trajectory as jshift  # noqa: E402
from altro_tpu.mpc import update_linear_costs as jupdate  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402

test_bicycle = pytest.importorskip("test_bicycle")

LOOP_OPTS = {
    "rti_x_only": dict(iterations_max=1, rti_mode=True, throw_errors=False,
                       ls_phase_split=True, ls_grid_x_only=True),
    "rti_light": dict(iterations_max=1, rti_mode=True, throw_errors=False,
                      ls_phase_split=True, ls_grid_x_only=False),
    "rti_full": dict(iterations_max=1, rti_mode=True, throw_errors=False),
    "light_grid": dict(iterations_max=80, use_backtracking_linesearch=True,
                       parallel_linesearch=True, ls_phase_split=True, ls_grid_x_only=False),
}


def _jax_loop(opts, ticks, N=30):
    ref = test_bicycle.scotty_or_skip()
    problem, state, u0 = test_bicycle.make_scotty_problem(ref, N)
    run = jax.jit(jsolve, static_argnames=("opts",))
    dyn = jmidpoint(jbicycle())
    h = test_bicycle.f32(ref.tf / ref.N)
    Qd = np.full(4, 1e-2)
    c_u = 0.5 * float(u0 @ (jnp.full(2, 1e-3) * u0))
    x = np.asarray(ref.x[0])
    xs, its, sts = [], [], []
    for t in range(ticks):
        state, stats = run(problem, state, opts)
        its.append(int(stats.iterations))
        sts.append(int(stats.status))
        x = np.asarray(dyn(jnp.asarray(x), state.u[0], h, 0))
        xs.append(x)
        window = ref.x[t + 1: t + N + 2]
        c_new = 0.5 * np.sum(Qd[None, :] * window * window, axis=1)
        c_new[:N] += c_u
        problem = jupdate(problem, q=-(Qd[None, :] * window), c=c_new)
        problem = jset_x0(problem, x)
        state = jshift(state)
    return np.stack(xs), its, sts


@pytest.mark.parametrize("name", list(LOOP_OPTS))
def test_scotty_loop_matches_jax(name):
    ticks = 8 if name.startswith("rti") else 3
    kw = LOOP_OPTS[name]
    j_x, j_its, j_sts = _jax_loop(JOpts(**kw), ticks)
    ref = load_scotty()
    problem, state = mpc.scotty_reference_problem(ref, dtype=torch.float64, device="cpu")
    res = mpc.run_reference_mpc(problem, state, ref, ticks=ticks, opts=SolverOptions(**kw))
    assert res.iterations == j_its
    assert res.status == j_sts
    errs = np.linalg.norm(j_x - ref.x[1: ticks + 1], axis=1)
    np.testing.assert_allclose(res.tracking_error, errs, rtol=0, atol=1e-9)
