"""The batched artifact under the default SolverOptions() (the strong-Wolfe
search of every lane inside the graph) against `jax.vmap(mpc_step)`:
tests/test_export.py:108-128's problem and B=4 inputs with
tests/test_export.py:68-72's options, the search at its default, in f64
on the CPU over two chained ticks. Each lane's u0, x, u and rho within
1e-8 of JAX's and of the port's live vmapped tick
(`mpc.mpc_step_lanes`), iterations, ls_iterations and statuses equal
lane for lane."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.export import arrays_to_state as jarrays_to_state  # noqa: E402
from altro_tpu.export import state_to_arrays as jstate_to_arrays  # noqa: E402
from altro_tpu.mpc import mpc_step as jmpc_step  # noqa: E402
from altro_tpu.options import SolverOptions as JSolverOptions  # noqa: E402
from altro_tpu.solver import init_state as jinit_state  # noqa: E402
from altro_tpu_torch.export import arrays_to_state, call_exported, export_mpc_server  # noqa: E402
from altro_tpu_torch.mpc import mpc_step_lanes  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from test_export import _bicycle_problem as _jproblem  # noqa: E402
from test_torch_export import port_problem  # noqa: E402
from test_torch_export_wolfe import LIVE  # noqa: E402

F64 = torch.float64
B, N = 4, 8


def test_default_options_batched_artifact_matches_vmapped_tick():
    problem, ref = port_problem(N=N)
    jproblem, _ = _jproblem(N=N)
    opts, jopts = SolverOptions(**LIVE), JSolverOptions(**LIVE)
    m = problem.m
    srv = export_mpc_server(problem, opts, batch=B, platforms=("cpu",))

    tile = lambda a: np.broadcast_to(np.asarray(a), (B,) + np.asarray(a).shape).copy()  # noqa: E731
    x_meas = tile(ref.x[0]) + 0.05 * np.arange(B)[:, None]
    x_ref = tile(ref.x[1: N + 2])
    u_ref = np.zeros((B, N + 1, m))
    state_np = {k: tile(np.asarray(v)) for k, v in jstate_to_arrays(jinit_state(jproblem)).items()}
    jstep = jax.jit(jax.vmap(lambda s, xm, xr, ur: jmpc_step(jproblem, s, xm, xr, ur, jopts)))
    state_jax = jarrays_to_state({k: jnp.asarray(v) for k, v in state_np.items()})
    state_srv = {k: torch.as_tensor(v, dtype=F64) for k, v in state_np.items()}
    state_live = arrays_to_state(state_srv)
    trials = []
    for _ in range(2):
        args = [torch.as_tensor(a, dtype=F64) for a in (x_meas, x_ref, u_ref)]
        u_jax, state_jax, stats_jax = jstep(state_jax, *(jnp.asarray(a) for a in
                                                         (x_meas, x_ref, u_ref)))
        u_live, state_live, stats_live = mpc_step_lanes(problem, state_live, *args, opts)
        u_srv, state_srv, stats_srv = call_exported(srv, *args, state_srv)
        assert u_srv.shape == (B, m) and stats_srv["ls_iterations"].shape == (B,)
        np.testing.assert_allclose(u_srv.numpy(), np.asarray(u_jax), rtol=0, atol=1e-8)
        np.testing.assert_allclose(u_srv.numpy(), u_live.numpy(), rtol=0, atol=1e-8)
        for f in ("iterations", "ls_iterations", "status"):
            np.testing.assert_array_equal(stats_srv[f].numpy(), np.asarray(getattr(stats_jax, f)))
            np.testing.assert_array_equal(stats_srv[f].numpy(), getattr(stats_live, f).numpy())
        for f in ("x", "u", "rho"):
            np.testing.assert_allclose(state_srv[f].numpy(), np.asarray(getattr(state_jax, f)),
                                       rtol=0, atol=1e-8)
            np.testing.assert_allclose(state_srv[f].numpy(), getattr(state_live, f).numpy(),
                                       rtol=0, atol=1e-8)
        trials.append(stats_srv["ls_iterations"].numpy())
        x_meas = x_meas + 0.1 * np.asarray(u_jax)[:, :1] * np.array([1.0, 0.0, 0.0, 0.0])
    assert np.max(trials) > 1  # a lane's search went past its first trial
