"""The port's batched artifact (export_mpc_server(batch=B)) against
`jax.vmap(mpc_step)`: tests/test_export.py:108-128's problem, options and
B=4 inputs in f64 on the CPU. The shapes of the serving ABI, and each lane
to 1e-8 of JAX's vmapped tick and of the port's live vmapped tick
(`mpc.mpc_step_lanes`) over two chained ticks, iterations equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.export import state_to_arrays as jstate_to_arrays  # noqa: E402
from altro_tpu.mpc import mpc_step as jmpc_step  # noqa: E402
from altro_tpu.options import SolverOptions as JSolverOptions  # noqa: E402
from altro_tpu.solver import init_state as jinit_state  # noqa: E402
from altro_tpu_torch.export import (  # noqa: E402
    arrays_to_state,
    call_exported,
    export_mpc_server,
    load_exported,
    save_exported,
    state_to_arrays,
)
from altro_tpu_torch.mpc import mpc_step_lanes  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.solver import init_state  # noqa: E402
from test_export import _bicycle_problem as _jproblem  # noqa: E402
from test_torch_export import port_problem  # noqa: E402

F64 = torch.float64
B, N = 4, 8
OPTS = dict(iterations_max=3, use_backtracking_linesearch=True, throw_errors=False)


def test_export_batched_matches_vmapped_tick(tmp_path):
    problem, ref = port_problem(N=N)
    jproblem, _ = _jproblem(N=N)
    opts, jopts = SolverOptions(**OPTS), JSolverOptions(**OPTS)
    n, m = problem.n, problem.m
    art = export_mpc_server(problem, opts, batch=B, platforms=("cpu",))
    save_exported(art, str(tmp_path / "b.pt2"))
    srv = load_exported(str(tmp_path / "b.pt2"))

    tile = lambda a: np.broadcast_to(np.asarray(a), (B,) + np.asarray(a).shape).copy()  # noqa: E731
    x_meas = tile(ref.x[0]) + 0.01 * np.arange(B)[:, None]
    x_ref = tile(ref.x[1: N + 2])
    u_ref = np.zeros((B, N + 1, m))
    state_np = {k: tile(np.asarray(v)) for k, v in jstate_to_arrays(jinit_state(jproblem)).items()}
    assert list(state_np) == list(state_to_arrays(init_state(problem)))

    jstep = jax.jit(jax.vmap(lambda s, xm, xr, ur: jmpc_step(jproblem, s, xm, xr, ur, jopts)))
    from altro_tpu.export import arrays_to_state as jarrays_to_state

    state_jax = jarrays_to_state({k: jnp.asarray(v) for k, v in state_np.items()})
    state_srv = {k: torch.as_tensor(v, dtype=F64) for k, v in state_np.items()}
    state_live = arrays_to_state(state_srv)
    for _ in range(2):
        args = [torch.as_tensor(a, dtype=F64) for a in (x_meas, x_ref, u_ref)]
        u_jax, state_jax, stats_jax = jstep(state_jax, *(jnp.asarray(a) for a in
                                                         (x_meas, x_ref, u_ref)))
        u_live, state_live, stats_live = mpc_step_lanes(problem, state_live, *args, opts)
        u_srv, state_srv, stats_srv = call_exported(srv, *args, state_srv)
        assert u_srv.shape == (B, m)
        assert state_srv["x"].shape == (B, N + 1, n)
        assert stats_srv["iterations"].shape == (B,)
        assert np.isfinite(u_srv.numpy()).all()
        np.testing.assert_allclose(u_srv.numpy(), np.asarray(u_jax), rtol=0, atol=1e-8)
        np.testing.assert_allclose(u_srv.numpy(), u_live.numpy(), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(stats_srv["iterations"].numpy(),
                                      np.asarray(stats_jax.iterations))
        np.testing.assert_array_equal(stats_srv["iterations"].numpy(),
                                      stats_live.iterations.numpy())
        np.testing.assert_array_equal(stats_srv["status"].numpy(), np.asarray(stats_jax.status))
        for f in ("x", "u", "rho"):
            np.testing.assert_allclose(state_srv[f].numpy(), np.asarray(getattr(state_jax, f)),
                                       rtol=0, atol=1e-8)
        x_meas = x_meas + 0.1 * np.asarray(u_jax)[:, :1] * np.array([1.0, 0.0, 0.0, 0.0])
