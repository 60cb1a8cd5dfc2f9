"""The port's 200-tick Scotty MPC against the C++ reference's artifact.

bicycle_test.cpp:266-360 (tests/test_bicycle.py:119-165): 200
warm-started resolves of the Scotty tracking problem (N=30, the steering
bound, `SolverOptions(iterations_max=80, use_backtracking_linesearch=True)`),
each tick sliding the tracking terms with `mpc.update_linear_costs`,
setting the measured state with `mpc.set_initial_state` and shifting the
warm start with `mpc.shift_trajectory` (`mpc.run_reference_mpc`), f64 on
the CPU. Every status SUCCESS; the per-resolve iteration trace EQUAL to
data/scotty_mpc.npz["solve_iters"] tick for tick; the closed-loop
tracking errors to 1e-5 of the artifact's, the first to 1e-9 relative.
No JAX: the artifact is the reference's own output.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "data", "scotty_mpc.npz")


def test_scotty_mpc_trace_equals_reference_artifact():
    art = np.load(ARTIFACT)
    ref = load_scotty()
    prob, st = mpc.scotty_reference_problem(ref, N=30, dtype=torch.float64, device="cpu")
    res = mpc.run_reference_mpc(prob, st, ref, ticks=200)
    assert all(s == SolveStatus.SUCCESS for s in res.status)
    assert res.iterations == art["solve_iters"].tolist(), (
        "per-resolve iteration trace diverged from the reference artifact")
    assert abs(res.tracking_error[0] - 1.2289032472929445e-3) < 1e-9 * 1.23e-3
    np.testing.assert_allclose(res.tracking_error, art["tracking_error"], atol=1e-5)


def test_functional_mpc_api():
    """shift_trajectory, set_initial_state, update_linear_costs,
    update_tracking_window and mpc_step as altro_tpu/mpc.py defines them."""
    ref = load_scotty()
    prob, st = mpc.scotty_reference_problem(ref, N=6, dtype=torch.float64, device="cpu")
    sh = mpc.shift_trajectory(st)
    assert torch.equal(sh.x[:-1], st.x[1:]) and torch.equal(sh.x[-1], st.x[-1])
    assert torch.equal(sh.u[:-1], st.u[1:]) and torch.equal(sh.u[-1], st.u[-1])
    assert torch.equal(sh.z[0], st.z[0]) and torch.equal(sh.K, st.K)  # duals, gains kept
    p2 = mpc.set_initial_state(prob, np.arange(4.0))
    assert p2.x0.dtype == torch.float64 and p2.x0.tolist() == [0.0, 1.0, 2.0, 3.0]
    window = ref.x[1:8]
    p3 = mpc.update_tracking_window(prob, window)
    np.testing.assert_allclose(p3.cost.q.numpy(), -1e-2 * window)
    np.testing.assert_allclose(p3.cost.c.numpy(), 0.5 * 1e-2 * np.sum(window ** 2, axis=1))
    assert torch.equal(p3.cost.Q, prob.cost.Q)
    assert torch.equal(p3.cost.r, torch.zeros((7, 2), dtype=torch.float64))
    p4 = mpc.update_linear_costs(prob, q=p3.cost.q.numpy(), c=p3.cost.c)
    assert torch.equal(p4.cost.q, p3.cost.q) and torch.equal(p4.cost.r, prob.cost.r)
    opts = mpc.reference_mpc_options()
    u0, new_state, stats = mpc.mpc_step(prob, st, ref.x[1], window, opts=opts)
    assert int(stats.status) == SolveStatus.SUCCESS and torch.equal(u0, new_state.u[0])
