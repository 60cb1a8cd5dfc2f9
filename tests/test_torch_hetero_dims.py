"""Heterogeneous per-knot dimensions through the port's facade, against
altro_tpu's facade and against the hand-padded problem.

tests/test_hetero_dims.py's five cases: phase A (knots 0-4) a 1D double
integrator (n=2, m=1), a transition knot to n=3, phase B (knots 5-10)
n=3, m=2 with knot-sized input bounds. The facade pads to (3, 2): sliced
callables, zero-filled padded next states, a unit input-cost diagonal on
padded inputs, per-knot dynamics selected by the knot's index. In f64 on
the CPU the port's hetero build equals JAX's hetero build (status,
iterations, ls_iterations, x, u, K, d and duals to 1e-8) and the port's
own hand-padded build (iterations equal, states and inputs to 1e-10), and
each JAX test's assertions hold on the port.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.status import AltroError as JAltroError  # noqa: E402
from altro_tpu_torch.status import AltroError, SolveStatus  # noqa: E402
from test_torch_api import assert_same_solve, new_solver  # noqa: E402

N = 10
H = 0.1
X_REF_B = [1.0, 0.0, 0.0]


def _dyns(lib):
    """(dyn_a, dyn_t, dyn_b, stack, cat) of tests/test_hetero_dims.py in
    either package; the port's take component-first tensors."""
    stack = jnp.stack if lib == "jax" else torch.stack
    cat = jnp.concatenate if lib == "jax" else torch.cat

    def dyn_a(x, u, hh, k):
        p, v = x[0], x[1]
        return stack([p + v * hh + 0.5 * u[0] * hh * hh, v + u[0] * hh])

    def dyn_t(x, u, hh, k):
        p, v = x[0], x[1]
        return stack([p + v * hh + 0.5 * u[0] * hh * hh, v + u[0] * hh, p * hh])

    def dyn_b(x, u, hh, k):
        p, v, s = x[0], x[1], x[2]
        return stack([p + v * hh + 0.5 * u[0] * hh * hh, v + (u[0] - u[1] * v) * hh,
                      s + p * hh])

    return dyn_a, dyn_t, dyn_b, cat


def build_hetero(lib):
    dyn_a, dyn_t, dyn_b, _ = _dyns(lib)
    s = new_solver(lib, N)
    s.set_dimension(2, 1, 0, 5)
    s.set_dimension(3, 2, 5, N + 1)
    s.set_time_step(H)
    s.set_explicit_dynamics(dyn_a, k_start=0, k_stop=4)
    s.set_explicit_dynamics(dyn_t, k_start=4, k_stop=5)
    s.set_explicit_dynamics(dyn_b, k_start=5, k_stop=N)
    s.set_lqr_cost([1.0, 1.0], [0.1], [1.0, 0.0], [0.0], 0, 5)
    s.set_lqr_cost([1.0, 1.0, 0.5], [0.1, 0.1], X_REF_B, [0.0, 0.0], 5, N + 1)
    s.set_input_bounds([-0.6, -0.6], [0.6, 0.6], 5, N)
    s.set_initial_state([0.0, 0.0])
    s.initialize()
    return s


def build_hand_padded(lib):
    dyn_a, dyn_t, dyn_b, cat = _dyns(lib)

    def dyn_a_pad(x, u, hh, k):
        xn = dyn_a(x[:2], u[:1], hh, k)
        zero = (jnp.zeros((1,), x.dtype) if lib == "jax"
                else xn.new_zeros((1,) + xn.shape[1:]))
        return cat([xn, zero])

    def dyn_t_pad(x, u, hh, k):
        return dyn_t(x[:2], u[:1], hh, k)

    s = new_solver(lib, N)
    s.set_dimension(3, 2)
    s.set_time_step(H)
    s.set_explicit_dynamics(dyn_a_pad, k_start=0, k_stop=4)
    s.set_explicit_dynamics(dyn_t_pad, k_start=4, k_stop=5)
    s.set_explicit_dynamics(dyn_b, k_start=5, k_stop=N)
    s.set_lqr_cost([1.0, 1.0, 0.0], [0.1, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0], 0, 5)
    s.set_lqr_cost([1.0, 1.0, 0.5], [0.1, 0.1], X_REF_B, [0.0, 0.0], 5, N + 1)
    s.set_input_bounds([-0.6, -0.6], [0.6, 0.6], 5, N)
    s.set_initial_state([0.0, 0.0, 0.0])
    s.initialize()
    return s


def test_hetero_matches_hand_padded():
    sh, sp, jh = build_hetero("torch"), build_hand_padded("torch"), build_hetero("jax")
    assert sh.solve() == SolveStatus.SUCCESS
    assert sp.solve() == SolveStatus.SUCCESS
    assert jh.solve() == SolveStatus.SUCCESS
    assert sh.get_iterations() == sp.get_iterations()
    np.testing.assert_allclose(sh.state.x.numpy(), sp.state.x.numpy(), atol=1e-10)
    np.testing.assert_allclose(sh.state.u.numpy(), sp.state.u.numpy(), atol=1e-10)
    assert_same_solve(jh, sh)


def test_hetero_padded_coords_inert():
    sh, jh = build_hetero("torch"), build_hetero("jax")
    sh.solve()
    jh.solve()
    assert_same_solve(jh, sh)
    x, u = sh.state.x.numpy(), sh.state.u.numpy()
    np.testing.assert_allclose(x[:5, 2], 0.0, atol=1e-12)
    np.testing.assert_allclose(u[:4, 1], 0.0, atol=1e-12)
    assert np.max(np.abs(x[6:, 2])) > 1e-6
    assert np.all(u[5:, 0] <= 0.6 + 1e-6)


def test_hetero_getters_slice_to_knot_dims():
    sh, jh = build_hetero("torch"), build_hetero("jax")
    for s in (sh, jh):
        assert s.get_state_dim() == 3 and s.get_input_dim() == 2
        assert s.get_state_dim(0) == 2 and s.get_input_dim(0) == 1
        assert s.get_state_dim(7) == 3 and s.get_input_dim(7) == 2
        s.solve()
        assert s.get_state(0).shape == (2,)
        assert s.get_input(0).shape == (1,)
        assert s.get_state(N).shape == (3,)
        assert s.get_input(7).shape == (2,)
    for k in range(N + 1):
        np.testing.assert_allclose(sh.get_state(k), np.asarray(jh.get_state(k)), atol=1e-8)


def test_hetero_requires_all_knots_set():
    for lib in ("jax", "torch"):
        dyn_a, _, _, _ = _dyns(lib)
        s = new_solver(lib, N)
        s.set_dimension(2, 1, 0, 5)  # knots 5..N left unset
        s.set_time_step(H)
        s.set_explicit_dynamics(dyn_a)
        s.set_lqr_cost([1.0, 1.0], [0.1], [1.0, 0.0], [0.0])
        s.set_initial_state([0.0, 0.0])
        with pytest.raises((AltroError, JAltroError)) as e:
            s.initialize()
        assert e.value.code.name == "STATE_DIM_UNKNOWN"


def test_homogeneous_path_unchanged():
    """Without hetero dims the callables are not wrapped."""
    solvers = {}
    for lib in ("jax", "torch"):
        _, _, dyn_b, _ = _dyns(lib)
        s = new_solver(lib, N)
        s.set_dimension(3, 2)
        s.set_time_step(H)
        s.set_explicit_dynamics(dyn_b)
        s.set_lqr_cost([1.0, 1.0, 0.5], [0.1, 0.1], X_REF_B, [0.0, 0.0])
        s.set_initial_state([0.0, 0.0, 0.0])
        s.initialize()
        assert s.problem.dynamics is dyn_b
        assert s.solve() == SolveStatus.SUCCESS
        solvers[lib] = s
    assert_same_solve(solvers["jax"], solvers["torch"])
