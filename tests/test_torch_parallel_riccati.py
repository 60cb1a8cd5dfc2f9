"""The port's associative (parallel-in-time) TVLQR passes against JAX's,
in float64 on identical numpy inputs (tests/test_parallel_riccati.py's
cases at N <= 100; JAX's associative pass is never run at N >= 100 here:
its compiles set the suite's wall).

* `tvlqr_backward_associative` against JAX's at N in {1, 2, 3, 10, 50}
  (pure scan), rtol and atol 1e-9, delta_V rtol 1e-8, and the double
  integrator's golden gains (the two-level form:
  tests/test_torch_parallel_riccati_chunked.py).
* The identity element is neutral on both sides; `tvlqr_forward_associative`
  against JAX's and against the serial rollout.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu import tvlqr as jt  # noqa: E402
from altro_tpu_torch import tvlqr as tt  # noqa: E402

pr = pytest.importorskip("test_parallel_riccati")
tl = pytest.importorskip("test_tvlqr")

FIELDS = ("K", "d", "P", "p")
# jitted: JAX's eager associative scan dispatches its unrolled solves op by op
# (23 s at N=50 against 6 s jitted)
jbackward = jax.jit(jt.tvlqr_backward_associative, static_argnames=("chunk",))


def _torch(args):
    return [torch.as_tensor(np.array(a)) for a in args]


def _assert_close(got, want, tol, dv_rtol):
    assert bool(got.ok) and bool(np.asarray(want.ok))
    assert int(got.fail_index) == int(np.asarray(want.fail_index))
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(got.delta_V.numpy(), np.asarray(want.delta_V), rtol=dv_rtol,
                               atol=1e-9)


@pytest.mark.parametrize("N", [1, 2, 3, 10, 50])
def test_backward_matches_jax_associative(N):
    args = pr.random_lqr(N, n=4, m=2, seed=N)
    g = tt.tvlqr_backward_associative(*_torch(args))
    _assert_close(g, jbackward(*args), 1e-9, 1e-8)
    _assert_close(g, jt.tvlqr_backward(*args), 1e-9, 1e-8)


def test_backward_golden_double_integrator():
    A, B, f, lxx, luu, lux, lx, lu, _ = tl.double_integrator_problem()
    g = tt.tvlqr_backward_associative(*_torch((A, B, f, lxx, luu, lux, lx, lu)))
    gs = jt.tvlqr_backward(A, B, f, lxx, luu, lux, lx, lu)
    np.testing.assert_allclose(g.K.numpy(), np.asarray(gs.K), atol=1e-9)
    np.testing.assert_allclose(g.d.numpy(), np.asarray(gs.d), atol=1e-9)


def test_identity_element_is_composition_neutral():
    rng = np.random.default_rng(3)
    n = 4
    Csym = rng.standard_normal((n, n))
    Jsym = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    x = (rng.standard_normal((n, n)), rng.standard_normal((n, 1)), 0.5 * (Csym + Csym.T),
         rng.standard_normal((n, 1)), 0.5 * (Jsym + Jsym.T))
    x = tuple(torch.as_tensor(a) for a in x)
    ident = tt._identity_elements((), n, torch.float64, "cpu")
    for out in (tt._combine_value_elements(x, ident), tt._combine_value_elements(ident, x)):
        for got, want in zip(out, x):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


def test_forward_matches_jax_associative_and_serial():
    args = pr.random_lqr(20, n=4, m=2, seed=7)
    g = jt.tvlqr_backward(*args)
    x0 = np.random.default_rng(1).standard_normal(4)
    want = jax.jit(jt.tvlqr_forward_associative)(*args[:3], g.K, g.d, g.P, g.p, x0)
    ops = _torch(args[:3] + (g.K, g.d, g.P, g.p, x0))
    got = tt.tvlqr_forward_associative(*ops)
    serial = tt.tvlqr_forward(*ops)
    for a, b, s in zip(got, want, serial):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(a.numpy(), s.numpy(), rtol=1e-10, atol=1e-10)
