"""The single-lane backward at (n, m) = (4, 1), the cart-pole's shape.

The plain version (ops/riccati_latency.py::riccati_latency_ref, what
`riccati_latency` runs on CPU tensors) against `altro_tpu.tvlqr.
tvlqr_backward` in f64 (rtol 1e-10), diagonal and dense costs, the cross
and affine terms, with and without a failing knot, at N = 1, 65 and 100
(one knot, past one 64-knot chunk, the swing-up's horizon); and against the packed Pallas kernel
`riccati_backward_pallas_packed(interpret=True)` in f32 (the tolerances
of tests/test_pallas_packed.py's `assert_gains_close`), diagonal and
dense with lux and f, at the swing-up's N = 100. And the wrapper's output
buffer at (4, 1). csrc/riccati_latency.cu's (4, 1) instantiations
are held against the plain version on the card
(tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.ops.pallas_packed import riccati_backward_pallas_packed  # noqa: E402
from altro_tpu.tvlqr import tvlqr_backward  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402

n, m = 4, 1


def _operands(N, seed, dense, fail_at=None):
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None] + 0.05 * rng.standard_normal((N, n, n))
    B = 0.2 * rng.standard_normal((N, n, m))
    f = 0.02 * rng.standard_normal((N, n))
    if dense:
        Wx = rng.standard_normal((N + 1, n, n))
        Wu = rng.standard_normal((N, m, m))
        lxx = np.einsum("kij,klj->kil", Wx, Wx) / n + np.eye(n)
        luu = np.einsum("kij,klj->kil", Wu, Wu) / m + np.eye(m)
        if fail_at is not None:
            luu[fail_at] = -10.0 * np.eye(m)
    else:
        lxx = np.abs(rng.standard_normal((N + 1, n))) + 0.5
        luu = np.abs(rng.standard_normal((N, m))) + 0.5
        if fail_at is not None:
            luu[fail_at] = -10.0
    lux = 0.05 * rng.standard_normal((N, m, n))
    lx = rng.standard_normal((N + 1, n))
    lu = rng.standard_normal((N, m))
    return A, B, f, lxx, luu, lux, lx, lu


# (dense, lux, f): JAX's diagonal fast path takes no cross term
VARIANTS = {"diag": (False, False, False), "diag_f": (False, False, True),
            "dense": (True, False, False), "dense_lux_f": (True, True, True)}


@pytest.mark.parametrize("dense,with_lux,with_f", list(VARIANTS.values()), ids=list(VARIANTS))
@pytest.mark.parametrize("N", [1, 65, 100])
def test_plain_matches_jax_scan_f64_4x1(N, dense, with_lux, with_f):
    for fail_at, reg in ((None, 0.01), (N // 2, 0.0)):
        A, B, f, lxx, luu, lux, lx, lu = _operands(N, 17 + N, dense, fail_at)
        lux = lux if with_lux else None
        ref = tvlqr_backward(A, B, f if with_f else np.zeros_like(f), lxx, luu, lux, lx, lu,
                             reg=reg, symmetrize=True)
        t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
        before = rl.LAUNCHES
        out = rl.riccati_latency(t(A), t(B), t(lxx), t(luu), t(lx), t(lu), reg, lux=t(lux),
                                 f=t(f) if with_f else None)
        assert rl.LAUNCHES == before
        assert bool(out.ok) == bool(ref.ok) == (fail_at is None)
        assert int(out.fail_index) == int(ref.fail_index)
        for got, want in ((out.K, ref.K), (out.d, ref.d), (out.P, ref.P), (out.p, ref.p),
                          (out.delta_V, ref.delta_V)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense_lux_f"])
def test_plain_matches_pallas_packed_interpret_f32_4x1(dense):
    A, B, f, lxx, luu, lux, lx, lu = (np.asarray(a, np.float32)
                                      for a in _operands(100, 5, dense))
    lux, f = (lux, f) if dense else (None, None)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = riccati_backward_pallas_packed(j(A), j(B), j(lxx), j(luu), j(lx), j(lu), reg=0.01,
                                         lux=j(lux), f=j(f), symmetrize=True, interpret=True)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    out = rl.riccati_latency(t(A), t(B), t(lxx), t(luu), t(lx), t(lu), 0.01, lux=t(lux), f=t(f))
    assert bool(out.ok) and bool(ref.ok)
    assert int(out.fail_index) == int(ref.fail_index) == 100
    atol = 5e-5
    np.testing.assert_allclose(out.K.numpy(), np.asarray(ref.K), atol=atol)
    np.testing.assert_allclose(out.d.numpy(), np.asarray(ref.d), atol=atol)
    np.testing.assert_allclose(out.P.numpy(), np.asarray(ref.P), atol=10 * atol)
    np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), atol=10 * atol)
    np.testing.assert_allclose(out.delta_V.numpy(), np.asarray(ref.delta_V), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("N", [1, 65, 100])
def test_kernel_outputs_aligned_at_4x1(N):
    """P, K, p, d and delta_V each start on a 16-byte boundary of one
    allocation, without overlap, for odd and even N (the copy warps store
    16 bytes a copy where a slice is aligned)."""
    assert (n, m) in rl.KERNEL_SHAPES
    g = rl.output_views(N, n, m, "cpu")
    shapes = {"K": (N, m, n), "d": (N, m), "P": (N + 1, n, n), "p": (N + 1, n),
              "delta_V": (2,), "ok": (), "fail_index": ()}
    for name, shape in shapes.items():
        assert tuple(getattr(g, name).shape) == shape
    base = g.P.untyped_storage().data_ptr()
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in g)
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in zip(spans, spans[1:]))
    for t in g[:5]:
        assert t.untyped_storage().data_ptr() == base and t.is_contiguous()
        assert (t.data_ptr() - base) % 16 == 0
