"""The single-lane backward at (n, m) = (12, 4), the quadrotor's shape.

The plain version (ops/riccati_latency.py::riccati_latency_ref, what
`riccati_latency` runs on CPU tensors) against `altro_tpu.tvlqr.
tvlqr_backward` in f64 (rtol 1e-10), diagonal and dense costs, the cross
and affine terms, with and without a failing knot, at N = 1 and 30; and
against the packed Pallas kernel `riccati_backward_pallas_packed(
interpret=True)` on tests/test_pallas_packed.py's quadrotor case (N=20,
seed 17; its two-row-group path) in f32, K and d to 1e-4. And the
wrapper's output buffer at (12, 4). csrc/riccati_latency.cu's (12, 4)
instantiations are held against the plain version on the card
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

n, m = 12, 4


def _packed_case(N, seed):
    """tests/test_pallas_packed.py::make_problem, float32, in its draw order."""
    rng = np.random.default_rng(seed)
    A = (np.tile(np.eye(n, dtype=np.float32), (N, 1, 1))
         + 0.05 * rng.standard_normal((N, n, n)).astype(np.float32))
    B = 0.2 * rng.standard_normal((N, n, m)).astype(np.float32)
    f = 0.02 * rng.standard_normal((N, n)).astype(np.float32)

    def spd(count, d):
        Wm = rng.standard_normal((count, d, d)).astype(np.float32)
        return np.einsum("kij,klj->kil", Wm, Wm) / d + np.eye(d, dtype=np.float32)

    lxx = spd(N + 1, n)
    luu = spd(N, m)
    lux = 0.05 * rng.standard_normal((N, m, n)).astype(np.float32)
    lx = rng.standard_normal((N + 1, n)).astype(np.float32)
    lu = rng.standard_normal((N, m)).astype(np.float32)
    return A, B, f, lxx, luu, lux, lx, lu


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
@pytest.mark.parametrize("N", [1, 30])
def test_plain_matches_jax_scan_f64_12x4(N, dense, with_lux, with_f):
    for fail_at, reg in ((None, 0.01), (N // 2, 0.0)):
        A, B, f, lxx, luu, lux, lx, lu = _operands(N, 11 + N, dense, fail_at)
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


def test_plain_matches_pallas_packed_interpret_f32_12x4():
    A, B, f, lxx, luu, lux, lx, lu = _packed_case(20, 17)
    j = jnp.asarray
    ref = riccati_backward_pallas_packed(j(A), j(B), j(lxx), j(luu), j(lx), j(lu), reg=0.01,
                                         lux=j(lux), f=j(f), symmetrize=True, interpret=True)
    t = torch.as_tensor
    out = rl.riccati_latency(t(A), t(B), t(lxx), t(luu), t(lx), t(lu), 0.01, lux=t(lux), f=t(f))
    assert bool(out.ok) and bool(ref.ok)
    assert int(out.fail_index) == int(ref.fail_index) == 20
    np.testing.assert_allclose(out.K.numpy(), np.asarray(ref.K), atol=1e-4)
    np.testing.assert_allclose(out.d.numpy(), np.asarray(ref.d), atol=1e-4)
    np.testing.assert_allclose(out.P.numpy(), np.asarray(ref.P), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("N", [1, 30, 31])
def test_kernel_outputs_aligned_at_12x4(N):
    """P, K, p, d and delta_V each start on a 16-byte boundary of one
    allocation, without overlap (the copy warps store 16 bytes a copy
    where a slice is aligned)."""
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
