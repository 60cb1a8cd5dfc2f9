"""The single-lane backward at (n, m) = (3, 2): the facade's heterogeneous
problem (tests/test_hetero_dims.py) padded to its largest knot, the first
odd n the latency kernel takes.

The plain version (ops/riccati_latency.py::riccati_latency_ref, what
`riccati_latency` runs on CPU tensors), in every one of the 16 variants
csrc/riccati_latency.cu instantiates (diagonal or dense lxx and luu, with
and without lux and f), with a failing knot and without, at N = 10 (the
hetero problem's) and 65 (past one 64-knot chunk): against
`altro_tpu.tvlqr.tvlqr_backward` in f64 (the diagonals given expanded),
K, d, P, p and delta_V within 1e-10, ok and fail_index equal; and against
the packed Pallas kernel `riccati_backward_pallas_packed(interpret=True)`
(which takes the diagonals as they are) in f32, to the tolerances of
tests/test_torch_latency_backward_4x1.py (test_torch_latency_backward_
3x2_packed.py and _packed_diag.py) (the kernel is an f32 design:
in f64 it agrees to 2.4e-7 only). And the wrapper's
output buffer at (3, 2) (every array 16-byte aligned although n is odd).
The (3, 2) instantiations are held against this plain version on the
card (tests/test_torch_kernels_cuda.py).
"""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.ops.pallas_packed import riccati_backward_pallas_packed  # noqa: E402
from altro_tpu.tvlqr import tvlqr_backward  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402

n, m = 3, 2
VARIANTS = list(itertools.product((False, True), repeat=4))  # (diag_x, diag_u, lux, f)


def _operands(N, seed, diag_x, diag_u, fail_at=None):
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None] + 0.05 * rng.standard_normal((N, n, n))
    B = 0.2 * rng.standard_normal((N, n, m))
    f = 0.02 * rng.standard_normal((N, n))
    Wx, Wu = rng.standard_normal((N + 1, n, n)), rng.standard_normal((N, m, m))
    lxx = (np.abs(rng.standard_normal((N + 1, n))) + 0.5 if diag_x
           else np.einsum("kij,klj->kil", Wx, Wx) / n + np.eye(n))
    luu = (np.abs(rng.standard_normal((N, m))) + 0.5 if diag_u
           else np.einsum("kij,klj->kil", Wu, Wu) / m + np.eye(m))
    if fail_at is not None:
        luu[fail_at] = -10.0 if diag_u else -10.0 * np.eye(m)
    lux = 0.05 * rng.standard_normal((N, m, n))
    lx, lu = rng.standard_normal((N + 1, n)), rng.standard_normal((N, m))
    return A, B, f, lxx, luu, lux, lx, lu


IDS = ["".join(k for k, on in zip("xulf", v) if on) or "dense" for v in VARIANTS]


def _dense(a):
    return np.stack([np.diag(r) for r in a]) if a.ndim == 2 else a


def check_packed(diag_x, diag_u, with_lux, with_f):
    """The plain version against the packed Pallas kernel in interpret mode,
    f32, N = 65 (test_torch_latency_backward_3x2_packed*.py run it)."""
    N = 65
    A, B, f, lxx, luu, lux, lx, lu = (np.asarray(a, np.float32)
                                      for a in _operands(N, 5, diag_x, diag_u))
    lux, f = (lux if with_lux else None), (f if with_f else None)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = riccati_backward_pallas_packed(j(A), j(B), j(lxx), j(luu), j(lx), j(lu), reg=0.01,
                                         lux=j(lux), f=j(f), symmetrize=True, interpret=True)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    out = rl.riccati_latency(t(A), t(B), t(lxx), t(luu), t(lx), t(lu), 0.01, lux=t(lux), f=t(f))
    assert bool(out.ok) and bool(ref.ok)
    assert int(out.fail_index) == int(ref.fail_index) == N
    atol = 5e-5
    np.testing.assert_allclose(out.K.numpy(), np.asarray(ref.K), atol=atol)
    np.testing.assert_allclose(out.d.numpy(), np.asarray(ref.d), atol=atol)
    np.testing.assert_allclose(out.P.numpy(), np.asarray(ref.P), atol=10 * atol)
    np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), atol=10 * atol)
    np.testing.assert_allclose(out.delta_V.numpy(), np.asarray(ref.delta_V), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("diag_x,diag_u,with_lux,with_f", VARIANTS, ids=IDS)
@pytest.mark.parametrize("N", [10, 65])
def test_plain_matches_jax_scan_f64_3x2(N, diag_x, diag_u, with_lux, with_f):
    for fail_at, reg in ((None, 0.01), (N // 2, 0.0)):
        A, B, f, lxx, luu, lux, lx, lu = _operands(N, 31 + N, diag_x, diag_u, fail_at)
        ref = tvlqr_backward(A, B, f if with_f else np.zeros_like(f), _dense(lxx),
                             _dense(luu), lux if with_lux else np.zeros_like(lux), lx, lu,
                             reg=reg, symmetrize=True)
        t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
        before = rl.LAUNCHES
        out = rl.riccati_latency(t(A), t(B), t(lxx), t(luu), t(lx), t(lu), reg,
                                 lux=t(lux) if with_lux else None, f=t(f) if with_f else None)
        assert rl.LAUNCHES == before  # CPU tensors: the plain version
        assert bool(out.ok) == bool(ref.ok) == (fail_at is None)
        assert int(out.fail_index) == int(ref.fail_index) == (N if fail_at is None else fail_at)
        for name in ("K", "d", "P", "p", "delta_V"):
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                       rtol=1e-10, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("N", [1, 10, 65])
def test_kernel_outputs_aligned_at_3x2(N):
    assert (n, m) in rl.KERNEL_SHAPES
    g = rl.output_views(N, n, m, "cpu")
    base = g.P.untyped_storage().data_ptr()
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in g)
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in zip(spans, spans[1:]))
    for t in g[:5]:
        assert t.untyped_storage().data_ptr() == base and t.is_contiguous()
        assert (t.data_ptr() - base) % 16 == 0
