"""Single-lane backward pass of the PyTorch port against altro_tpu.

The plain version (ops/riccati_latency.py::riccati_latency_ref) against
`altro_tpu.tvlqr.tvlqr_backward` in f64 (rtol 1e-10; the JAX scan takes
the expanded cost-to-go form with symmetrization, the port the Cholesky
identity, equal up to roundoff) and against the packed Pallas kernel
`riccati_backward_pallas_packed(interpret=True)` in f32 (K, d 5e-5;
P, p 5e-4, the tolerances of tests/test_pallas_packed.py). Dense and
diagonal costs, the cross term, the affine term, and failing knots, at
N <= 40. The dispatcher on CPU tensors is the plain version and counts
no launch; the CUDA kernel itself is held against the plain version in
tests/test_torch_kernels_cuda.py.
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
from altro_tpu_torch.ops.packed_backward import tvlqr_backward_latency  # noqa: E402

n, m = 4, 2


def _operands(N, seed, dense, fail_knots=()):
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None] + 0.05 * rng.standard_normal((N, n, n))
    B = 0.2 * rng.standard_normal((N, n, m))
    f = 0.02 * rng.standard_normal((N, n))
    if dense:
        W = rng.standard_normal((N + 1, n, n))
        lxx = np.einsum("kij,klj->kil", W, W) / n + np.eye(n)
        V = rng.standard_normal((N, m, m))
        luu = np.einsum("kij,klj->kil", V, V) / m + np.eye(m)
        for k in fail_knots:
            luu[k] = -1e3 * np.eye(m)
    else:
        lxx = np.abs(rng.standard_normal((N + 1, n))) + 0.5
        luu = np.abs(rng.standard_normal((N, m))) + 0.5
        for k in fail_knots:
            luu[k] = -10.0
    lux = 0.05 * rng.standard_normal((N, m, n))
    lx = rng.standard_normal((N + 1, n))
    lu = rng.standard_normal((N, m))
    return A, B, f, lxx, luu, lux, lx, lu


CASES = [
    # (name, N, dense, with lux, with f, reg, failing knots)
    ("dense_lux_f", 40, True, True, True, 0.01, ()),
    ("dense_no_lux", 25, True, False, False, 0.0, ()),
    ("diag", 30, False, False, False, 0.01, ()),
    ("diag_f", 30, False, False, True, 0.0, ()),
    ("diag_failing_knots", 30, False, False, False, 0.0, (7, 19)),
    ("dense_failing_knot", 20, True, True, True, 0.0, (4,)),
]


def _torch(a, dtype):
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("name,N,dense,with_lux,with_f,reg,fails", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_scan_f64(name, N, dense, with_lux, with_f, reg, fails):
    A, B, f, lxx, luu, lux, lx, lu = _operands(N, seed=len(name), dense=dense,
                                               fail_knots=fails)
    lux = lux if with_lux else None
    fz = f if with_f else np.zeros_like(f)
    ref = tvlqr_backward(A, B, fz, lxx, luu, lux, lx, lu, reg=reg, symmetrize=True)
    t = lambda a: _torch(a, torch.float64)  # noqa: E731
    before = rl.LAUNCHES
    out = tvlqr_backward_latency(t(A), t(B), t(f) if with_f else None, t(lxx), t(luu),
                                 t(lux), t(lx), t(lu), reg, symmetrize=True)
    assert rl.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert bool(out.ok) == bool(ref.ok) == (not fails)
    # a failed knot's K = d = 0 can make earlier knots fail too
    assert int(out.fail_index) == int(ref.fail_index) <= (min(fails) if fails else N)
    for k in fails:
        assert float(out.K[k].abs().max()) == 0.0 and float(out.d[k].abs().max()) == 0.0
    for got, want in ((out.K, ref.K), (out.d, ref.d), (out.P, ref.P), (out.p, ref.p),
                      (out.delta_V, ref.delta_V)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,N,dense,with_lux,with_f,reg,fails",
                         [c for c in CASES
                          if c[0] in ("dense_lux_f", "diag", "diag_failing_knots")],
                         ids=["dense_lux_f", "diag", "diag_failing_knots"])
def test_plain_matches_pallas_packed_interpret_f32(name, N, dense, with_lux, with_f, reg, fails):
    A, B, f, lxx, luu, lux, lx, lu = (
        None if a is None else np.asarray(a, np.float32)
        for a in _operands(N, seed=len(name), dense=dense, fail_knots=fails))
    lux = lux if with_lux else None
    f = f if with_f else None
    ref = riccati_backward_pallas_packed(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(lxx), jnp.asarray(luu), jnp.asarray(lx),
        jnp.asarray(lu), reg=reg, lux=None if lux is None else jnp.asarray(lux),
        f=None if f is None else jnp.asarray(f), symmetrize=True, interpret=True)
    t = lambda a: _torch(a, torch.float32)  # noqa: E731
    out = rl.riccati_latency(t(A), t(B), t(lxx), t(luu), t(lx), t(lu), reg, lux=t(lux), f=t(f))
    assert bool(out.ok) == bool(ref.ok)
    assert int(out.fail_index) == int(ref.fail_index)
    np.testing.assert_allclose(out.K.numpy(), np.asarray(ref.K), atol=5e-5)
    np.testing.assert_allclose(out.d.numpy(), np.asarray(ref.d), atol=5e-5)
    np.testing.assert_allclose(out.P.numpy(), np.asarray(ref.P), atol=5e-4)
    np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), atol=5e-4)
    np.testing.assert_allclose(out.delta_V.numpy(), np.asarray(ref.delta_V), rtol=1e-4, atol=1e-4)


def test_plain_is_the_batched_plain_backward_with_one_lane():
    """The single-lane plain version and the batched one (the batched
    kernel's plain twin) are the same recursion: equal bit for bit per
    lane."""
    from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref

    A, B, f, lxx, luu, lux, lx, lu = _operands(12, seed=3, dense=False, fail_knots=(5,))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    one = rl.riccati_latency_ref(t(A), t(B), t(lxx), t(luu), t(lx), t(lu), 0.0)
    lane = lambda a: t(a)[..., None]  # noqa: E731
    g = riccati_backward_ref(lane(A), lane(B), lane(lxx), lane(luu), lane(lx), lane(lu),
                             torch.zeros(1, dtype=torch.float64))
    assert torch.equal(one.K, g.K[..., 0]) and torch.equal(one.P, g.P[..., 0])
    assert int(one.fail_index) == int(g.fail_index[0]) == 5


@pytest.mark.parametrize("N", [1, 7, 64, 500])
def test_kernel_outputs_are_views_of_one_aligned_buffer(N):
    """The wrapper's outputs: the TVLQRGains shapes and dtypes, views of
    ONE allocation that do not overlap, P, K, p and d 16-byte aligned (the
    kernel's copy warps store them 16 bytes a copy)."""
    g = rl.output_views(N, n, m, "cpu")
    shapes = {"K": (N, m, n), "d": (N, m), "P": (N + 1, n, n), "p": (N + 1, n),
              "delta_V": (2,), "ok": (), "fail_index": ()}
    for name, shape in shapes.items():
        assert tuple(getattr(g, name).shape) == shape
    assert g.ok.dtype == torch.bool and g.fail_index.dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in g[:5])
    base = g.P.untyped_storage().data_ptr()
    spans = []
    for t in g:
        assert t.untyped_storage().data_ptr() == base and t.is_contiguous()
        spans.append((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()))
    spans.sort()
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in zip(spans, spans[1:]))
    for t in (g.P, g.K, g.p, g.d):
        assert (t.data_ptr() - base) % 16 == 0
    # the flags do not alias the floats: writing them leaves d and dV as set
    g.d.zero_()
    g.delta_V.zero_()
    g.fail_index.fill_(-1)
    g.ok.fill_(True)
    assert int(g.fail_index) == -1 and bool(g.ok)
    assert float(g.d.abs().sum()) == 0.0 == float(g.delta_V.abs().sum())


def test_operand_checks_name_the_operand():
    """_build's shared check: one expression for good operands, a raise
    naming the first bad one (the wrappers check reg / rhoi the same way,
    as a one-element operand the kernel reads from the device)."""
    from altro_tpu_torch.ops import _build

    A = torch.zeros((3, n, n))
    with pytest.raises(ValueError, match="riccati_latency kernel: A is not on a CUDA device"):
        _build.check_operands("riccati_latency", [("A", A, (3, n, n))])
    with pytest.raises(TypeError, match="lx must be float32"):
        _build.check_operands("riccati_latency", [("lx", A.double(), (3, n, n))])
    with pytest.raises(TypeError, match="reg must be float32"):
        _build.check_operands("riccati_latency", [("reg", torch.zeros(1, dtype=torch.int32), (1,))])
    assert not hasattr(_build, "scalar_operand")  # one contract: scalars by device pointer
