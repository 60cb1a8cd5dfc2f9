"""The dense batched backward pass of the port (ops/riccati_dense.py)
against altro_tpu's `riccati_backward_pallas` and `vmap(tvlqr_backward)`.

On the CPU both wrappers run the plain version (the kernel,
csrc/riccati_dense.cu, runs only on the card: tests/test_torch_kernels_cuda.py).

* f32 at B=1024, N=4, (n, m) = (4, 2) with f and lux: the plain version
  and `riccati_backward_batch_major` against the Pallas kernel run by
  its interpreter, to the tolerances of tests/test_pallas_riccati.py
  (K, d atol 2e-5; P, p atol 2e-4; dV 2e-4).
* f64 at (12, 4), B=8, N=6: against `jax.vmap(tvlqr_backward)` to rtol
  1e-10, with and without f and lux.
* Per-lane failure flags and fail_index, and a per-lane reg.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.ops.pallas_riccati import riccati_backward_pallas  # noqa: E402
from altro_tpu.tvlqr import tvlqr_backward as jax_tvlqr_backward  # noqa: E402
from altro_tpu_torch.ops import riccati_dense as rd  # noqa: E402
from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref  # noqa: E402

FIELDS = ("K", "d", "P", "p", "delta_V")


def make_batch(Bsz, N, n, m, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(n), (Bsz, N, 1, 1)) + 0.02 * rng.standard_normal((Bsz, N, n, n))
    B = 0.3 * rng.standard_normal((Bsz, N, n, m))
    f = 0.05 * rng.standard_normal((Bsz, N, n))

    def spd(count, d):
        Wm = rng.standard_normal((Bsz, count, d, d))
        return np.einsum("bkij,bklj->bkil", Wm, Wm) / d + np.eye(d)

    lxx, luu = spd(N + 1, n), spd(N, m)
    lux = 0.02 * rng.standard_normal((Bsz, N, m, n))
    lx = rng.standard_normal((Bsz, N + 1, n))
    lu = rng.standard_normal((Bsz, N, m))
    return [a.astype(dtype) for a in (A, B, f, lxx, luu, lux, lx, lu)]


def _lanes(a):
    return None if a is None else torch.as_tensor(np.moveaxis(a, 0, -1)).contiguous()


def test_f32_matches_pallas_kernel_interpret():
    args = make_batch(1024, 4, 4, 2, seed=3, dtype=np.float32)
    reg = np.full(1024, 0.01, np.float32)
    out = riccati_backward_pallas(*args, reg=reg, interpret=True)
    got_b = rd.riccati_backward_batch_major(*(torch.as_tensor(a) for a in args),
                                            torch.as_tensor(reg))
    A, B, f, lxx, luu, lux, lx, lu = (_lanes(a) for a in args)
    got_l = riccati_backward_ref(A, B, lxx, luu, lx, lu, torch.as_tensor(reg), lux=lux, f=f)
    for name, atol in (("K", 2e-5), ("d", 2e-5), ("P", 2e-4), ("p", 2e-4)):
        want = np.asarray(getattr(out, name))
        np.testing.assert_allclose(getattr(got_b, name).numpy(), want, atol=atol, err_msg=name)
        np.testing.assert_allclose(np.moveaxis(getattr(got_l, name).numpy(), -1, 0), want,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got_b.delta_V.numpy(), np.asarray(out.delta_V),
                               rtol=2e-4, atol=2e-4)
    assert bool(got_b.ok.all()) and bool(np.asarray(out.ok).all())
    np.testing.assert_array_equal(got_b.fail_index.numpy(), np.asarray(out.fail_index))
    # the terminal rows of the PallasGains contract
    np.testing.assert_array_equal(got_b.P[:, -1].numpy(), args[3][:, -1])
    np.testing.assert_array_equal(got_b.p[:, -1].numpy(), args[6][:, -1])


@pytest.mark.parametrize("with_f_lux", [True, False])
def test_f64_quadrotor_blocks_match_vmapped_tvlqr(with_f_lux):
    A, B, f, lxx, luu, lux, lx, lu = make_batch(8, 6, 12, 4, seed=1)
    if not with_f_lux:
        f, lux = np.zeros_like(f), np.zeros_like(lux)
    reg = 0.05 * np.random.default_rng(2).random(8)
    want = jax.vmap(jax_tvlqr_backward)(*(jnp.asarray(a) for a in (A, B, f, lxx, luu, lux, lx, lu)),
                                        jnp.asarray(reg))
    t = torch.as_tensor
    fz, luxz = (t(f), t(lux)) if with_f_lux else (None, None)
    got = rd.riccati_backward_batch_major(t(A), t(B), fz, t(lxx), t(luu), luxz, t(lx), t(lu),
                                          t(reg))
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    assert bool(got.ok.all())
    np.testing.assert_array_equal(got.fail_index.numpy(), np.asarray(want.fail_index))


def test_failure_flags_and_per_lane_reg():
    """Lane 3 breaks at knots 2 and 4 (fail_index 2), lane 5 at the last
    knot; lane 6's indefinite knot passes with its own reg of 50 and
    fails with reg 0, while the zero-reg lanes keep their gains."""
    A, B, f, lxx, luu, lux, lx, lu = make_batch(8, 6, 12, 4, seed=4)
    luu[3, 2] = -10.0 * np.eye(4)
    luu[3, 4] = -10.0 * np.eye(4)
    luu[5, 5] = -10.0 * np.eye(4)
    luu[6, 1] = -8.0 * np.eye(4)
    reg = np.zeros(8)
    reg[6] = 50.0
    t = torch.as_tensor
    args = [t(a) for a in (A, B, f, lxx, luu, lux, lx, lu)]
    got = rd.riccati_backward_batch_major(*args, t(reg))
    want = jax.vmap(jax_tvlqr_backward)(*(jnp.asarray(a) for a in (A, B, f, lxx, luu, lux, lx, lu)),
                                        jnp.asarray(reg))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_array_equal(got.fail_index.numpy(), np.asarray(want.fail_index))
    assert got.ok.tolist() == [True, True, True, False, True, False, True, True]
    assert got.fail_index.tolist() == [6, 6, 6, 2, 6, 5, 6, 6]
    # a failed knot emits zero gains by select; its lane's history matches the scan
    assert float(got.K[3, 2].abs().max()) == 0.0 and float(got.d[3, 4].abs().max()) == 0.0
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    # a scalar reg equals the same value per lane
    same = rd.riccati_backward_batch_major(*args, 0.0)
    assert torch.equal(same.K[:6], got.K[:6]) and not torch.equal(same.ok, got.ok)


def test_lane_minor_wrapper_on_cpu_is_the_plain_version():
    A, B, f, lxx, luu, lux, lx, lu = (_lanes(a) for a in make_batch(5, 3, 4, 2, seed=5))
    reg = torch.full((5,), 0.1, dtype=torch.float64)
    before = rd.LAUNCHES
    g1 = rd.riccati_backward_dense(A, B, f, lxx, luu, lux, lx, lu, reg)
    g2 = riccati_backward_ref(A, B, lxx, luu, lx, lu, reg, lux=lux, f=f)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert rd.LAUNCHES == before
    assert (12, 4) in rd.KERNEL_SHAPES and (4, 2) in rd.KERNEL_SHAPES
