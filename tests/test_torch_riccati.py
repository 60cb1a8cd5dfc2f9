"""Batched Riccati backward pass of the PyTorch port against altro_tpu.

The plain version (ops/riccati_backward.py::riccati_backward_ref, reached
through tvlqr.tvlqr_backward) against `jax.vmap(tvlqr_backward)` in f64:
diagonal and dense costs, per-lane reg, the affine term f, and a lane
with an indefinite luu. K, d, P, p, dV to rtol 1e-10; ok and fail_index
exactly. One f32 case against the Pallas kernel
`riccati_backward_pallas_tiled` in interpret mode, to its own test's
tolerance (atol 2e-5, tests/test_pallas_riccati.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.ops.pallas_riccati import (  # noqa: E402
    batch_to_tiles,
    riccati_backward_pallas_tiled,
    tiles_to_batch,
)
from altro_tpu.tvlqr import tvlqr_backward as jax_tvlqr_backward  # noqa: E402
from altro_tpu_torch.ops import riccati_backward as rb  # noqa: E402
from altro_tpu_torch.tvlqr import tvlqr_backward  # noqa: E402


def make_batch(Bsz, N, n=4, m=2, seed=0, diag=False):
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(n), (Bsz, N, 1, 1)) + 0.05 * rng.standard_normal((Bsz, N, n, n))
    B = 0.3 * rng.standard_normal((Bsz, N, n, m))
    f = 0.05 * rng.standard_normal((Bsz, N, n))
    if diag:
        lxx = np.abs(rng.standard_normal((Bsz, N + 1, n))) + 0.1
        luu = np.abs(rng.standard_normal((Bsz, N, m))) + 0.1
        lux = None
    else:
        def spd(count, d):
            Wm = rng.standard_normal((Bsz, count, d, d))
            return np.einsum("bkij,bklj->bkil", Wm, Wm) / d + np.eye(d)

        lxx = spd(N + 1, n)
        luu = spd(N, m)
        lux = 0.02 * rng.standard_normal((Bsz, N, m, n))
    lx = rng.standard_normal((Bsz, N + 1, n))
    lu = rng.standard_normal((Bsz, N, m))
    reg = 0.05 * rng.random(Bsz)
    # lane 3 breaks at knots 2 and 5 (fail_index 2), lane 6 at the last knot
    bad = -10.0 * (np.ones(m) if diag else np.eye(m))
    luu[3, 2] = bad
    luu[3, 5] = bad
    luu[6, N - 1] = bad
    return A, B, f, lxx, luu, lux, lx, lu, reg


def _jax_ref(A, B, f, lxx, luu, lux, lx, lu, reg):
    args = [jnp.asarray(a) for a in (A, B, f, lxx, luu)]
    args.append(None if lux is None else jnp.asarray(lux))
    args += [jnp.asarray(lx), jnp.asarray(lu), jnp.asarray(reg)]
    in_axes = (0, 0, 0, 0, 0, None if lux is None else 0, 0, 0, 0)
    return jax.vmap(jax_tvlqr_backward, in_axes=in_axes)(*args)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("with_f", [True, False])
def test_ref_matches_vmapped_tvlqr(diag, with_f):
    A, B, f, lxx, luu, lux, lx, lu, reg = make_batch(16, 10, diag=diag)
    if not with_f:
        f = np.zeros_like(f)
    ref = _jax_ref(A, B, f, lxx, luu, lux, lx, lu, reg)
    got = tvlqr_backward(*(_t(a) for a in (A, B, f, lxx, luu, lux, lx, lu)), _t(reg))
    for name in ("K", "d", "P", "p", "delta_V"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.fail_index.numpy(), np.asarray(ref.fail_index))
    assert not got.ok[3] and int(got.fail_index[3]) == 2
    assert not got.ok[6] and int(got.fail_index[6]) == 9
    assert bool(got.ok[[0, 1, 2, 4, 5]].all())
    # P is symmetric by construction
    P = got.P.numpy()
    np.testing.assert_array_equal(P, np.swapaxes(P, -1, -2))


def test_wrapper_on_cpu_is_the_plain_version():
    A, B, f, lxx, luu, lux, lx, lu, reg = make_batch(8, 6, diag=True)
    lanes = [torch.as_tensor(np.moveaxis(a, 0, -1)).contiguous()
             for a in (A, B, lxx, luu, lx, lu, reg)]
    g1 = rb.riccati_backward(*lanes, diag_cost=True)
    g2 = rb.riccati_backward_ref(*lanes)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert rb.LAUNCHES == 0


def test_f32_matches_pallas_kernel_interpret():
    """f32 plain version vs the TPU kernel run by the Pallas interpreter."""
    Bsz, N = 1024, 6
    A, B, _, lxx, luu, _, lx, lu, reg = make_batch(Bsz, N, diag=True, seed=3)
    f32 = [np.asarray(a, np.float32) for a in (A, B, lxx, luu, lx, lu, reg)]
    A, B, lxx, luu, lx, lu, reg = f32
    out = riccati_backward_pallas_tiled(
        *(batch_to_tiles(jnp.asarray(a)) for a in (A, B, lxx, luu, lx, lu)),
        batch_to_tiles(jnp.asarray(reg)[:, None])[:, 0],
        lux=None, diag_cost=True, interpret=True)
    lanes = [torch.as_tensor(np.moveaxis(a, 0, -1)).contiguous()
             for a in (A, B, lxx, luu, lx, lu, reg)]
    got = rb.riccati_backward_ref(*lanes)
    for name, atol in (("K", 2e-5), ("d", 2e-5), ("P", 2e-4), ("p", 2e-4)):
        ref = np.asarray(tiles_to_batch(getattr(out, name)))
        mine = np.moveaxis(getattr(got, name).numpy(), -1, 0)
        np.testing.assert_allclose(mine, ref, atol=atol, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(tiles_to_batch(out.ok[:, None])[:, 0]))
    np.testing.assert_array_equal(
        got.fail_index.numpy(), np.asarray(tiles_to_batch(out.fail_index[:, None])[:, 0]))
