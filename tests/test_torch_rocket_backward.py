"""The plain (6, 3) batched backward, dense, against altro_tpu's kernel.

Counterpart: altro_tpu/ops/pallas_riccati.py::riccati_backward_pallas_tiled
(pallas_call at :521), the backward of JAX's `solve_tiled` on the rocket
row's dense expansions (scripts/bench_all.py:732-843), run by the Pallas
interpreter on one 1024-lane tile in float32 (the kernel takes no other
type), as tests/test_pallas_riccati.py runs it. The port's plain version
(`riccati_backward_ref`, which csrc/riccati_dense.cu is held against on
the card) gets the same numpy inputs: dense SPD lxx / luu, with and
without the cross block lux, N=10, a per-lane reg, lane 3 failing at
knots 2 and 5 and lane 6 at the last knot. K, d to 2e-5 and P, p to 2e-4
(the tolerance of tests/test_torch_riccati.py's f32 case; the rocket's
unscaled blocks reach 10), ok and fail_index exactly.
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
from altro_tpu_torch.ops import riccati_backward as rb  # noqa: E402

Bsz, N, n, m = 1024, 10, 6, 3


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None, None] + 0.05 * rng.standard_normal((Bsz, N, n, n))
    Bm = 0.3 * rng.standard_normal((Bsz, N, n, m))

    def spd(count, d):
        Wm = rng.standard_normal((Bsz, count, d, d))
        return np.einsum("bkij,bklj->bkil", Wm, Wm) / d + np.eye(d)

    lxx, luu = spd(N + 1, n), spd(N, m)
    lux = 0.02 * rng.standard_normal((Bsz, N, m, n))
    lx = rng.standard_normal((Bsz, N + 1, n))
    lu = rng.standard_normal((Bsz, N, m))
    reg = 0.05 * rng.random(Bsz)
    luu[3, [2, 5]] = -10.0 * np.eye(m)
    luu[6, N - 1] = -10.0 * np.eye(m)
    return [np.asarray(a, np.float32) for a in (A, Bm, lxx, luu, lux, lx, lu, reg)]


def _lanes(a):
    return torch.as_tensor(np.moveaxis(a, 0, -1)).contiguous()


@pytest.mark.parametrize("with_lux", [False, True])
def test_plain_6x3_dense_backward_matches_pallas_kernel_interpret(with_lux):
    A, Bm, lxx, luu, lux, lx, lu, reg = _inputs()
    T = batch_to_tiles
    out = riccati_backward_pallas_tiled(
        *(T(jnp.asarray(a)) for a in (A, Bm, lxx, luu, lx, lu)),
        T(jnp.asarray(reg)[:, None])[:, 0], lux=T(jnp.asarray(lux)) if with_lux else None,
        diag_cost=False, interpret=True)
    got = rb.riccati_backward(*(_lanes(a) for a in (A, Bm, lxx, luu, lx, lu)),
                              torch.as_tensor(reg), lux=_lanes(lux) if with_lux else None)
    assert rb.LAUNCHES == 0  # CPU tensors: the plain version
    for name, atol in (("K", 2e-5), ("d", 2e-5), ("P", 2e-4), ("p", 2e-4)):
        ref = np.asarray(tiles_to_batch(getattr(out, name)))
        np.testing.assert_allclose(np.moveaxis(getattr(got, name).numpy(), -1, 0), ref,
                                   atol=atol, rtol=1e-4, err_msg=name)
    ok = np.asarray(tiles_to_batch(out.ok[:, None])[:, 0])
    fail = np.asarray(tiles_to_batch(out.fail_index[:, None])[:, 0])
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.fail_index.numpy(), fail)
    assert fail[3] == 2 and fail[6] == N - 1 and int((~ok).sum()) == 2
    dV = np.asarray(tiles_to_batch(out.delta_V))
    np.testing.assert_allclose(np.moveaxis(got.delta_V.numpy(), -1, 0), dV, rtol=1e-4, atol=1e-3)
