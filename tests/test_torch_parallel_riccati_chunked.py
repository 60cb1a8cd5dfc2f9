"""The port's two-level (span-capped) associative TVLQR backward pass,
`tvlqr_backward_associative(..., chunk=L)`, in float64 on identical numpy
inputs: against JAX's two-level form at N in {10, 50} x chunk in {4, 16}
(rtol and atol 1e-9, delta_V rtol 1e-8), and over JAX's whole (N <= 100)
x chunk {1, 4, 16, 64} grid of tests/test_parallel_riccati.py (chunks
that do not divide N + 1, and chunk >= N + 1, which is the pure scan)
against the port's serial pass at JAX's 1e-8.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch import tvlqr as tt  # noqa: E402

pr = pytest.importorskip("test_parallel_riccati")
ap = pytest.importorskip("test_torch_parallel_riccati")


@pytest.mark.parametrize("N", [10, 50])
@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_backward_matches_jax(N, chunk):
    args = pr.random_lqr(N, n=4, m=2, seed=N)
    g = tt.tvlqr_backward_associative(*ap._torch(args), chunk=chunk)
    ap._assert_close(g, ap.jbackward(*args, chunk=chunk), 1e-9, 1e-8)


@pytest.mark.parametrize("N", [1, 2, 3, 10, 50, 100])
@pytest.mark.parametrize("chunk", [1, 4, 16, 64])
def test_chunked_backward_matches_serial(N, chunk):
    """JAX's grid of test_backward_chunked_equivalence, held to the port's
    serial pass (batch-major, one lane)."""
    args = ap._torch(pr.random_lqr(N, n=4, m=2, seed=N))
    g = tt.tvlqr_backward_associative(*args, chunk=chunk)
    s = tt.tvlqr_backward(*[a[None] for a in args])
    assert bool(g.ok) and bool(s.ok[0]) and int(g.fail_index) == N
    for name in ("P", "K", "d"):
        np.testing.assert_allclose(getattr(g, name).numpy(), getattr(s, name)[0].numpy(),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
    np.testing.assert_allclose(g.delta_V.numpy(), s.delta_V[0].numpy(), rtol=1e-7, atol=1e-8)
