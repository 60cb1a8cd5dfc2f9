"""The f32 accuracy ladder of tests/test_parallel_riccati.py:139 on the
port: the well-posed long-horizon tracking problem at N = 100, 500 and
1000, the port's associative backward in float32 (the pure scan and the
two-level form at chunk 32) against the port's serial pass in float64.
JAX's gate: relative max |dK| < 1e-5 (JAX measured 3-6e-7). JAX's own
associative pass is not run at these horizons (its compiles set the
suite's wall); chip_smoke.py runs the same ladder on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch import tvlqr as tt  # noqa: E402

GATE_REL_K = 1e-5


def ladder_problem(N, seed=7):
    """tests/test_parallel_riccati.py:139's arrays (numpy, float64)."""
    rng = np.random.default_rng(seed)
    n, m = 4, 2
    A = np.tile(np.eye(n), (N, 1, 1)) + 0.05 * rng.standard_normal((N, n, n))
    B = 0.3 * rng.standard_normal((N, n, m))
    f = 0.1 * rng.standard_normal((N, n))
    lxx = np.tile(np.diag([1e-2, 1e-2, 1e-6, 1e-6]), (N + 1, 1, 1))
    luu = np.tile(np.eye(m) * 1e-3, (N, 1, 1))
    lux = np.zeros((N, m, n))
    lx = 0.3 * rng.standard_normal((N + 1, n))
    lu = 0.01 * rng.standard_normal((N, m))
    return A, B, f, lxx, luu, lux, lx, lu


@pytest.mark.parametrize("N", [100, 500, 1000])
@pytest.mark.parametrize("chunk", [None, 32], ids=["pure", "chunk32"])
def test_f32_accuracy_ladder(N, chunk):
    args = ladder_problem(N)
    truth = tt.tvlqr_backward(*[torch.as_tensor(a)[None] for a in args])
    g = tt.tvlqr_backward_associative(*[torch.as_tensor(a, dtype=torch.float32) for a in args],
                                      chunk=chunk)
    assert bool(g.ok) and g.K.dtype == torch.float32
    Ks = float(truth.K.abs().max())
    relK = float((g.K.double() - truth.K[0]).abs().max()) / max(Ks, 1.0)
    assert relK < GATE_REL_K, relK
