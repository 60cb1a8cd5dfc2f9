"""`tvlqr.tvlqr_forward` (the affine closed-loop rollout of the linearized
dynamics and its dual estimate) against `altro_tpu.tvlqr.tvlqr_forward` in
f64: one lane and a batch (batch-major, as `tvlqr_backward`), on gains
from the port's own backward pass, within 1e-12; and the TVLQR goldens of
tests/test_merit.py::test_tvlqr_through_expansions on its linear problem."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.tvlqr import tvlqr_forward as jforward  # noqa: E402
from altro_tpu_torch.tvlqr import tvlqr_backward, tvlqr_forward  # noqa: E402


def _operands(Bsz, N=12, n=4, m=2, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.1 * rng.standard_normal((Bsz, N, n, n))
    B = 0.3 * rng.standard_normal((Bsz, N, n, m))
    f = 0.05 * rng.standard_normal((Bsz, N, n))
    lxx = np.abs(rng.standard_normal((Bsz, N + 1, n))) + 0.5
    luu = np.abs(rng.standard_normal((Bsz, N, m))) + 0.5
    lx, lu = rng.standard_normal((Bsz, N + 1, n)), rng.standard_normal((Bsz, N, m))
    x0 = rng.standard_normal((Bsz, n))
    t = [torch.as_tensor(a) for a in (A, B, f, lxx, luu, lx, lu)]
    g = tvlqr_backward(t[0], t[1], t[2], t[3], t[4], None, t[5], t[6], reg=0.0)
    return A, B, f, g, x0


@pytest.mark.parametrize("Bsz", [1, 5])
def test_tvlqr_forward_matches_jax(Bsz):
    A, B, f, g, x0 = _operands(Bsz)
    got = tvlqr_forward(*(torch.as_tensor(a) for a in (A, B, f)), g.K, g.d, g.P, g.p,
                        torch.as_tensor(x0))
    for b in range(Bsz):
        want = jforward(*(jnp.asarray(a[b]) for a in (A, B, f)),
                        *(jnp.asarray(t[b].numpy()) for t in (g.K, g.d, g.P, g.p)),
                        jnp.asarray(x0[b]))
        one = tvlqr_forward(*(torch.as_tensor(a[b]) for a in (A, B, f)),
                            *(t[b] for t in (g.K, g.d, g.P, g.p)), torch.as_tensor(x0[b]))
        for gb, o, w in zip(got, one, want):
            np.testing.assert_allclose(gb[b].numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(o.numpy(), gb[b].numpy(), rtol=1e-14, atol=1e-14)


def test_tvlqr_forward_goldens_on_the_merit_problem():
    """tests/test_merit.py:100-120's goldens: the LQR gains of its linear
    double integrator (with the affine term), rolled forward."""
    from test_torch_linear_dynamics import port_problem

    from altro_tpu_torch.ops.tile_iter import cost_expansions_tiled

    prob, xref, uref = port_problem()
    N = prob.N
    zx, zu = torch.zeros_like(xref), torch.zeros_like(uref)
    lx, lu, lxx, luu, _, _ = cost_expansions_tiled(prob, zx[..., None], zu[..., None], (),
                                                   torch.ones(1, dtype=torch.float64), diag=True)
    g = tvlqr_backward(prob.A[None], prob.B[None], prob.f_aff[None], lxx[..., 0][None],
                       luu[..., 0][None], None, lx[..., 0][None], lu[..., 0][None])
    K0 = np.array([[0.7753129718046554, 0.0, 5.840445640045901, 0.0],
                   [0.0, 0.7753129718046554, 0.0, 5.840445640045901]])
    np.testing.assert_allclose(g.K[0, 0].numpy(), K0, atol=1e-6)
    x, u, y = tvlqr_forward(prob.A, prob.B, prob.f_aff, g.K[0], g.d[0], g.P[0], g.p[0], prob.x0)
    xN = np.array([20.165445369740308, -0.13732391651279308, -2.3724421496097037,
                   2.3113121303468707])
    yN = np.array([2218.2089906714345, -15.09563081640724, -260.9586364570674, 254.2543343381558])
    assert x.shape == (N + 1, 4) and u.shape == (N, 2)
    np.testing.assert_allclose(x[-1].numpy(), xN, atol=1e-6)
    np.testing.assert_allclose(y[-1].numpy(), yN, atol=1e-5)
