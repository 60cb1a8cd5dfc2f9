"""The port's quadrotor and rk4 against altro_tpu's.

`rk4(quadrotor_continuous())` and its Jacobians from
`problem.lane_jacobian` (forward mode over the 16 directions) against
JAX's `rk4` and `jax.jacfwd` at random states and inputs near hover, in
f64 to rtol 1e-12; the continuous model alone, and one batch of lanes
with a per-lane step against the same lanes one by one. f32 inputs give
f32 Jacobians.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.integrators import rk4 as jrk4  # noqa: E402
from altro_tpu.models.quadrotor import quadrotor_continuous as jquad  # noqa: E402
from altro_tpu_torch.models.integrators import rk4  # noqa: E402
from altro_tpu_torch.models.quadrotor import quadrotor_continuous  # noqa: E402
from altro_tpu_torch.problem import lane_jacobian  # noqa: E402

HOVER = 0.5 * 9.81 / 4.0


def _points(count, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((count, 12))
    u = HOVER + 0.2 * rng.standard_normal((count, 4))
    return x, u


@pytest.mark.parametrize("params", [{}, dict(mass=0.7, arm=0.2, inertia=(0.003, 0.002, 0.005))])
def test_continuous_model_matches_jax(params):
    x, u = _points(16)
    jf, tf = jquad(**params), quadrotor_continuous(**params)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(x), jnp.asarray(u)))
    got = tf(torch.as_tensor(x.T), torch.as_tensor(u.T)).numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_rk4_step_and_jacobians_match_jax():
    x, u = _points(16, seed=1)
    h = 0.05
    jstep, tstep = jrk4(jquad()), rk4(quadrotor_continuous())
    want = np.asarray(jax.vmap(lambda a, b: jstep(a, b, h, 0))(jnp.asarray(x), jnp.asarray(u)))
    jac = jax.vmap(jax.jacfwd(lambda a, b: jstep(a, b, h, 0), argnums=(0, 1)))
    JA, JB = (np.asarray(j) for j in jac(jnp.asarray(x), jnp.asarray(u)))
    xt, ut = torch.as_tensor(x.T), torch.as_tensor(u.T)
    got = tstep(xt, ut, h, 0).numpy().T
    A, B = lane_jacobian(tstep, xt, ut, h, 0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(A.permute(2, 0, 1).numpy(), JA, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(B.permute(2, 0, 1).numpy(), JB, rtol=1e-12, atol=1e-13)


def test_jacobians_of_a_knot_stack_and_f32():
    """[n, K, B] knot stacks with a per-knot step, as the solve calls it;
    float32 in, float32 Jacobians out."""
    x, u = _points(6, seed=2)
    xs = torch.as_tensor(x.T.reshape(12, 2, 3))
    us = torch.as_tensor(u.T.reshape(4, 2, 3))
    h = torch.tensor([[0.05], [0.02]], dtype=torch.float64)
    step = rk4(quadrotor_continuous())
    A, B = lane_jacobian(step, xs, us, h, 0)
    assert A.shape == (12, 12, 2, 3) and B.shape == (12, 4, 2, 3)
    for k in range(2):
        for b in range(3):
            Ak, Bk = lane_jacobian(step, xs[:, k, b], us[:, k, b], float(h[k, 0]), 0)
            np.testing.assert_allclose(A[:, :, k, b].numpy(), Ak.numpy(), rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(B[:, :, k, b].numpy(), Bk.numpy(), rtol=1e-12, atol=1e-14)
    A32, B32 = lane_jacobian(step, xs.float(), us.float(), h.float(), 0)
    assert A32.dtype == B32.dtype == torch.float32
    np.testing.assert_allclose(A32.numpy(), A.numpy(), rtol=1e-4, atol=1e-5)
