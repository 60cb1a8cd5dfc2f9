"""`models/quadrotor.quadrotor_jacobians` (the analytic Jacobians of the
quadrotor's scalar-form model) against the JAX package's and against
forward-mode differentiation of the port's model, in f64:
tests/test_models_extra.py:89's oracle (ten random states and inputs,
to 1e-12), for one lane and a batch (component-first), and as a
problem's `dynamics_jac` under rk4 (equal to `lane_jacobian` of the
step)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.quadrotor import quadrotor_jacobians as jjac  # noqa: E402
from altro_tpu_torch.models.quadrotor import (  # noqa: E402
    quadrotor_continuous,
    quadrotor_jacobians,
)
from altro_tpu_torch.problem import lane_jacobian  # noqa: E402


def _points(count=10, seed=7):
    rng = np.random.default_rng(seed)
    return 0.7 * rng.standard_normal((count, 12)), 2.4 + 0.5 * rng.standard_normal((count, 4))


def test_analytic_jacobians_match_jax_and_autodiff():
    f, jac, jj = quadrotor_continuous(), quadrotor_jacobians(), jjac()
    xs, us = _points()
    for x, u in zip(xs, us):
        A, B = jac(torch.as_tensor(x), torch.as_tensor(u))
        Aj, Bj = jj(jnp.asarray(x), jnp.asarray(u))
        Af, Bf = lane_jacobian(f, torch.as_tensor(x), torch.as_tensor(u))
        np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=0, atol=1e-12)
        np.testing.assert_allclose(B.numpy(), np.asarray(Bj), rtol=0, atol=1e-12)
        np.testing.assert_allclose(A.numpy(), Af.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(B.numpy(), Bf.numpy(), rtol=0, atol=1e-12)


def test_analytic_jacobians_batched():
    jac = quadrotor_jacobians()
    xs, us = _points(6, seed=3)
    A, B = jac(torch.as_tensor(xs.T), torch.as_tensor(us.T))
    assert A.shape == (12, 12, 6) and B.shape == (12, 4, 6)
    for b in range(6):
        Ab, Bb = jac(torch.as_tensor(xs[b]), torch.as_tensor(us[b]))
        np.testing.assert_allclose(A[..., b].numpy(), Ab.numpy(), rtol=0, atol=1e-15)
        np.testing.assert_allclose(B[..., b].numpy(), Bb.numpy(), rtol=0, atol=1e-15)
    assert A.dtype == torch.float64
    A32, _ = jac(torch.as_tensor(xs.T, dtype=torch.float32),
                 torch.as_tensor(us.T, dtype=torch.float32))
    assert A32.dtype == torch.float32
