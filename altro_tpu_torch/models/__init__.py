"""Dynamics models (PyTorch port of altro_tpu.models): the bicycle, the
double integrator, the pendulum, the quadrotor, the rocket and the
cart-pole, the explicit integrators and the rollout kernels' tile steps.
`midpoint`, `rk4` and `pendulum_continuous` are exported here, as the
JAX package's README Quick start imports them."""

from altro_tpu_torch.models.integrators import midpoint, rk4
from altro_tpu_torch.models.pendulum import pendulum_continuous

__all__ = ["midpoint", "rk4", "pendulum_continuous"]
