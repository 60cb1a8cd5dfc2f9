"""Dynamics models (PyTorch port of altro_tpu.models): the bicycle, the
double integrator, the pendulum, the quadrotor, the rocket and the
cart-pole, the explicit integrators and the rollout kernels' tile steps."""
