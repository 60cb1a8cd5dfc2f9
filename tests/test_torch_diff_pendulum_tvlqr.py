"""tests/test_diff.py's pendulum (:110) on the port with method "tvlqr":
the Gauss-Newton gradient, the derivative of the iLQR fixed point, equals
JAX's to rtol 1e-8 and is within test_diff.py's 2e-2 of the finite
differences (tests/test_torch_diff_pendulum.py has the problem)."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_diff_pendulum import check_pendulum  # noqa: E402


def test_pendulum_grad_tvlqr_close():
    check_pendulum("tvlqr", 2e-2)
