"""The obstacle row from a later tick (`mpc.run_obstacle_mpc(start=10)`:
the plant at ref.x[10] plus the starts' noise, that tick's window as the
warm start and the cost rows) against `jax.vmap(solve)` from the same
tick in float64 on the CPU: test_torch_obstacle_vmapped.py's check under
the Gauss-Newton AL Hessian (the exact one: test_torch_obstacle_vmapped_
start_exact.py). At tick 10 the disc enters the horizon, so every
resolve swerves."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_obstacle_vmapped import check_row  # noqa: E402


def test_obstacle_row_from_tick_10_matches_jax_vmap_solve():
    check_row(25, exact=False, start=10)
