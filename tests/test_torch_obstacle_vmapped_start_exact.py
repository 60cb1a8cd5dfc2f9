"""The obstacle row from its tick 10 under the exact AL Hessian
(`exact_al_hessian=True`) against `jax.vmap(solve)` in float64 on the
CPU: test_torch_obstacle_vmapped_start.py's check, where the disc enters
the horizon and the obstacle row's curvature term is in play."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_obstacle_vmapped import check_row  # noqa: E402


def test_obstacle_row_exact_from_tick_10_matches_jax_vmap_solve():
    check_row(25, exact=True, start=10)
