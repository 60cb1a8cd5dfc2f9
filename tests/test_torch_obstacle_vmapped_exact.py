"""The obstacle row under the exact AL Hessian (`exact_al_hessian=True`)
against `jax.vmap(solve)` in float64 on the CPU: test_torch_obstacle_
vmapped.py's check with the disc on the first knots of the path, where
the obstacle row's curvature term is in play at every resolve."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_obstacle_vmapped import check_row  # noqa: E402


def test_obstacle_row_exact_matches_jax_vmap_solve():
    check_row(-10, exact=True)
