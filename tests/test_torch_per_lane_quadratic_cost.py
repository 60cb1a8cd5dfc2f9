"""A QuadraticCost with one row per lane through the port's batched
solves, against `jax.vmap(solve)` with those leaves batched, in f64 on
the CPU (tests/test_torch_per_lane_dynamics.py's fleet and checks): Q
[N+1, n, n, B], R [N+1, m, m, B], H [N+1, m, n, B], q, r and c per lane,
the dynamics and the mask lane 0's, shared; `solve_lanes` under the
default search and the non-split grid, `solve_tiled` against
`jax.vmap(solve)` with the tiled options. Statuses, iterations and
ls_iterations equal lane for lane; x and u within 1e-9."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_per_lane_dynamics import SEARCHES, check  # noqa: E402


@pytest.mark.parametrize("search", list(SEARCHES))
def test_per_lane_quadratic_cost_matches_jax_vmap(search):
    check(("Q", "R", "H", "q", "r", "c"), search)
