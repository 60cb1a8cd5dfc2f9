"""tests/test_obstacle_mpc.py's single-lane loop under the exact AL Hessian
(`exact_al_hessian=True`, the single-lane solve's dense expansions with
`al.al_hess_exact`) against the JAX package's loop in float64: statuses
and iterations equal tick for tick, distances and tracking errors within
1e-8, over the first 6 ticks. There every resolve runs its 30 iterations
without converging (MAX_ITERATIONS in both packages, the disc at the end
of the window), and the cubic-first backtracking's interpolated steps
amplify the two implementations' roundoff: 1e-12 in the plant at tick 1,
8e-8 at tick 6, 5e-5 at tick 7, after which the two loops' iteration
counts part (the cart-pole's single-lane solve shows the same from its
ninth iteration)."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_obstacle_loop import check_loop  # noqa: E402


def test_obstacle_loop_exact_matches_jax():
    res = check_loop(True, exact=True, ticks=6)
    assert max(res.iterations) == 30  # the exact Hessian's resolves run to the budget here
