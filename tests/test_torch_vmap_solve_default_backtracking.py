"""The port's vmapped solve under the sequential backtracking search
against `jax.vmap(solve)`: tests/test_parallel.py's three oracles
(test_torch_vmap_solve_default.py's helpers) with
`use_backtracking_linesearch=True`, the search examples/batched_mpc.py
runs, with cubic-first (the solver's default), with `pallas_backward`
off and on (test_torch_vmap_solve_default_no_cubic.py runs it without
cubic-first)."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_vmap_solve_default import (  # noqa: E402
    check_poisoned_lane,
    check_tracking,
    check_vmap_solve,
    oracle_cache,
)


@pytest.fixture(scope="module")
def jax_oracles():
    return oracle_cache()


@pytest.mark.parametrize("pallas", [False, True], ids=["plain_backward", "pallas_backward"])
@pytest.mark.parametrize("oracle", [check_vmap_solve, check_poisoned_lane, check_tracking],
                         ids=["vmap_solve", "poisoned_lane", "batched_tracking"])
def test_sequential_backtracking_matches_jax(jax_oracles, oracle, pallas):
    oracle(jax_oracles, "backtracking", pallas)
