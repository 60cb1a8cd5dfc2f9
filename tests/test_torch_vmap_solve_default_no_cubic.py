"""The port's vmapped solve under the sequential backtracking search
against `jax.vmap(solve)`: tests/test_parallel.py's three oracles
(test_torch_vmap_solve_default.py's helpers) with
`use_backtracking_linesearch=True` and `ls_try_cubic_first=False`: the
sequential backtracking without the one-shot cubic trial, with
`pallas_backward` off and on (test_torch_vmap_solve_default_backtracking.py
runs it with cubic-first)."""

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
def test_backtracking_without_cubic_first_matches_jax(jax_oracles, oracle, pallas):
    oracle(jax_oracles, "backtracking_no_cubic", pallas)
