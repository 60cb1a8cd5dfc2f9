"""The port's vmapped solve under the non-split grid against
`jax.vmap(solve)`: tests/test_parallel.py's three oracles
(test_torch_vmap_solve_default.py's helpers) with
`parallel_linesearch=True` and `ls_phase_split=False`
(altro_tpu/linesearch.py:546-668: trial 0 passes on Armijo and strong
Wolfe, the rest on Armijo, the accepted trial's payload and dphi), with
`pallas_backward` off and on."""

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
def test_non_split_grid_matches_jax(jax_oracles, oracle, pallas):
    oracle(jax_oracles, "grid", pallas)
