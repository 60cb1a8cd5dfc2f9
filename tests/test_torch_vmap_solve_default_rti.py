"""The port's vmapped real-time iteration without the phase split against
`jax.vmap(solve)`: tests/test_parallel.py's three oracles
(test_torch_vmap_solve_default.py's helpers) with `rti_mode=True` and
`ls_phase_split=False`, where JAX's RTI step takes the full step through
the whole merit function, dphi included (altro_tpu/solver.py:862-889),
and `pallas_backward` off and on;
test_torch_vmap_solve_default_rti_armijo_only.py adds `ls_armijo_only`,
which that step does not read."""

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
def test_rti_without_phase_split_matches_jax(jax_oracles, oracle, pallas):
    oracle(jax_oracles, "rti_non_split", pallas)
