"""Per-lane constraint masks through the port's batched solves, against
`jax.vmap(solve)` with `ConstraintSpec.active` batched, in f64 on the CPU
(tests/test_torch_per_lane_dynamics.py's fleet and checks): the control
bound's mask [N+1, B] one column per lane (from knot s in 0..3, none on
one lane in eight), every other leaf lane 0's, shared. The AL terms, the
violation norms and the dual update read each lane's column.
`solve_lanes` under the default search and the non-split grid,
`solve_tiled` against `jax.vmap(solve)` with the tiled options. Statuses,
iterations and ls_iterations equal lane for lane; x and u within 1e-9."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_per_lane_dynamics import SEARCHES, check  # noqa: E402


@pytest.mark.parametrize("search", list(SEARCHES))
def test_per_lane_masks_match_jax_vmap(search):
    check(("active",), search)
