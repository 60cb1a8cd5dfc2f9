"""The latency model of chip_smoke.py (`CHAIN_MODEL`, `CRITICAL_PATH`,
`chain_floor_ms`, `critical_path_ms`) for the quadrotor's two rollout
kernels, csrc/trial_rollout.cu's `trial_rollout_quadrotor_kernel` and
csrc/rollout_grid.cu's `rollout_grid_quadrotor_kernel`: the entries exist,
give the values their comment documents at the row's N=30 and a fixed
1,980 MHz clock, and no kernel's critical path exceeds its chain floor.
Pure Python; no solve runs here."""

import pytest

import chip_smoke as cs

QUAD = ("trial_rollout_quadrotor", "rollout_grid_quadrotor")
CLOCK_MHZ = 1980.0


@pytest.mark.parametrize("name", QUAD)
def test_quadrotor_entries_exist(name):
    path, loads, issued = cs.CHAIN_MODEL[name]
    assert all(isinstance(v, int) and v > 0 for v in (path, loads, issued))
    # the design's path is the work's own plus its selects, never shorter
    assert cs.CRITICAL_PATH[name] <= path


# N=30 knots at 1,980 MHz: the trial kernel's chain warp issues 491 a knot
# (over 89 x 4 + 4 x 30 = 476 cycles of path), the grid's busiest
# scheduler 1,222; the work's own path is 85 x 4 cycles a knot
@pytest.mark.parametrize("name, floor_ms", [
    ("trial_rollout_quadrotor", 30 * 491 / 1980e3),
    ("rollout_grid_quadrotor", 30 * 1222 / 1980e3),
])
def test_chain_floor_documented(name, floor_ms):
    assert cs.chain_floor_ms(name, 30, CLOCK_MHZ) == pytest.approx(floor_ms, rel=1e-12)
    assert cs.chain_floor_ms(name, 30, CLOCK_MHZ) == pytest.approx(
        {"trial_rollout_quadrotor": 0.0074393939, "rollout_grid_quadrotor": 0.0185151515}[name],
        abs=1e-10)


@pytest.mark.parametrize("name", QUAD)
def test_critical_path_documented(name):
    assert cs.critical_path_ms(name, 30, CLOCK_MHZ) == pytest.approx(30 * 85 * 4 / 1980e3,
                                                                      rel=1e-12)
    assert cs.critical_path_ms(name, 30, CLOCK_MHZ) == pytest.approx(0.0051515152, abs=1e-10)


@pytest.mark.parametrize("name", sorted(cs.CRITICAL_PATH))
@pytest.mark.parametrize("N, clock", [(1, 1000.0), (30, CLOCK_MHZ), (500, 1755.0)])
def test_critical_path_within_chain_floor(name, N, clock):
    assert cs.critical_path_ms(name, N, clock) <= cs.chain_floor_ms(name, N, clock)
