"""Every leaf of the fleet one row per lane (dynamics, QuadraticCost,
mask) through `solve_lanes` and `rescue.vmap_solve_with_rescue` under the
default search and through `rescue.solve_tiled_with_rescue`, against
`jax.vmap(solve)` and its two tiers composed, in f64 on the CPU (tests/test_torch_per_lane_dynamics.py's
fleet and checks). The rescue's first tier has a budget of 4 iterations,
so most lanes fail it and take the second tier's 30 from their
post-solve state, as altro_tpu/rescue.py does: rescued lanes the second
tier's statuses and iterations summed, the others the first's; states and
inputs within 1e-9."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from altro_tpu.solver import init_state as jinit_state  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch import rescue  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.parallel.batch import batch_init_state  # noqa: E402
from test_torch_per_lane_dynamics import (  # noqa: E402
    ARRAYS,
    LEAVES,
    SEARCHES,
    TILED,
    assert_same,
    check,
    jax_vmapped,
    jax_problem,
    jopts,
    port_run,
)

import jax.numpy as jnp  # noqa: E402


def test_every_leaf_per_lane_matches_jax_vmap():
    check(rp.FLEET_LEAVES, "default")
    # vmap_solve_with_rescue (batch-major at its edges) takes the per-lane
    # leaves as the problem carries them: no lane fails, so no rescue runs
    # and the answer is the vmapped solve's
    prob = rp.fleet_problem(ARRAYS, dtype=torch.float64, device="cpu")
    x0 = tsv.lanes_to_batch(prob.x0)
    state = batch_init_state(dataclasses.replace(prob, x0=prob.x0[:, 0]), x0.shape[0])
    info = {}
    st, stats = rescue.vmap_solve_with_rescue(prob, x0, state, SEARCHES["default"],
                                              SEARCHES["default"], info)
    assert not info["rescued"]
    assert_same((st, stats), jax_vmapped(ARRAYS, rp.FLEET_LEAVES, SEARCHES["default"]))


def test_every_leaf_per_lane_rescue_matches_jax_tiers():
    first, second = TILED.replace(iterations_max=4), TILED.replace(iterations_max=30)
    args = [jnp.asarray(ARRAYS[k]) for k in LEAVES] + [jnp.asarray(ARRAYS["active"][0])]

    def tier(opts, state=None):
        def one(*a):
            prob = jax_problem(dict(zip(LEAVES, a[:-2])), a[-2])
            return jsolve(prob, jinit_state(prob) if state is None else a[-1], jopts(opts))

        if state is None:
            return jax.jit(jax.vmap(lambda *a: one(*a, None)))(*args)
        return jax.jit(jax.vmap(one))(*args, state)

    j_st, j_stats = tier(first)
    failed = np.asarray(j_stats.status) != 0
    assert failed.any() and not failed.all()
    r_st, r_stats = tier(second, j_st)
    st, stats = port_run(ARRAYS, rp.FLEET_LEAVES, first, "tiled", rescue_opts=second)
    want_status = np.where(failed, np.asarray(r_stats.status), np.asarray(j_stats.status))
    want_iters = np.asarray(j_stats.iterations) + np.where(failed, np.asarray(r_stats.iterations),
                                                           0)
    np.testing.assert_array_equal(stats.status.numpy(), want_status)
    np.testing.assert_array_equal(stats.iterations.numpy(), want_iters)
    for got, a, b in ((st.x, r_st.x, j_st.x), (st.u, r_st.u, j_st.u)):
        sel = failed[:, None, None]
        np.testing.assert_allclose(got.numpy(), np.where(sel, np.asarray(a), np.asarray(b)),
                                   rtol=0, atol=1e-9)
