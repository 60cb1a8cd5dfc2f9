"""The port's vmapped solve under the reference's line searches, against
`jax.vmap(solve)`: the three oracles of tests/test_parallel.py.

On the goal-constrained double integrator (tests/test_parallel.py's
`di_problem`, OPTS = SolverOptions(penalty_scaling=100.0)), in f64:

* `vmap_solve` matches JAX's per lane over four starts, and so does
  `solve_lanes` on the same lanes lane-minor;
* a lane started at 1e8 does not poison the others: they succeed, and
  every lane, the 1e8 one too, ends as JAX's does;
* `batched_tracking_solver` with q and c that differ per lane (each lane
  tracks its own reference) matches JAX's over eight lanes.

Statuses, iterations and ls_iterations exact; x, u and stats.alpha to
1e-9, stats.dphi to 1e-8. This file runs the strong-Wolfe cubic search
(the default options); test_torch_vmap_solve_default_backtracking.py,
test_torch_vmap_solve_default_no_cubic.py and
test_torch_vmap_solve_default_grid.py run the sequential backtracking
with and without cubic-first and the non-split grid through the same
helpers, test_torch_vmap_solve_default_rti.py the real-time iteration
without the phase split. Each search with `pallas_backward` off and on (on the CPU, the
dense backward's plain version with dense expansions; JAX's custom_vmap
falls back to the vmapped scan there).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.double_integrator import double_integrator_dynamics as jdyn  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel import batch as jbatch  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import DiagonalCost as JCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.parallel import batch  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402

N, NX, NU = rp.DI_N, 4, 2
B, B_TRACK = 4, 8
OPTS = dict(penalty_scaling=100.0)
SEARCHES = {
    "wolfe": {},
    "backtracking": dict(use_backtracking_linesearch=True),
    "backtracking_no_cubic": dict(use_backtracking_linesearch=True, ls_try_cubic_first=False),
    "grid": dict(use_backtracking_linesearch=True, parallel_linesearch=True),
    "rti_non_split": dict(rti_mode=True, ls_phase_split=False),
    "rti_non_split_armijo_only": dict(rti_mode=True, ls_phase_split=False, ls_armijo_only=True),
}


def _x0_batch(batch):
    """tests/test_parallel.py::x0_batch."""
    deltas = np.linspace(-0.5, 0.5, batch)[:, None] * np.array([1.0, -1.0, 0.0, 0.0])
    return np.array([1.0, 2.0, 0.0, 0.0])[None] + deltas


def _poisoned():
    x0 = _x0_batch(B)
    x0[2] = 1e8
    return x0


def _tracking_rows():
    """Per-lane q [B, N+1, n] and c [B, N+1]: lane b tracks its own
    reference x_ref_b (0.2 N(0, 1), numpy seed 5) under Q = 1."""
    x_ref = 0.2 * np.random.default_rng(5).standard_normal((B_TRACK, N + 1, NX))
    return -x_ref, 0.5 * np.sum(x_ref * x_ref, axis=2)


def _options(search, pallas):
    return dict(OPTS, pallas_backward=pallas, **SEARCHES[search])


def _jax_problem():
    goal = JSpec(fn=lambda x, u, k: x - jnp.zeros(NX), cone=JCone.ZERO, dim=NX,
                 active=jnp.zeros(N + 1, bool).at[N].set(True), label="goal")
    cost = JCost(Q=jnp.ones((N + 1, NX)), R=jnp.full((N + 1, NU), 1e-2),
                 q=jnp.zeros((N + 1, NX)), r=jnp.zeros((N + 1, NU)), c=jnp.zeros(N + 1))
    return JProblem(N=N, n=NX, m=NU, dynamics=jdyn(2), dynamics_jac=None, constraints=(goal,),
                    cost=cost, h=jnp.full(N, rp.DI_H), x0=jnp.asarray(_x0_batch(B)[0]))


def _port_problem():
    goal = rp.di_goal_constraint(np.zeros(NX), dtype=torch.float64, device="cpu")
    return rp.double_integrator_problem(_x0_batch(B)[0], [goal], dtype=torch.float64,
                                        device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_runs(search, pallas):
    """JAX's vmap_solve on the clean and the poisoned starts, and its
    batched_tracking_solver on the per-lane rows (one compile each)."""
    prob, opts = _jax_problem(), JOpts(**_options(search, pallas))
    runner = jbatch.vmap_solve(prob, opts)
    states = jbatch.batch_init_state(prob, B)
    out = {"clean": _np(runner(jnp.asarray(_x0_batch(B)), states)),
           "poisoned": _np(runner(jnp.asarray(_poisoned()), states))}
    q, c = _tracking_rows()
    track = jbatch.batched_tracking_solver(prob, opts)
    out["tracking"] = _np(track(jnp.asarray(_x0_batch(B_TRACK)), jnp.asarray(q), jnp.asarray(c),
                                jbatch.batch_init_state(prob, B_TRACK)))
    return out


def _assert_lanes(stats, st, j_stats, j_st, lanes=None, what=""):
    sel = slice(None) if lanes is None else lanes
    for name in ("status", "iterations", "ls_iterations"):
        np.testing.assert_array_equal(getattr(stats, name).numpy()[sel],
                                      getattr(j_stats, name)[sel], err_msg=f"{what}: {name}")
    for name, tol in (("alpha", 1e-9), ("dphi", 1e-8)):
        np.testing.assert_allclose(getattr(stats, name).numpy()[sel], getattr(j_stats, name)[sel],
                                   rtol=0, atol=tol, err_msg=f"{what}: {name}")
    for name in ("x", "u"):
        np.testing.assert_allclose(getattr(st, name).numpy()[sel], getattr(j_st, name)[sel],
                                   rtol=0, atol=1e-9, err_msg=f"{what}: {name}")


def oracle_cache():
    """A module-scoped fixture's body: JAX's runs by (search, pallas),
    each computed once per test module."""
    runs = {}

    def get(search, pallas):
        if (search, pallas) not in runs:
            runs[search, pallas] = jax_runs(search, pallas)
        return runs[search, pallas]

    return get


@pytest.fixture(scope="module")
def jax_oracles():
    return oracle_cache()


def check_vmap_solve(jax_oracles, search, pallas):
    """Oracle 1: vmap_solve (and solve_lanes) lane for lane."""
    j_st, j_stats = jax_oracles(search, pallas)["clean"]
    prob, opts = _port_problem(), SolverOptions(**_options(search, pallas))
    x0 = torch.as_tensor(_x0_batch(B))
    st, stats = batch.vmap_solve(prob, opts)(x0, batch.batch_init_state(prob, B))
    _assert_lanes(stats, st, j_stats, j_st, what="vmap_solve")
    assert bool((stats.status == SolveStatus.SUCCESS).all())
    lanes_prob = dataclasses.replace(prob, x0=tsv.batch_to_lanes(x0))
    st_l, stats_l = batch.solve_lanes(lanes_prob, tsv.state_to_lanes(
        batch.batch_init_state(prob, B)), opts)
    st_l = tsv.state_from_lanes(st_l)
    for name in ("status", "iterations", "ls_iterations", "alpha"):
        assert torch.equal(getattr(stats_l, name), getattr(stats, name)), name
    for name in ("x", "u", "y", "K", "d", "rho"):
        assert torch.equal(getattr(st_l, name), getattr(st, name)), name


def check_poisoned_lane(jax_oracles, search, pallas):
    """Oracle 2: the 1e8 lane leaves the others alone."""
    j_st, j_stats = jax_oracles(search, pallas)["poisoned"]
    prob, opts = _port_problem(), SolverOptions(**_options(search, pallas))
    st, stats = batch.vmap_solve(prob, opts)(torch.as_tensor(_poisoned()),
                                             batch.batch_init_state(prob, B))
    clean = [0, 1, 3]
    _assert_lanes(stats, st, j_stats, j_st, clean, what="clean lanes")
    assert bool((stats.status[clean] == SolveStatus.SUCCESS).all())
    assert bool(torch.isfinite(st.x[clean]).all())
    for name in ("status", "iterations", "ls_iterations"):
        assert int(getattr(stats, name)[2]) == int(getattr(j_stats, name)[2]), name


def check_tracking(jax_oracles, search, pallas):
    """Oracle 3: batched_tracking_solver with per-lane q and c."""
    j_u0, j_st, j_stats = jax_oracles(search, pallas)["tracking"]
    prob, opts = _port_problem(), SolverOptions(**_options(search, pallas))
    q, c = (torch.as_tensor(a) for a in _tracking_rows())
    u0, st, stats = batch.batched_tracking_solver(prob, opts)(
        torch.as_tensor(_x0_batch(B_TRACK)), q, c, batch.batch_init_state(prob, B_TRACK))
    _assert_lanes(stats, st, j_stats, j_st, what="batched_tracking_solver")
    np.testing.assert_allclose(u0.numpy(), j_u0, rtol=0, atol=1e-9)
    assert torch.equal(u0, st.u[:, 0])
    # the rows differ per lane, and so do the plans
    assert float((st.x[1:] - st.x[:-1]).abs().max()) > 1e-3


@pytest.mark.parametrize("pallas", [False, True], ids=["plain_backward", "pallas_backward"])
@pytest.mark.parametrize("oracle", [check_vmap_solve, check_poisoned_lane, check_tracking],
                         ids=["vmap_solve", "poisoned_lane", "batched_tracking"])
def test_strong_wolfe_matches_jax(jax_oracles, oracle, pallas):
    oracle(jax_oracles, "wolfe", pallas)


def test_default_options_run():
    """`vmap_solve(problem)` with SolverOptions() no longer raises, and
    the per-lane rows of batched_tracking_solver need a DiagonalCost."""
    prob = _port_problem()
    st, stats = batch.vmap_solve(prob)(torch.as_tensor(_x0_batch(2)),
                                       batch.batch_init_state(prob, 2))
    assert stats.status.shape == (2,) and bool(torch.isfinite(st.x).all())
    with pytest.raises(TypeError, match="DiagonalCost"):
        batch.batched_tracking_solver(dataclasses.replace(prob, cost=object()))
