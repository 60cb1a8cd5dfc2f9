"""The rocket SOC landing row through `solve_tiled` against altro_tpu.

Counterpart: scripts/bench_all.py:732-843 (`rocket_soc_tiled_B1024`) and
its problem, examples/rocket_landing.py::build_problem. All f64 on numpy
inputs from a seed:

* The port's problem (`reference_problems.rocket_landing_problem`)
  against `build_problem`: the cost rows, h, x0 and every group's active
  knots exactly; the dynamics and every group's values and Jacobians
  (the port's forward mode against `jax.jacfwd`) at random points, to
  1e-13. `convert.problem_from_numpy` carries JAX's arrays into the same
  problem.
* `solve_tiled` on 6 lanes from the row's starts, on the plain paths (CPU
  tensors: the plain (6, 3) backward on dense expansions with lux, the
  plain grid), against JAX's `vmap(solve)` with the row's options (the
  per-lane iterates JAX's `solve_tiled` promises, tests/test_tile_solver
  .py): statuses and iterations exact, the touchdown distance to 1e-8,
  states and inputs to 1e-8, the SOC duals to 1e-6. The vmapped loop (the
  row's f64 reference on the card) takes the same steps.
The (6, 3) backward's plain version is held against JAX's Pallas kernel
in tests/test_torch_rocket_backward.py.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

from rocket_landing import build_problem  # noqa: E402

from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.solver import solve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.cones import Cone  # noqa: E402
from altro_tpu_torch.convert import problem_from_numpy  # noqa: E402
from altro_tpu_torch.ops import riccati_backward as rb  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from altro_tpu_torch.reference_problems import rocket_landing_problem  # noqa: E402

N, n, m = 60, 6, 3
J_PROBLEM, J_HOVER = build_problem(dtype=jnp.float64)


def _port_problem():
    return rocket_landing_problem(dtype=torch.float64, device="cpu")


def test_problem_matches_build_problem():
    prob, hover = _port_problem()
    np.testing.assert_array_equal(hover.numpy(), np.asarray(J_HOVER))
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(J_PROBLEM.x0))
    np.testing.assert_array_equal(prob.h.numpy(), np.asarray(J_PROBLEM.h))
    for name in ("Q", "R", "q", "r", "c"):
        np.testing.assert_allclose(getattr(prob.cost, name).numpy(),
                                   np.asarray(getattr(J_PROBLEM.cost, name)), rtol=1e-15, atol=0)
    cones = [s.cone for s in prob.constraints]
    assert cones == [Cone.SECOND_ORDER, Cone.SECOND_ORDER, Cone.NEGATIVE_ORTHANT,
                     Cone.SECOND_ORDER, Cone.ZERO]
    assert [s.cone.value for s in J_PROBLEM.constraints] == [c.value for c in cones]

    rng = np.random.default_rng(0)
    K = 7
    x = 10.0 * rng.standard_normal((K, n))
    u = 5.0 * rng.standard_normal((K, m))
    ks = np.arange(K)
    # the dynamics, one knot a point
    jx = jax.vmap(lambda xi, ui: J_PROBLEM.dynamics(xi, ui, J_PROBLEM.h[0], 0))(
        jnp.asarray(x), jnp.asarray(u))
    tx = prob.dynamics(torch.as_tensor(x.T), torch.as_tensor(u.T), prob.h[0], 0)
    np.testing.assert_allclose(tx.numpy().T, np.asarray(jx), rtol=1e-13, atol=1e-13)
    for spec, jspec in zip(prob.constraints, J_PROBLEM.constraints):
        assert (spec.dim, spec.label) == (jspec.dim, jspec.label)
        np.testing.assert_array_equal(spec.active.numpy(), np.asarray(jspec.active))
        jval = jax.vmap(lambda xi, ui, k: jspec.fn(xi, ui, k))(jnp.asarray(x), jnp.asarray(u), ks)
        jjac = jax.vmap(jax.jacfwd(lambda xu, k: jspec.fn(xu[:n], xu[n:], k)))(
            jnp.asarray(np.concatenate([x, u], axis=1)), ks)
        tval = spec.fn(torch.as_tensor(x.T), torch.as_tensor(u.T), torch.as_tensor(ks))
        tjac = spec.jacobian(torch.as_tensor(x.T), torch.as_tensor(u.T), torch.as_tensor(ks))
        np.testing.assert_allclose(tval.numpy().T, np.asarray(jval), rtol=1e-13, atol=1e-13,
                                   err_msg=spec.label)
        np.testing.assert_allclose(np.moveaxis(tjac.numpy(), -1, 0), np.asarray(jjac),
                                   rtol=1e-13, atol=1e-13, err_msg=spec.label)

    # JAX's arrays carried across build the same problem
    arrays = {k: np.asarray(getattr(J_PROBLEM.cost, k)) for k in ("Q", "R", "q", "r", "c")}
    arrays.update(h=np.asarray(J_PROBLEM.h), x0=np.asarray(J_PROBLEM.x0),
                  active=[np.asarray(s.active) for s in J_PROBLEM.constraints])
    carried = problem_from_numpy(arrays, N=N, n=n, m=m, dynamics=prob.dynamics,
                                 constraints=prob.constraints, device="cpu")
    for name in ("Q", "R", "q", "r", "c"):
        assert torch.equal(getattr(carried.cost, name), getattr(prob.cost, name))
    for a, b in zip(carried.constraints, prob.constraints):
        assert torch.equal(a.active, b.active) and a.cone is b.cone


def test_row_options_and_the_kernels_reach():
    """The row's options on the card: the backward kernel takes (6, 3)
    float32; the trial-grid kernel takes no SOC group and the rocket has no
    column step, so the row asks for the plain grid, and with
    `pallas_rollout_tiled` the solve is refused with the grid's reason."""
    prob, _ = rocket_landing_problem(device="cpu")
    opts = mpc.rocket_soc_options()
    assert tsv.supported_options(opts) and not opts.pallas_rollout_tiled
    assert tsv.kernel_refusal(prob, opts, vmapped=False) is None
    why = tsv.kernel_refusal(prob, opts.replace(pallas_rollout_tiled=True), vmapped=False)
    assert "rollout_grid" in why and "riccati_backward" not in why, why
    assert not rg.rollout_tiled_eligible(prob)


def test_solve_tiled_matches_jax_vmapped_solve():
    Bt = 6
    prob, hover = _port_problem()
    x0s = mpc.rocket_initial_states(prob, Bt).numpy()
    opts = mpc.rocket_soc_options()
    jopts = JOpts(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})
    states = dataclasses.replace(jbatch_init(J_PROBLEM, Bt),
                                 u=jnp.tile(J_HOVER, (Bt, N, 1)))
    jst, jstats = jax.jit(jax.vmap(lambda x0, s: solve(
        dataclasses.replace(J_PROBLEM, x0=x0), s, jopts)))(jnp.asarray(x0s), states)

    before = rb.LAUNCHES
    res = mpc.run_rocket_soc_tiled(prob, hover, torch.as_tensor(x0s))
    assert rb.LAUNCHES == before  # CPU tensors: the plain versions
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jstats.status))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jstats.iterations))
    assert int(res.iterations.min()) > 5  # the SOC groups take several AL rounds
    touch = np.linalg.norm(np.asarray(jst.x)[:, N, :3], axis=1)
    np.testing.assert_allclose(res.touchdown().numpy(), touch, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(jst.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(jst.u), rtol=0, atol=1e-8)
    for zt, zj in zip(res.state.z, jst.z):
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6, atol=1e-6)
    # the thrust pointing cone and the touchdown equality hold with nonzero duals
    assert all(float(res.state.z[j].abs().max()) > 1e-2 for j in (0, 4))
    assert res.metrics()["mean_touchdown_m"] == pytest.approx(float(touch.mean()), abs=1e-8)

    ref = mpc.run_rocket_soc(prob, hover, torch.as_tensor(x0s))
    assert torch.equal(ref.status, res.status) and torch.equal(ref.iterations, res.iterations)
    assert torch.equal(ref.state.x, res.state.x)
