"""The port's tracking solver split over a gloo world (`parallel/mesh.py`)
against JAX's `sharded_tracking_solver` on the suite's 8 virtual devices,
in float64 (tests/test_parallel.py:59's problem, starts and assertions):
a world of 4 at B=8 (two lanes a rank), u0 and x to 1e-9, statuses
equal, every lane SUCCESS, the aggregates, and the ValueError of a batch
the world does not divide; the TypeError of a cost that is not a
DiagonalCost. The workers live in tests/test_torch_dist_workers.py (no
jax there); the world of one is held to `batched_tracking_solver` there.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

dw = pytest.importorskip("test_torch_dist_workers")


def test_world_of_4_matches_jax_sharded_solver(tmp_path):
    from altro_tpu.parallel.batch import batch_init_state as jbatch_init
    from altro_tpu.parallel.mesh import make_mesh as jmake_mesh
    from altro_tpu.parallel.mesh import sharded_tracking_solver as jsharded
    from test_parallel import OPTS as JOPTS
    from test_parallel import di_problem as jdi_problem
    from test_parallel import x0_batch as jx0_batch

    batch = 8
    problem = jdi_problem()
    q = jnp.broadcast_to(problem.cost.q, (batch,) + problem.cost.q.shape)
    c = jnp.broadcast_to(problem.cost.c, (batch,) + problem.cost.c.shape)
    u0_j, st_j, stats_j, agg_j = jsharded(problem, jmake_mesh(8), JOPTS)(
        jx0_batch(batch), q, c, jbatch_init(problem, batch))
    np.testing.assert_allclose(dw.x0_batch(batch).numpy(), np.asarray(jx0_batch(batch)),
                               rtol=0, atol=1e-15)

    res = dw.run_world(dw.mesh_worker, 4, tmp_path, batch, 6)
    for r in res:
        np.testing.assert_allclose(r["u0"].numpy(), np.asarray(u0_j), rtol=0, atol=1e-9)
        np.testing.assert_allclose(r["state"]["x"].numpy(), np.asarray(st_j.x), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(r["stats"]["status"].numpy(), np.asarray(stats_j.status))
        np.testing.assert_array_equal(r["stats"]["iterations"].numpy(),
                                      np.asarray(stats_j.iterations))
        agg = r["agg"]
        assert int(agg["num_success"]) == int(agg_j["num_success"]) == batch
        assert float(agg["max_feasibility"]) < 1e-4
        np.testing.assert_allclose(float(agg["max_feasibility"]),
                                   float(agg_j["max_feasibility"]), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(float(agg["max_stationarity"]),
                                   float(agg_j["max_stationarity"]), rtol=0, atol=1e-9)
        assert float(agg["mean_iterations"]) == float(agg_j["mean_iterations"])
        assert r["error"] == "batch 6 must be divisible by mesh axis size 4"
    for name in ("u0",):  # every rank holds the whole, equal result
        assert all(torch.equal(r[name], res[0][name]) for r in res)


def test_sharded_solver_requires_a_diagonal_cost():
    from altro_tpu_torch.parallel.mesh import sharded_tracking_solver
    from altro_tpu_torch.problem import QuadraticCost

    problem = dw.di_problem()
    n, m, N = problem.n, problem.m, problem.N
    quad = QuadraticCost(Q=torch.eye(n).expand(N + 1, n, n), R=torch.eye(m).expand(N + 1, m, m),
                         H=torch.zeros(N + 1, m, n), q=torch.zeros(N + 1, n),
                         r=torch.zeros(N + 1, m), c=torch.zeros(N + 1))
    with pytest.raises(TypeError, match="DiagonalCost"):
        sharded_tracking_solver(dataclasses.replace(problem, cost=quad), mesh=None)
