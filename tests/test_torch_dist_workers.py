"""The port's `parallel/horizon.py` and `parallel/mesh.py` in gloo worlds
on the CPU: the workers that tests/test_torch_horizon_sharded.py and
tests/test_torch_mesh.py spawn, and the world of one, which must equal
the single-process functions exactly.

This module imports only torch, numpy and the port: a spawned process
imports it to find its worker, and must not import jax (a new process's
JAX would look for the remote TPU plugin, tests/conftest.py). Each world
is `torch.multiprocessing.spawn`ed, initialised through a `FileStore`
file under the test's tmp_path, and joined with a timeout of its own;
each rank saves what it computed to `rank{i}.pt` beside the store file.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.parallel import (  # noqa: E402
    batch_init_state,
    batched_tracking_solver,
    initialize_distributed,
    make_mesh,
    sharded_tracking_solver,
    tvlqr_backward_horizon_sharded,
)
from altro_tpu_torch.parallel.horizon import tvlqr_backward_batch_horizon_sharded  # noqa: E402
from altro_tpu_torch.tvlqr import tvlqr_backward_associative  # noqa: E402

JOIN_SECONDS = 120
# tests/test_parallel.py's options and starts (the goal-constrained double integrator)
OPTS = SolverOptions(penalty_scaling=100.0)


def di_problem():
    return rp.double_integrator_problem(
        [1.0, 2.0, 0.0, 0.0], (rp.di_goal_constraint(np.zeros(4), dtype=torch.float64,
                                                       device="cpu"),),
        dtype=torch.float64, device="cpu")


def x0_batch(batch):
    base = torch.tensor([1.0, 2.0, 0.0, 0.0], dtype=torch.float64)
    deltas = torch.linspace(-0.5, 0.5, batch, dtype=torch.float64)[:, None]
    return base[None, :] + deltas * torch.tensor([1.0, -1.0, 0.0, 0.0], dtype=torch.float64)


def tracking_inputs(problem, batch):
    """(x0, q, c, state) of tests/test_parallel.py:59 at `batch` lanes."""
    q = problem.cost.q.expand((batch,) + problem.cost.q.shape).contiguous()
    c = problem.cost.c.expand((batch,) + problem.cost.c.shape).contiguous()
    return x0_batch(batch), q, c, batch_init_state(problem, batch)


def run_world(worker, world: int, tmp_path, *args):
    """Spawn `world` gloo ranks of worker(rank, world, store, out_dir, *args),
    join them within JOIN_SECONDS, and return each rank's saved results."""
    store = str(tmp_path / "store")
    ctx = mp.spawn(_entry, args=(worker, world, store, str(tmp_path)) + args, nprocs=world,
                   join=False)
    deadline = time.monotonic() + JOIN_SECONDS
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"a gloo world of {world} did not finish in {JOIN_SECONDS} s")
    return [torch.load(os.path.join(tmp_path, f"rank{r}.pt")) for r in range(world)]


def _entry(rank, worker, world, store, out_dir, *args):
    import sys

    assert "jax" not in sys.modules, "a spawned rank imported jax"
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, backend="gloo")
    try:
        out = worker(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def horizon_worker(rank, world, args, mesh_shape, bad_args=None):
    """The horizon-split pass on a 1-D ("horizon",) mesh, or on a (batch,
    horizon) mesh for the batched stacks; with bad_args, the ValueError
    that their horizon length raises."""
    from torch.distributed.device_mesh import init_device_mesh

    args = [torch.as_tensor(a) for a in args]
    if len(mesh_shape) == 1:
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("horizon",))
        g = tvlqr_backward_horizon_sharded(*args, mesh=mesh)
    else:
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("batch", "horizon"))
        g = tvlqr_backward_batch_horizon_sharded(*args, mesh=mesh)
    out = {"gains": g._asdict()}
    if bad_args is not None:
        try:
            tvlqr_backward_horizon_sharded(*[torch.as_tensor(a) for a in bad_args], mesh=mesh)
            out["error"] = None
        except ValueError as e:
            out["error"] = str(e)
    return out


def mesh_worker(rank, world, batch, bad_batch=None):
    """sharded_tracking_solver over the world on tests/test_parallel.py's
    problem at `batch` lanes; with bad_batch, the ValueError its size
    raises."""
    problem = di_problem()
    mesh = make_mesh(world, axis="batch", device_type="cpu")
    run = sharded_tracking_solver(problem, mesh, OPTS)
    u0, st, stats, agg = run(*tracking_inputs(problem, batch))
    out = {"u0": u0, "state": dataclasses.asdict(st), "stats": dataclasses.asdict(stats),
           "agg": agg}
    if bad_batch is not None:
        try:
            run(*tracking_inputs(problem, bad_batch))
            out["error"] = None
        except ValueError as e:
            out["error"] = str(e)
    return out


def test_world_of_one_equals_the_batched_tracking_solver(tmp_path):
    """A world of one rank computes what `batched_tracking_solver` computes,
    bit for bit, and `agg` holds the same reductions done locally."""
    (res,) = run_world(mesh_worker, 1, tmp_path, 8)
    problem = di_problem()
    u0, st, stats = batched_tracking_solver(problem, OPTS)(*tracking_inputs(problem, 8))
    assert torch.equal(res["u0"], u0)
    for name, v in dataclasses.asdict(st).items():
        got = res["state"][name]
        assert all(torch.equal(a, b) for a, b in zip(got, v)) if name == "z" else \
            torch.equal(got, v), name
    for name, v in dataclasses.asdict(stats).items():
        assert torch.equal(res["stats"][name], v), name
    agg = res["agg"]
    assert float(agg["max_feasibility"]) == float(stats.primal_feasibility.max())
    assert float(agg["max_stationarity"]) == float(stats.stationarity.max())
    assert float(agg["mean_iterations"]) == float(stats.iterations.to(torch.float32).mean())
    assert int(agg["num_success"]) == int((stats.status == 0).sum()) == 8


def test_world_of_one_horizon_equals_the_associative_pass(tmp_path):
    rng = np.random.default_rng(3)
    N, n, m = 11, 4, 2
    A = np.eye(n) + 0.05 * rng.standard_normal((N, n, n))
    B = 0.3 * rng.standard_normal((N, n, m))
    f = 0.1 * rng.standard_normal((N, n))
    W = rng.standard_normal((N + 1, n, n))
    lxx = W @ W.transpose(0, 2, 1) / n + np.eye(n)
    V = rng.standard_normal((N, m, m))
    luu = V @ V.transpose(0, 2, 1) / m + np.eye(m)
    lux = 0.05 * rng.standard_normal((N, m, n))
    lx, lu = rng.standard_normal((N + 1, n)), rng.standard_normal((N, m))
    args = (A, B, f, lxx, luu, lux, lx, lu)
    (res,) = run_world(horizon_worker, 1, tmp_path, args, (1,))
    g = tvlqr_backward_associative(*[torch.as_tensor(a) for a in args])
    for name, v in g._asdict().items():
        np.testing.assert_allclose(res["gains"][name].numpy(), v.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
