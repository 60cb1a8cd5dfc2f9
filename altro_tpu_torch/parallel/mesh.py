"""Batched solves split over the ranks of a `torch.distributed` world
(PyTorch port).

Counterpart: altro_tpu/parallel/mesh.py (`initialize_distributed`,
`make_mesh`, `sharded_tracking_solver`). JAX lays the batch axis over a
device mesh and runs `shard_map`; here every rank of a 1-D `DeviceMesh`
solves its B/D lanes with the port's `batched_tracking_solver`, the
global outputs go round in `all_gather`s, and the aggregate statistics
are reduced over the mesh dim's process group (NCCL on the card, gloo on
the CPU). Written SPMD: every rank calls with the whole batch and gets
the whole result, as JAX's global arrays are.

A world is started by the caller: `torchrun` on a host with several
cards, `torch.multiprocessing.spawn` with a `file://` or `tcp://` init
method, or a world of one process (`initialize_distributed("file://...",
1, 0)`). Nothing here reads a cluster's environment beyond what
`torch.distributed.init_process_group` itself reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.parallel.batch import batched_tracking_solver
from altro_tpu_torch.problem import DiagonalCost, Problem
from altro_tpu_torch.solver import SolverState, SolveStats

__all__ = ["initialize_distributed", "make_mesh", "sharded_tracking_solver"]


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Start this process's part of the world: a thin wrapper over
    `torch.distributed.init_process_group`. The backend is NCCL (the card)
    unless the caller asks for "gloo"; under NCCL the process takes card
    LOCAL_RANK (else rank modulo the cards). init_method None reads
    torchrun's environment (env://)."""
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: NCCL needs a CUDA device; "
                               "backend='gloo' runs on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = {"backend": backend}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(**kwargs)


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch", device_type: str = "cuda"):
    """A 1-D `DeviceMesh` over the world's ranks with the dim name `axis`.
    n_devices, when given, must be the world's size (each rank holds one
    device); device_type "cuda" needs a card, "cpu" takes gloo worlds."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device_type 'cuda' asked for and no CUDA device is "
                           "available; device_type='cpu' builds a mesh of a gloo world")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the world has {world} ranks")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def _gather_lanes(tensors, group, size: int):
    """Each rank's lanes of every tensor ([Bl, ...]), gathered in rank
    order into [size * Bl, ...]: one `all_gather` per dtype, the tensors
    packed side by side."""
    out = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = [tensors[i].reshape(tensors[i].shape[0], -1) for i in idx]
        packed = torch.cat(flat, dim=1).contiguous()
        parts = [torch.empty_like(packed) for _ in range(size)]
        dist.all_gather(parts, packed, group=group)
        whole = torch.cat(parts, dim=0)
        for i, piece in zip(idx, torch.split(whole, [f.shape[1] for f in flat], dim=1)):
            out[i] = piece.reshape((whole.shape[0],) + tensors[i].shape[1:])
    return out


def sharded_tracking_solver(problem: Problem, mesh, opts: SolverOptions = SolverOptions(),
                            axis: str = "batch", reduce_stats: bool = True):
    """The batched tracking solver split over the mesh dim `axis`.

    Returns fn(x0 [B, n], q [B, N+1, n], c [B, N+1], state [B, ...]) ->
    (u0 [B, m], state', stats [B], agg), batch-major: rank i solves lanes
    i*B/D .. (i+1)*B/D - 1 with `batched_tracking_solver`, and every rank
    returns the whole batch. `agg` (when reduce_stats) holds JAX's four
    aggregates as 0-dim tensors: max_feasibility and max_stationarity
    (MAX over the ranks), mean_iterations (each rank's mean, SUM over the
    ranks divided by their count: gloo has no AVG) and num_success (SUM).
    Raises TypeError for a cost that is not a DiagonalCost, as JAX does,
    and ValueError when the dim's size does not divide B."""
    if not isinstance(problem.cost, DiagonalCost):
        raise TypeError("sharded_tracking_solver requires a DiagonalCost")
    dim = mesh.mesh_dim_names.index(axis)
    size, rank, group = mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)
    solve = batched_tracking_solver(problem, opts)

    def run(x0, q, c, state: SolverState):
        Bsz = x0.shape[0]
        if Bsz % size != 0:
            raise ValueError(f"batch {Bsz} must be divisible by mesh axis size {size}")
        mine = slice(rank * (Bsz // size), (rank + 1) * (Bsz // size))
        u0, st, stats = solve(x0[mine], q[mine], c[mine], state.map(lambda a: a[mine]))
        names = [f.name for f in dataclasses.fields(SolverState) if f.name != "z"]
        stat_names = [f.name for f in dataclasses.fields(SolveStats)]
        leaves = ([u0] + [getattr(st, f) for f in names] + list(st.z)
                  + [getattr(stats, f) for f in stat_names])
        whole = iter(_gather_lanes(leaves, group, size))
        u0_all = next(whole)
        fields = {f: next(whole) for f in names}
        state_all = SolverState(z=tuple(next(whole) for _ in st.z), **fields)
        stats_all = SolveStats(**{f: next(whole) for f in stat_names})
        agg = {}
        if reduce_stats:
            def reduce(v, op):
                dist.all_reduce(v, op=op, group=group)
                return v

            agg = dict(
                max_feasibility=reduce(stats.primal_feasibility.max(), dist.ReduceOp.MAX),
                max_stationarity=reduce(stats.stationarity.max(), dist.ReduceOp.MAX),
                mean_iterations=reduce(stats.iterations.to(torch.float32).mean(),
                                       dist.ReduceOp.SUM) / size,
                num_success=reduce((stats.status == 0).sum().to(torch.int32),
                                   dist.ReduceOp.SUM))
        return u0_all, state_all, stats_all, agg

    return run
