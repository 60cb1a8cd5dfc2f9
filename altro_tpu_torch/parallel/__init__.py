"""Batched and distributed solves (PyTorch port of altro_tpu.parallel):
the vmapped solve and the batched tracking solver (batch.py), the tracking
solver split over a `torch.distributed` world (mesh.py) and the
horizon-split Riccati backward pass (horizon.py)."""

from altro_tpu_torch.parallel.batch import batch_init_state, batched_tracking_solver, vmap_solve
from altro_tpu_torch.parallel.horizon import tvlqr_backward_horizon_sharded
from altro_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    sharded_tracking_solver,
)

__all__ = ["batch_init_state", "batched_tracking_solver", "vmap_solve", "make_mesh",
           "sharded_tracking_solver", "tvlqr_backward_horizon_sharded", "initialize_distributed"]
