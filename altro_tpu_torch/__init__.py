"""altro_tpu_torch: the PyTorch and CUDA port of altro_tpu.

The JAX package `altro_tpu` is the reference; this package mirrors its
module names (each module's docstring names its counterpart) and never
imports jax. Its first slice is the batched, warm-started receding-horizon
MPC path of bench.py: `mpc.run_closed_loop` over `tile_solver.solve_tiled`
with the failed-lane rescue, whose Riccati backward pass and W-trial
line-search rollout are hand-written CUDA kernels (csrc/, built by
ops/_build.py on first use). Later slices added the single-lane
`solver.solve` (the N=500 latency path, and under default SolverOptions()
the strong-Wolfe search on the reference's own test problems,
`reference_problems`, with `mpc`'s functional MPC API) and the vmapped
solve (`parallel.batch`), and the stateful facade `api.ALTROSolver`,
which the JAX package's README Quick start drives.

Internal layout is lane-minor, [N(+1), entry..., B]; public functions
keep the JAX batch-major layout [B, ...].
"""

from altro_tpu_torch.api import ALL_INDICES, LAST_INDEX, ALTROSolver
from altro_tpu_torch.cones import Cone
from altro_tpu_torch.options import SolverOptions, Verbosity

__all__ = ["ALTROSolver", "LAST_INDEX", "ALL_INDICES", "Cone", "SolverOptions", "Verbosity"]
