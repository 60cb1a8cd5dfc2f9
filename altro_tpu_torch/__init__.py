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

The top-level names are altro_tpu's (altro_tpu/__init__.py), less
`ensure_backend` (the TPU platform probe, not ported). The `export`
module records the warm-started MPC tick with `torch.export` as a saved
load-and-call artifact (`export_mpc_server`, `save_exported`,
`load_exported`, `call_exported`).
"""

from altro_tpu_torch.cones import (
    Cone,
    cone_is_linear,
    dual_cone,
    project,
    project_hessian,
    project_jacobian,
)
from altro_tpu_torch.tvlqr import TVLQRGains, tvlqr_backward, tvlqr_forward
from altro_tpu_torch.problem import (
    ConstraintSpec,
    Cost,
    DiagonalCost,
    GenericCost,
    Problem,
    QuadraticCost,
    lqr_cost_from_reference,
)
from altro_tpu_torch.options import SolverOptions, Verbosity
from altro_tpu_torch.status import AltroError, ErrorCode, LineSearchCode, SolveStatus
from altro_tpu_torch.solver import (
    SolveStats,
    SolverState,
    init_state,
    merit_function,
    open_loop_rollout,
    solve,
    total_cost,
)
from altro_tpu_torch.api import ALL_INDICES, ALTROSolver, LAST_INDEX
from altro_tpu_torch.diff import implicit_solve
from altro_tpu_torch.implicit import implicit_dynamics, implicit_midpoint_residual
from altro_tpu_torch.checkpoint import load_state, save_state
from altro_tpu_torch.rescue import (
    rescue_options,
    solve_tiled_with_rescue,
    vmap_solve_with_rescue,
)
from altro_tpu_torch.export import (
    call_exported,
    export_mpc_server,
    load_exported,
    save_exported,
)
from altro_tpu_torch import (al, checkpoint, export, io, linesearch, models, mpc, ops, parallel,
                             profiling)

__version__ = "0.1.0"
