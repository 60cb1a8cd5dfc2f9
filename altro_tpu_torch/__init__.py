"""altro_tpu_torch: the PyTorch and CUDA port of altro_tpu.

The JAX package `altro_tpu` is the reference; this package mirrors its
module names (each module's docstring names its counterpart) and never
imports jax. Its first slice is the batched, warm-started receding-horizon
MPC path of bench.py: `mpc.run_closed_loop` over `tile_solver.solve_tiled`
with the failed-lane rescue, whose Riccati backward pass and W-trial
line-search rollout are hand-written CUDA kernels (csrc/, built by
ops/_build.py on first use).

Internal layout is lane-minor, [N(+1), entry..., B]; public functions
keep the JAX batch-major layout [B, ...].
"""
