"""The two Riccati backward kernels as torch operators, with the retry inside.

No JAX counterpart of its own: JAX's `jax.export` lowered its Pallas
kernels into the artifact's StableHLO. `torch.export` records calls of
registered operators only, and the port's kernels are plain C entry
points (ops/_build.py), so export.py's graph holds these two operators:

* `altro_tpu_torch::riccati_latency`: one lane's backward pass (the
  single-lane solve's `backward_adaptive`) with the adaptive-
  regularization retry of `solver._retry_loop`. Its CUDA implementation
  runs csrc/riccati_latency.cu through ops/riccati_latency.py (with
  `kernel`) or the plain recursion (without); its CPU implementation the
  plain recursion.
* `altro_tpu_torch::riccati_dense`: the lane-minor batch's backward pass
  (the vmapped solve's) with the per-lane retry of `tile_iter.
  retry_tiled`. Its CUDA implementation runs csrc/riccati_dense.cu
  through ops/riccati_dense.py (with `kernel`) or the plain batched
  recursion (without); its CPU implementation the plain recursion.

The retry's schedule (reg_min, reg_scaling, reg_max_retries) comes in as
arguments, so a graph holds one operator an iteration and launches the
kernel as often as the live solve does: once, plus once a retry. The
price is the live solve's own: one host read of `ok` an attempt, inside
the operator. Each wrapper counts its launches (`LAUNCHES`,
`VARIANT_LAUNCHES`). Every output is a tensor of its own (the kernels'
gains are views of one buffer), and none aliases an input. The live
solves call the wrappers directly; these operators serve the exported
graph (graph_solve.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref
from altro_tpu_torch.ops.riccati_dense import riccati_backward_dense
from altro_tpu_torch.ops.riccati_latency import riccati_latency, riccati_latency_ref

__all__ = ["bump", "retry", "retry_lanes", "riccati_latency_op", "riccati_dense_op"]

_Gains = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor, torch.Tensor, torch.Tensor]


def bump(reg, reg_min: float, reg_scaling: float):
    """The next regularization of the schedule: reg_min from zero, else
    reg times reg_scaling."""
    return torch.where(reg <= 0, torch.full_like(reg, reg_min), reg * reg_scaling)


def retry(attempt, reg0, reg_min: float, reg_scaling: float, max_retries: int):
    """One lane's adaptive-regularization retry: while the factorization
    fails, bump reg and run `attempt` again, up to max_retries times. One
    host read of `ok` an attempt. Returns (gains, reg used)."""
    gains = attempt(reg0)
    reg = reg0
    tries = 0
    while tries < max_retries and not bool(gains.ok):
        reg = bump(reg, reg_min, reg_scaling)
        gains = attempt(reg)
        tries += 1
    return gains, reg


def _owned(gains, reg) -> _Gains:
    """The gains and reg as tensors of their own, in the operators' order."""
    return tuple(t.clone() for t in (gains.K, gains.d, gains.P, gains.p, gains.delta_V,
                                     gains.ok, gains.fail_index.to(torch.int32), reg))


@torch.library.custom_op("altro_tpu_torch::riccati_latency", mutates_args=())
def riccati_latency_op(A: torch.Tensor, B: torch.Tensor, lxx: torch.Tensor,
                       luu: torch.Tensor, lux: Optional[torch.Tensor],
                       f: Optional[torch.Tensor], lx: torch.Tensor, lu: torch.Tensor,
                       reg: torch.Tensor, reg_min: float, reg_scaling: float,
                       max_retries: int, kernel: bool) -> _Gains:
    """One lane's backward pass with the retry: A [N, n, n], B [N, n, m],
    lxx [N+1, n, n] or diagonals [N+1, n], luu [N, m, m] or [N, m],
    lux [N, m, n] or None, f [N, n] or None, lx [N+1, n], lu [N, m], reg
    0-dim. Returns (K, d, P, p, delta_V [2], ok, fail_index, reg used).
    The CPU implementation: the plain recursion."""
    del kernel  # the CPU has no kernel

    def attempt(r):
        return riccati_latency_ref(A, B, lxx, luu, lx, lu, r, lux=lux, f=f)

    return _owned(*retry(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_latency_op.register_kernel("cuda")
def _riccati_latency_cuda(A, B, lxx, luu, lux, f, lx, lu, reg, reg_min, reg_scaling,
                          max_retries, kernel):
    """With `kernel`, csrc/riccati_latency.cu (float32, or a raise naming
    what the kernel does not take); without, the plain recursion."""
    if kernel:
        ops = [t.contiguous() for t in (A, B, lxx, luu, lx, lu)]
        lux_, f_ = (None if t is None else t.contiguous() for t in (lux, f))

        def attempt(r):
            return riccati_latency(*ops, r.reshape(1).contiguous(), lux=lux_, f=f_)
    else:
        def attempt(r):
            return riccati_latency_ref(A, B, lxx, luu, lx, lu, r, lux=lux, f=f)

    return _owned(*retry(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_latency_op.register_fake
def _riccati_latency_fake(A, B, lxx, luu, lux, f, lx, lu, reg, reg_min, reg_scaling,
                          max_retries, kernel):
    N, n, m = A.shape[0], A.shape[1], B.shape[2]
    return (A.new_empty((N, m, n)), A.new_empty((N, m)), A.new_empty((N + 1, n, n)),
            A.new_empty((N + 1, n)), A.new_empty((2,)), A.new_empty((), dtype=torch.bool),
            A.new_empty((), dtype=torch.int32), reg.new_empty(()))


def retry_lanes(attempt, reg0, reg_min: float, reg_scaling: float, max_retries: int,
                read=bool):
    """The batch's retry (`tile_iter.retry_tiled`'s): lanes already ok keep
    their gains; failing lanes bump reg and take the recomputed values.
    One host read a trip, through `read` (a 0-dim bool tensor -> bool)."""
    g = attempt(reg0)
    reg = reg0
    tries = 0
    while tries < max_retries and read(torch.any(~g.ok)):
        need = ~g.ok
        reg = torch.where(need, bump(reg, reg_min, reg_scaling), reg)
        g2 = attempt(reg)
        g = type(g)(*(torch.where(need, new, old) for new, old in zip(g2, g)))
        tries += 1
    return g, reg


def _dense_attempt(A, B, lxx, luu, lux, lx, lu, kernel):
    if kernel:
        ops = [t.contiguous() for t in (A, B, lxx, luu, lx, lu)]
        lux_ = None if lux is None else lux.contiguous()

        def attempt(r):
            A_, B_, lxx_, luu_, lx_, lu_ = ops
            return riccati_backward_dense(A_, B_, None, lxx_, luu_, lux_, lx_, lu_,
                                          r.contiguous())
    else:
        def attempt(r):
            return riccati_backward_ref(A, B, lxx, luu, lx, lu, r, lux=lux)
    return attempt


@torch.library.custom_op("altro_tpu_torch::riccati_dense", mutates_args=())
def riccati_dense_op(A: torch.Tensor, B: torch.Tensor, lxx: torch.Tensor, luu: torch.Tensor,
                     lux: Optional[torch.Tensor], lx: torch.Tensor, lu: torch.Tensor,
                     reg: torch.Tensor, reg_min: float, reg_scaling: float,
                     max_retries: int, kernel: bool) -> _Gains:
    """The lane-minor batch's backward pass with the per-lane retry:
    A [N, n, n, B], B [N, n, m, B], lxx [N+1, n, n, B] (or diagonals
    [N+1, n, B] without `kernel`), luu [N, m, m, B] (or [N, m, B]),
    lux [N, m, n, B] or None, lx [N+1, n, B], lu [N, m, B], reg [B].
    Returns (K, d, P, p, delta_V [2, B], ok [B], fail_index [B], reg [B]).
    The CPU implementation: the plain recursion."""
    attempt = _dense_attempt(A, B, lxx, luu, lux, lx, lu, False)
    return _owned(*retry_lanes(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_dense_op.register_kernel("cuda")
def _riccati_dense_cuda(A, B, lxx, luu, lux, lx, lu, reg, reg_min, reg_scaling, max_retries,
                        kernel):
    """With `kernel`, csrc/riccati_dense.cu (float32, dense operands, or a
    raise); without, the plain recursion."""
    attempt = _dense_attempt(A, B, lxx, luu, lux, lx, lu, kernel)
    return _owned(*retry_lanes(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_dense_op.register_fake
def _riccati_dense_fake(A, B, lxx, luu, lux, lx, lu, reg, reg_min, reg_scaling, max_retries,
                        kernel):
    N, n, m, Bsz = A.shape[0], A.shape[1], B.shape[2], A.shape[-1]
    return (A.new_empty((N, m, n, Bsz)), A.new_empty((N, m, Bsz)),
            A.new_empty((N + 1, n, n, Bsz)), A.new_empty((N + 1, n, Bsz)),
            A.new_empty((2, Bsz)), A.new_empty((Bsz,), dtype=torch.bool),
            A.new_empty((Bsz,), dtype=torch.int32), reg.new_empty((Bsz,)))
