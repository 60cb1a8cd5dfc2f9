"""The port's kernels as torch operators: both Riccati backward passes, with
the retry inside, and the single-lane trial rollout.

No JAX counterpart of its own: JAX's `jax.export` lowered its Pallas
kernels into the artifact's StableHLO. `torch.export` records calls of
registered operators only, and the port's kernels are plain C entry
points (ops/_build.py), so export.py's graph holds these three
operators:

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
* Both take `associative` (with `chunk`): the associative pass of
  `SolverOptions.parallel_riccati` (`tvlqr.tvlqr_backward_associative`,
  plain PyTorch on any device, as JAX's is XLA) in the recursion's
  place, with the same retry.
* `altro_tpu_torch::trial_rollout`: the single-lane W-trial rollout of
  the phase-split x-only grid (the single-lane solve's `merit_grid` under
  `pallas_rollout`). An operator takes no callable, so it takes the
  block step's device step (model and integrator codes and parameters,
  `models.tile_steps.DeviceStep`) and rebuilds the step from the port's
  registry (`trial_rollout.block_step`). On CUDA tensors it runs
  csrc/trial_rollout.cu through ops/trial_rollout.py, or raises naming
  what the kernel cannot take; on the CPU `trial_rollout_ref`.

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

from typing import List, Optional, Tuple

import torch

from altro_tpu_torch.ops import trial_rollout as tr
from altro_tpu_torch.ops.riccati_backward import Gains, riccati_backward_ref
from altro_tpu_torch.ops.riccati_dense import riccati_backward_dense
from altro_tpu_torch.ops.riccati_latency import riccati_latency, riccati_latency_ref
from altro_tpu_torch.tvlqr import tvlqr_backward_associative

__all__ = ["bump", "retry", "retry_lanes", "associative_lanes", "riccati_latency_op",
           "riccati_dense_op", "trial_rollout_op"]

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


def _latency_attempt(A, B, lxx, luu, lux, f, lx, lu, kernel, associative, chunk):
    """One attempt of the single-lane backward at reg: the associative
    pass, the latency kernel (contiguous operands) or the plain
    recursion."""
    if associative:
        def attempt(r):
            return tvlqr_backward_associative(A, B, f, lxx, luu, lux, lx, lu, r,
                                              chunk=chunk or None)
    elif kernel:
        ops = [t.contiguous() for t in (A, B, lxx, luu, lx, lu)]
        lux_, f_ = (None if t is None else t.contiguous() for t in (lux, f))

        def attempt(r):
            return riccati_latency(*ops, r.reshape(1).contiguous(), lux=lux_, f=f_)
    else:
        def attempt(r):
            return riccati_latency_ref(A, B, lxx, luu, lx, lu, r, lux=lux, f=f)
    return attempt


@torch.library.custom_op("altro_tpu_torch::riccati_latency", mutates_args=())
def riccati_latency_op(A: torch.Tensor, B: torch.Tensor, lxx: torch.Tensor,
                       luu: torch.Tensor, lux: Optional[torch.Tensor],
                       f: Optional[torch.Tensor], lx: torch.Tensor, lu: torch.Tensor,
                       reg: torch.Tensor, reg_min: float, reg_scaling: float,
                       max_retries: int, kernel: bool, associative: bool = False,
                       chunk: int = 0) -> _Gains:
    """One lane's backward pass with the retry: A [N, n, n], B [N, n, m],
    lxx [N+1, n, n] or diagonals [N+1, n], luu [N, m, m] or [N, m],
    lux [N, m, n] or None, f [N, n] or None, lx [N+1, n], lu [N, m], reg
    0-dim. Returns (K, d, P, p, delta_V [2], ok, fail_index, reg used).
    associative (dense operands): the associative pass, `chunk` its
    parallel_riccati_chunk. The CPU implementation: the plain recursion,
    or the associative pass."""
    attempt = _latency_attempt(A, B, lxx, luu, lux, f, lx, lu, False, associative, chunk)
    return _owned(*retry(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_latency_op.register_kernel("cuda")
def _riccati_latency_cuda(A, B, lxx, luu, lux, f, lx, lu, reg, reg_min, reg_scaling,
                          max_retries, kernel, associative=False, chunk=0):
    """associative: the associative pass; else with `kernel`,
    csrc/riccati_latency.cu (float32, or a raise naming what the kernel
    does not take); else the plain recursion."""
    attempt = _latency_attempt(A, B, lxx, luu, lux, f, lx, lu, kernel, associative, chunk)
    return _owned(*retry(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_latency_op.register_fake
def _riccati_latency_fake(A, B, lxx, luu, lux, f, lx, lu, reg, reg_min, reg_scaling,
                          max_retries, kernel, associative=False, chunk=0):
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


def associative_lanes(A, B, lxx, luu, lx, lu, reg, lux=None, chunk=None) -> Gains:
    """`tvlqr.tvlqr_backward_associative` on lane-minor operands (A [N, n,
    n, B], ..., reg [B]): the vmapped solve's backward under
    `parallel_riccati`, as `jax.vmap(solve)` runs it. Lane-minor Gains."""
    def b(t):
        return None if t is None else t.movedim(-1, 0)

    g = tvlqr_backward_associative(b(A), b(B), None, b(lxx), b(luu), b(lux), b(lx), b(lu), reg,
                                   chunk=chunk)
    return Gains(*(t.movedim(0, -1).contiguous() for t in g[:5]), g.ok, g.fail_index)


def _dense_attempt(A, B, lxx, luu, lux, lx, lu, kernel, associative=False, chunk=0):
    if associative:
        def attempt(r):
            return associative_lanes(A, B, lxx, luu, lx, lu, r, lux=lux, chunk=chunk or None)
    elif kernel:
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
                     max_retries: int, kernel: bool, associative: bool = False,
                     chunk: int = 0) -> _Gains:
    """The lane-minor batch's backward pass with the per-lane retry:
    A [N, n, n, B], B [N, n, m, B], lxx [N+1, n, n, B] (or diagonals
    [N+1, n, B] without `kernel`), luu [N, m, m, B] (or [N, m, B]),
    lux [N, m, n, B] or None, lx [N+1, n, B], lu [N, m, B], reg [B].
    Returns (K, d, P, p, delta_V [2, B], ok [B], fail_index [B], reg [B]).
    associative (dense operands): the associative pass, `chunk` its
    parallel_riccati_chunk. The CPU implementation: the plain recursion,
    or the associative pass."""
    attempt = _dense_attempt(A, B, lxx, luu, lux, lx, lu, False, associative, chunk)
    return _owned(*retry_lanes(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_dense_op.register_kernel("cuda")
def _riccati_dense_cuda(A, B, lxx, luu, lux, lx, lu, reg, reg_min, reg_scaling, max_retries,
                        kernel, associative=False, chunk=0):
    """associative: the associative pass; else with `kernel`,
    csrc/riccati_dense.cu (float32, dense operands, or a raise); else the
    plain recursion."""
    attempt = _dense_attempt(A, B, lxx, luu, lux, lx, lu, kernel, associative, chunk)
    return _owned(*retry_lanes(attempt, reg, reg_min, reg_scaling, max_retries))


@riccati_dense_op.register_fake
def _riccati_dense_fake(A, B, lxx, luu, lux, lx, lu, reg, reg_min, reg_scaling, max_retries,
                        kernel, associative=False, chunk=0):
    N, n, m, Bsz = A.shape[0], A.shape[1], B.shape[2], A.shape[-1]
    return (A.new_empty((N, m, n, Bsz)), A.new_empty((N, m, Bsz)),
            A.new_empty((N + 1, n, n, Bsz)), A.new_empty((N + 1, n, Bsz)),
            A.new_empty((2, Bsz)), A.new_empty((Bsz,), dtype=torch.bool),
            A.new_empty((Bsz,), dtype=torch.int32), reg.new_empty((Bsz,)))


def _trial_con(wa, wu, wg, rhoi):
    return None if wa is None else (wa, wu, wg, rhoi)


@torch.library.custom_op("altro_tpu_torch::trial_rollout", mutates_args=())
def trial_rollout_op(alphas: torch.Tensor, x0: torch.Tensor, xref: torch.Tensor,
                     uref: torch.Tensor, K: torch.Tensor, d: torch.Tensor, Q: torch.Tensor,
                     q: torch.Tensor, R: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                     h: torch.Tensor, wa: Optional[torch.Tensor], wu: Optional[torch.Tensor],
                     wg: Optional[torch.Tensor], rhoi: Optional[torch.Tensor], model: int,
                     integrator: int, params: List[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lane's W-trial rollout (`trial_rollout.trial_rollout`'s operands:
    alphas [W], x0 [n], xref [N+1, n], uref [N, m], K [N, m, n], d [N, m],
    the cost rows Q, q [N+1, n], R, r [N+1, m], c [N+1], h [N]; the affine
    rows wa [N+1, P, n], wu [N+1, P, m], wg [N+1, P] and rhoi [1], or all
    four None) through the block step of the device step (model,
    integrator, params). Returns (phis [W], xstack [W, N+1, n]). The CPU
    implementation: `trial_rollout_ref`."""
    step = tr.block_step(model, integrator, params)
    phi, xs = tr.trial_rollout_ref(step, alphas, x0, xref, uref, K, d, Q, q, R, r, c, h,
                                   con=_trial_con(wa, wu, wg, rhoi))
    return phi.clone(), xs.clone()


@trial_rollout_op.register_kernel("cuda")
def _trial_rollout_cuda(alphas, x0, xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg, rhoi,
                        model, integrator, params):
    """csrc/trial_rollout.cu, or a raise naming what the kernel does not
    take (`trial_rollout.ineligibility`)."""
    step = tr.block_step(model, integrator, params)
    phi, xs = tr.trial_rollout(step, alphas, x0, xref, uref, K, d, Q, q, R, r, c, h,
                  con=_trial_con(wa, wu, wg, rhoi))
    return phi.clone(), xs.clone()  # the kernel's outputs are views of one buffer


@trial_rollout_op.register_fake
def _trial_rollout_fake(alphas, x0, xref, uref, K, d, Q, q, R, r, c, h, wa, wu, wg, rhoi,
                        model, integrator, params):
    W, (N, _, n) = alphas.shape[0], K.shape
    return x0.new_empty((W,)), x0.new_empty((W, N + 1, n))
