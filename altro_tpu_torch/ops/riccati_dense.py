"""Batched dense Riccati backward pass: the CUDA kernel and its plain twin.

Counterpart: altro_tpu/ops/pallas_riccati.py::riccati_backward_pallas (the
Pallas `_kernel` run by `_run`, pallas_call at :387), the batch-fused
backward of the vmapped solve with `pallas_backward=True`
(altro_tpu/ops/fused_backward.py swapped it in for the vmapped scan).
csrc/riccati_dense.cu runs blocks of 8 lanes (16 at (4, 2)) with n + m
compute threads per lane, each a tile of [A B]'P' and of the Q blocks,
and two warps that copy operands in and gains out, on lane-minor operands,
`[N(+1), entry..., B]`, with dense lxx/luu, the cross block lux and the
affine term f, both optional, and a per-lane reg. The same kernel serves
ops/riccati_backward.py (the :521 entry), whose `launch_kernel` both
wrappers call; each counts its own launches. The plain version is
ops/riccati_backward.py::riccati_backward_ref, the same recursion (see
that module's docstring for the equations and the failure contract).

* `riccati_backward_dense` takes the lane-minor operands the solve holds;
  the lane loop (tile_solver.lane_loop) calls it.
* `riccati_backward_batch_major` has the argument order and the
  batch-major `[B, N, ...]` shapes of `riccati_backward_pallas` and
  changes layout at its edges, as `_run` did. The JAX kernel needed B to
  be a multiple of 1024 (its (8, 128) lane tiles); this one takes any B.
"""

from __future__ import annotations

import collections

import torch

from altro_tpu_torch.ops.riccati_backward import (
    KERNEL_SHAPES,
    Gains,
    launch_kernel,
    riccati_backward_ref,
)
from altro_tpu_torch.tvlqr import TVLQRGains

__all__ = ["LAUNCHES", "VARIANT_LAUNCHES", "KERNEL_SHAPES", "riccati_backward_dense",
           "riccati_backward_batch_major"]

# Count of this wrapper's kernel launches (plain integer; the CPU path
# never adds to it).
LAUNCHES = 0
# The same launches by instantiation, (n, m, lux, f) -> count.
VARIANT_LAUNCHES = collections.Counter()


def riccati_backward_dense(A, B, f, lxx, luu, lux, lx, lu, reg) -> Gains:
    """Dense batched backward pass on lane-minor operands.

    A [N, n, n, B], B [N, n, m, B], f [N, n, B] or None (zero),
    lxx [N+1, n, n, B], luu [N, m, m, B], lux [N, m, n, B] or None (zero),
    lx [N+1, n, B], lu [N, m, B], reg a scalar or [B]. A CPU tensor runs
    the plain version; a CUDA tensor launches csrc/riccati_dense.cu
    (float32, contiguous, (n, m) in KERNEL_SHAPES) or raises.
    """
    global LAUNCHES
    if not A.is_cuda:
        return riccati_backward_ref(A, B, lxx, luu, lx, lu, reg, lux=lux, f=f)
    g = launch_kernel("riccati_dense", A, B, f, lxx, luu, lux, lx, lu, reg, False)
    LAUNCHES += 1
    VARIANT_LAUNCHES[(A.shape[1], B.shape[2], lux is not None, f is not None)] += 1
    return g


def riccati_backward_batch_major(A, B, f, lxx, luu, lux, lx, lu, reg=0.0) -> TVLQRGains:
    """`riccati_backward_pallas` on batch-major operands: A [B, N, n, n],
    B [B, N, n, m], f [B, N, n], lxx [B, N+1, n, n], luu [B, N, m, m],
    lux [B, N, m, n], lx [B, N+1, n], lu [B, N, m] (f and lux may be None
    for zero); reg a scalar or [B]. Returns the PallasGains contract
    (K [B, N, m, n], d, P [B, N+1, n, n] with P[:, N] = lxx[:, N], p,
    delta_V [B, 2], ok, fail_index) as TVLQRGains."""

    def lanes(t):
        return None if t is None else t.movedim(0, -1).contiguous()

    if torch.is_tensor(reg) and reg.ndim == 1:
        reg = reg.contiguous()
    g = riccati_backward_dense(*(lanes(t) for t in (A, B, f, lxx, luu, lux, lx, lu)), reg)
    return TVLQRGains(*(t.movedim(-1, 0) for t in (g.K, g.d, g.P, g.p, g.delta_V)),
                      g.ok, g.fail_index)
