"""Batched dense Riccati backward pass: the CUDA kernel and its plain twin.

Counterpart: altro_tpu/ops/pallas_riccati.py::riccati_backward_pallas (the
Pallas `_kernel` run by `_run`, pallas_call at :387), the batch-fused
backward of the vmapped solve with `pallas_backward=True`
(altro_tpu/ops/fused_backward.py swapped it in for the vmapped scan).
csrc/riccati_dense.cu runs blocks of 8 lanes (16 at (4, 2)) with n + m
compute threads per lane, each a tile of [A B]'P' and of the Q blocks,
and two warps that copy operands in and gains out, on lane-minor operands,
`[N(+1), entry..., B]`, with dense lxx/luu, the cross block lux and the
affine term f, both optional, and a per-lane reg. The plain version is
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

import torch

from altro_tpu_torch.ops import _build
from altro_tpu_torch.ops.riccati_backward import Gains, riccati_backward_ref
from altro_tpu_torch.tvlqr import TVLQRGains

__all__ = ["LAUNCHES", "KERNEL_SHAPES", "riccati_backward_dense",
           "riccati_backward_batch_major"]

# Count of kernel launches (plain integer; the CPU path never adds to it).
LAUNCHES = 0

# (n, m) pairs the CUDA kernel is instantiated for.
KERNEL_SHAPES = ((4, 2), (12, 4))


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
    N, n, m, Bsz = A.shape[0], A.shape[1], B.shape[2], A.shape[-1]
    if (n, m) not in KERNEL_SHAPES:
        raise NotImplementedError(f"riccati_dense kernel: no instantiation for n={n}, m={m}")
    if not torch.is_tensor(reg) or reg.ndim == 0:
        reg = torch.full((Bsz,), float(reg), dtype=A.dtype, device=A.device)
    shapes = {"A": (A, (N, n, n, Bsz)), "B": (B, (N, n, m, Bsz)), "f": (f, (N, n, Bsz)),
              "lxx": (lxx, (N + 1, n, n, Bsz)), "luu": (luu, (N, m, m, Bsz)),
              "lux": (lux, (N, m, n, Bsz)), "lx": (lx, (N + 1, n, Bsz)),
              "lu": (lu, (N, m, Bsz)), "reg": (reg, (Bsz,))}
    for name, (t, shape) in shapes.items():
        if t is not None:
            _build.check_operand("riccati_dense", name, t, shape)

    lib = _build.load()
    kw = dict(dtype=A.dtype, device=A.device)
    K = torch.empty((N, m, n, Bsz), **kw)
    d = torch.empty((N, m, Bsz), **kw)
    P = torch.empty((N + 1, n, n, Bsz), **kw)
    p = torch.empty((N + 1, n, Bsz), **kw)
    dV = torch.empty((2, Bsz), **kw)
    ok = torch.empty((Bsz,), dtype=torch.bool, device=A.device)
    fail = torch.empty((Bsz,), dtype=torch.int32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.riccati_dense_f32(
        *(None if t is None else t.data_ptr() for t, _ in shapes.values()),
        K.data_ptr(), d.data_ptr(), P.data_ptr(), p.data_ptr(), dV.data_ptr(),
        ok.data_ptr(), fail.data_ptr(), N, n, m, Bsz, stream)
    _build.check(err, "riccati_dense_f32")
    LAUNCHES += 1
    return Gains(K, d, P, p, dV, ok, fail)


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
