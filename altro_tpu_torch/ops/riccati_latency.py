"""Single-lane Riccati backward pass (latency): the CUDA kernel and its plain twin.

Counterpart: altro_tpu/ops/pallas_packed.py::riccati_backward_pallas_packed
(the Pallas `_kernel` and `_knot_body`, and the unpacking after the call).
The TPU kernel packed each knot's operands into one (8, 128) tile and ran
the N-knot chain as a sequential grid; csrc/riccati_latency.cu runs it in
one thread block: warps 1-3 stage chunks of knots through shared memory
(double-buffered) while one thread carries (P, p) in registers down the
chain.

Contract, for ONE lane (unbatched, the JAX layout): A [N, n, n],
B [N, n, m]; lxx [N+1, n, n] or diagonals [N+1, n]; luu [N, m, m] or
[N, m]; lux [N, m, n] or None; f [N, n] or None (None elides P'f);
lx [N+1, n], lu [N, m]; reg a scalar. Returns TVLQRGains with K [N, m, n],
d [N, m], P [N+1, n, n] (P[N] = lxx[N] expanded), p [N+1, n] (p[N] =
lx[N]), delta_V [2], ok (0-dim bool) and fail_index (0-dim int32, the
smallest failing knot, N when none fails). A failed knot emits K = d = 0
by select. P follows the Cholesky identity P = Qxx - Qux'K - reg K'K, as
the TPU kernel's does; `symmetrize` is accepted and ignored there and
here.
"""

from __future__ import annotations

import torch

from altro_tpu_torch.ops import _build
from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref
from altro_tpu_torch.tvlqr import TVLQRGains

__all__ = ["LAUNCHES", "KERNEL_SHAPES", "riccati_latency_ref", "riccati_latency"]

# Count of kernel launches (plain integer; the CPU path never adds to it).
LAUNCHES = 0

# (n, m) pairs the CUDA kernel is instantiated for.
KERNEL_SHAPES = ((4, 2),)


def _lane(t):
    return None if t is None else t[..., None]


def riccati_latency_ref(A, B, lxx, luu, lx, lu, reg=0.0, lux=None, f=None) -> TVLQRGains:
    """Plain PyTorch version: the batched plain backward with one lane."""
    g = riccati_backward_ref(_lane(A), _lane(B), _lane(lxx), _lane(luu), _lane(lx),
                             _lane(lu), torch.as_tensor(reg, dtype=A.dtype,
                                                        device=A.device).reshape(1),
                             lux=_lane(lux), f=_lane(f))
    return TVLQRGains(g.K[..., 0], g.d[..., 0], g.P[..., 0], g.p[..., 0],
                      g.delta_V[..., 0], g.ok[0], g.fail_index[0])


def riccati_latency(A, B, lxx, luu, lx, lu, reg=0.0, lux=None, f=None,
                    symmetrize=False) -> TVLQRGains:
    """Single-lane backward pass: the plain version for CPU tensors, the
    CUDA kernel (csrc/riccati_latency.cu) for CUDA tensors, or a raise
    when the kernel does not take them (not float32, (n, m) not in
    KERNEL_SHAPES, wrong shape, not contiguous)."""
    global LAUNCHES
    del symmetrize  # P is symmetric by construction (see module docstring)
    if not A.is_cuda:
        return riccati_latency_ref(A, B, lxx, luu, lx, lu, reg, lux=lux, f=f)
    N, n, m = A.shape[0], A.shape[1], B.shape[2]
    if (n, m) not in KERNEL_SHAPES:
        raise NotImplementedError(f"riccati_latency kernel: no instantiation for n={n}, m={m}")
    diag_x, diag_u = lxx.ndim == 2, luu.ndim == 2
    if not torch.is_tensor(reg):
        reg = torch.tensor(float(reg), dtype=A.dtype, device=A.device)
    reg_t = reg.reshape(1)
    ops = {
        "A": (A, (N, n, n)), "B": (B, (N, n, m)),
        "lxx": (lxx, (N + 1, n) if diag_x else (N + 1, n, n)),
        "luu": (luu, (N, m) if diag_u else (N, m, m)),
        "lx": (lx, (N + 1, n)), "lu": (lu, (N, m)), "reg": (reg_t, (1,)),
    }
    if lux is not None:
        ops["lux"] = (lux, (N, m, n))
    if f is not None:
        ops["f"] = (f, (N, n))
    for name, (t, shape) in ops.items():
        _build.check_operand("riccati_latency", name, t, shape)

    lib = _build.load()
    kw = dict(dtype=A.dtype, device=A.device)
    K = torch.empty((N, m, n), **kw)
    d = torch.empty((N, m), **kw)
    P = torch.empty((N + 1, n, n), **kw)
    p = torch.empty((N + 1, n), **kw)
    dV = torch.empty((2,), **kw)
    ok = torch.empty((), dtype=torch.bool, device=A.device)
    fail = torch.empty((), dtype=torch.int32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.riccati_latency_f32(
        A.data_ptr(), B.data_ptr(), lxx.data_ptr(), luu.data_ptr(),
        0 if lux is None else lux.data_ptr(), 0 if f is None else f.data_ptr(),
        lx.data_ptr(), lu.data_ptr(), reg_t.data_ptr(),
        K.data_ptr(), d.data_ptr(), P.data_ptr(), p.data_ptr(), dV.data_ptr(),
        ok.data_ptr(), fail.data_ptr(),
        N, n, m, int(diag_x), int(diag_u), stream)
    _build.check(err, "riccati_latency_f32")
    LAUNCHES += 1
    return TVLQRGains(K, d, P, p, dV, ok, fail)
