"""Single-lane Riccati backward pass (latency): the CUDA kernel and its plain twin.

Counterpart: altro_tpu/ops/pallas_packed.py::riccati_backward_pallas_packed
(the Pallas `_kernel` and `_knot_body`, and the unpacking after the call).
The TPU kernel packed each knot's operands into one (8, 128) tile and ran
the N-knot chain as a sequential grid; csrc/riccati_latency.cu runs it in
one thread block: three copy warps stage chunks of knots through shared
memory (double-buffered) while the compute warps (one; two at (6, 3),
five at (12, 4)) compute each knot together, a thread per entry of the Q
blocks and then of the new (P, p).

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

import collections

import torch

from altro_tpu_torch.ops import _build
from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref
from altro_tpu_torch.tvlqr import TVLQRGains

__all__ = ["LAUNCHES", "VARIANT_LAUNCHES", "KERNEL_SHAPES", "riccati_latency_ref",
           "output_views", "riccati_latency"]

# Count of kernel launches (plain integer; the CPU path never adds to it).
LAUNCHES = 0
# The same launches by instantiation, (n, m, diag_x, diag_u, lux, f) -> count.
VARIANT_LAUNCHES = collections.Counter()

# (n, m) pairs the CUDA kernel is instantiated for (csrc/riccati_latency.cu's
# entry guard and dispatch): the bicycle and double integrator, the
# pendulum, the quadrotor, the rocket, the cartpole and the facade's
# heterogeneous problem padded to (3, 2) (tests/test_hetero_dims.py).
KERNEL_SHAPES = ((4, 2), (2, 1), (12, 4), (6, 3), (4, 1), (3, 2))


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


def _pad4(count: int) -> int:
    """count floats rounded up to whole 16-byte rows."""
    return -(-count // 4) * 4


def output_views(N: int, n: int, m: int, device) -> TVLQRGains:
    """The kernel's outputs as views of ONE float32 buffer: P [N+1, n, n],
    K [N, m, n], p [N+1, n], d [N, m], delta_V [2] (in that order, each
    starting on a 16-byte boundary: every array is padded to whole
    16-byte rows), then fail_index (int32) and ok (bool), each 0-dim, in
    the last two words."""
    oK = _pad4((N + 1) * n * n)
    op = oK + _pad4(N * m * n)
    od = op + _pad4((N + 1) * n)
    ov = od + _pad4(N * m)
    buf = torch.empty(ov + 4, dtype=torch.float32, device=device)
    flags = buf[ov + 2:].view(torch.int32)
    return TVLQRGains(buf.as_strided((N, m, n), (m * n, n, 1), oK),
                      buf.as_strided((N, m), (m, 1), od),
                      buf.as_strided((N + 1, n, n), (n * n, n, 1), 0),
                      buf.as_strided((N + 1, n), (n, 1), op),
                      buf.as_strided((2,), (1,), ov), flags.view(torch.bool)[4], flags[0])


def riccati_latency(A, B, lxx, luu, lx, lu, reg=0.0, lux=None, f=None,
                    symmetrize=False) -> TVLQRGains:
    """Single-lane backward pass: the plain version for CPU tensors, the
    CUDA kernel (csrc/riccati_latency.cu) for CUDA tensors, or a raise
    when the kernel does not take them (not float32, (n, m) not in
    KERNEL_SHAPES, wrong shape, not contiguous). The kernel reads `reg`
    from the device: a one-element float32 CUDA tensor, as the solve
    passes it, or a Python number, copied there first."""
    global LAUNCHES
    del symmetrize  # P is symmetric by construction (see module docstring)
    if not A.is_cuda:
        return riccati_latency_ref(A, B, lxx, luu, lx, lu, reg, lux=lux, f=f)
    N, n, m = A.shape[0], A.shape[1], B.shape[2]
    if (n, m) not in KERNEL_SHAPES:
        raise NotImplementedError(f"riccati_latency kernel: no instantiation for n={n}, m={m}")
    diag_x, diag_u = lxx.ndim == 2, luu.ndim == 2
    ops = [("A", A, (N, n, n)), ("B", B, (N, n, m)),
           ("lxx", lxx, (N + 1, n) if diag_x else (N + 1, n, n)),
           ("luu", luu, (N, m) if diag_u else (N, m, m)),
           ("lx", lx, (N + 1, n)), ("lu", lu, (N, m))]
    if lux is not None:
        ops.append(("lux", lux, (N, m, n)))
    if f is not None:
        ops.append(("f", f, (N, n)))
    if not torch.is_tensor(reg):
        reg = torch.tensor(float(reg), dtype=A.dtype, device=A.device)
    ops.append(("reg", reg.reshape(-1), (1,)))
    _build.check_operands("riccati_latency", ops)

    lib = _build.load()
    g = output_views(N, n, m, A.device)
    err = lib.riccati_latency_f32(
        A.data_ptr(), B.data_ptr(), lxx.data_ptr(), luu.data_ptr(),
        None if lux is None else lux.data_ptr(), None if f is None else f.data_ptr(),
        lx.data_ptr(), lu.data_ptr(), reg.data_ptr(),
        g.K.data_ptr(), g.d.data_ptr(), g.P.data_ptr(), g.p.data_ptr(), g.delta_V.data_ptr(),
        g.ok.data_ptr(), g.fail_index.data_ptr(),
        N, n, m, int(diag_x), int(diag_u), torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "riccati_latency_f32")
    LAUNCHES += 1
    VARIANT_LAUNCHES[(n, m, diag_x, diag_u, lux is not None, f is not None)] += 1
    return g
