"""Batched Riccati backward pass: the CUDA kernel and its plain twin.

Counterpart: altro_tpu/ops/pallas_riccati.py::riccati_backward_pallas_tiled
(the Pallas kernel `_kernel` run by `_run_tiled`). The TPU kernel held
every matrix entry as an (8, 128) tile of 1024 lanes; the port's layout
is lane-minor, `[N(+1), entry..., B]`, and csrc/riccati_backward.cu runs
one thread per lane with the cost-to-go carry in registers.

Both versions compute, per lane, for k = N-1 .. 0:

    Qxx = lxx + A'P'A,  Quu = luu + B'P'B,  Qux = (lux +) B'P'A
    Qx = lx + A'(P'f + p'),  Qu = lu + B'(P'f + p')
    L = chol(Quu + reg I)   (guarded sqrt(max(pivot, 1e-30)))
    K = (L L')^-1 Qux,  d = -(L L')^-1 Qu,  both selected to 0 at a
        failed knot (a select, never a multiply: 0*inf would poison P)
    P = Qxx - Qux'K - reg K'K   (upper triangle, mirrored)
    p = Qx + Qux'd + reg K'd
    dV += (d.Qu, -(d.Qu + reg d.d)/2)

with ok = no knot failed and fail_index = the smallest failing knot (N
when none), the contract of altro_tpu/tvlqr.py::tvlqr_backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Gains", "riccati_backward", "riccati_backward_ref", "LAUNCHES"]

# Count of kernel launches (plain integer; the CPU path never adds to it).
LAUNCHES = 0

# (n, m) pairs the CUDA kernel is instantiated for.
KERNEL_SHAPES = ((4, 2),)


class Gains(NamedTuple):
    """Backward-pass output, lane-minor."""

    K: torch.Tensor  # [N, m, n, B]
    d: torch.Tensor  # [N, m, B]
    P: torch.Tensor  # [N+1, n, n, B]
    p: torch.Tensor  # [N+1, n, B]
    delta_V: torch.Tensor  # [2, B]
    ok: torch.Tensor  # [B] bool
    fail_index: torch.Tensor  # [B] int32


def _diag(v):
    """[c, B] diagonal -> [c, c, B] matrix."""
    c = v.shape[0]
    eye = torch.eye(c, dtype=v.dtype, device=v.device)
    return eye[:, :, None] * v[:, None, :]


def riccati_backward_ref(A, B, lxx, luu, lx, lu, reg, lux=None, f=None) -> Gains:
    """Plain PyTorch backward pass, batched over the last axis.

    A [N, n, n, B], B [N, n, m, B]; lxx [N+1, n, n, B] or diagonals
    [N+1, n, B]; luu [N, m, m, B] or [N, m, B]; lx [N+1, n, B];
    lu [N, m, B]; reg scalar or [B]; lux [N, m, n, B] or None; f [N, n, B]
    or None (zero affine term). A Python loop over knots.
    """
    N, n, m, Bsz = A.shape[0], A.shape[1], B.shape[2], A.shape[-1]
    dt, dev = A.dtype, A.device
    diag_x = lxx.ndim == 3
    diag_u = luu.ndim == 3
    reg = torch.as_tensor(reg, dtype=dt, device=dev).expand(Bsz)
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=dev))[:, :, None]

    K_out = A.new_empty((N, m, n, Bsz))
    d_out = A.new_empty((N, m, Bsz))
    P_out = A.new_empty((N + 1, n, n, Bsz))
    p_out = A.new_empty((N + 1, n, Bsz))
    P_next = _diag(lxx[N]) if diag_x else lxx[N]
    p_next = lx[N]
    P_out[N] = P_next
    p_out[N] = p_next
    dV0 = A.new_zeros(Bsz)
    dV1 = A.new_zeros(Bsz)
    fail = torch.full((Bsz,), N, dtype=torch.int32, device=dev)

    for k in reversed(range(N)):
        A_k, B_k = A[k], B[k]
        AtP = torch.einsum("lib,ljb->ijb", A_k, P_next)
        BtP = torch.einsum("lib,ljb->ijb", B_k, P_next)
        Qxx = (_diag(lxx[k]) if diag_x else lxx[k]) + torch.einsum("ilb,ljb->ijb", AtP, A_k)
        Quu = (_diag(luu[k]) if diag_u else luu[k]) + torch.einsum("ilb,ljb->ijb", BtP, B_k)
        Qux = torch.einsum("ilb,ljb->ijb", BtP, A_k)
        if lux is not None:
            Qux = lux[k] + Qux
        t = p_next if f is None else torch.einsum("ijb,jb->ib", P_next, f[k]) + p_next
        Qx = lx[k] + torch.einsum("lib,lb->ib", A_k, t)
        Qu = lu[k] + torch.einsum("lib,lb->ib", B_k, t)

        # unrolled Cholesky of Quu + reg I, per lane
        L = [[None] * m for _ in range(m)]
        ok_k = torch.ones(Bsz, dtype=torch.bool, device=dev)
        for j in range(m):
            piv = Quu[j, j] + reg
            for kk in range(j):
                piv = piv - L[j][kk] * L[j][kk]
            ok_k = ok_k & (piv > 0.0)
            ljj = torch.sqrt(torch.clamp(piv, min=1e-30))
            L[j][j] = ljj
            inv = 1.0 / ljj
            for i in range(j + 1, m):
                s = Quu[i, j]
                for kk in range(j):
                    s = s - L[i][kk] * L[j][kk]
                L[i][j] = s * inv

        # (L L') [K | d] = [Qux | -Qu], all right-hand sides at once
        y = list(torch.cat([Qux, -Qu[:, None]], dim=1))  # m rows of [n+1, B]
        for i in range(m):
            s = y[i]
            for kk in range(i):
                s = s - L[i][kk] * y[kk]
            y[i] = s / L[i][i]
        for i in reversed(range(m)):
            s = y[i]
            for kk in range(i + 1, m):
                s = s - L[kk][i] * y[kk]
            y[i] = s / L[i][i]
        sol = torch.stack(y)
        sol = torch.where(ok_k, sol, torch.zeros_like(sol))
        K_k, d_k = sol[:, :n], sol[:, n]

        S = torch.einsum("lib,ljb->ijb", K_k, Qux)
        KtK = torch.einsum("lib,ljb->ijb", K_k, K_k)
        P_full = Qxx - S - reg * KtK
        P_k = torch.where(upper, P_full, P_full.transpose(0, 1))
        p_k = (Qx + torch.einsum("lib,lb->ib", Qux, d_k)
               + reg * torch.einsum("lib,lb->ib", K_k, d_k))

        dQu = torch.sum(d_k * Qu, dim=0)
        dd = torch.sum(d_k * d_k, dim=0)
        dV0 = dV0 + dQu
        dV1 = dV1 - 0.5 * (dQu + reg * dd)
        fail = torch.where(ok_k, fail, torch.full_like(fail, k))

        K_out[k], d_out[k], P_out[k], p_out[k] = K_k, d_k, P_k, p_k
        P_next, p_next = P_k, p_k

    return Gains(K_out, d_out, P_out, p_out, torch.stack([dV0, dV1]),
                 fail == N, fail)


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"riccati_backward kernel: {name} must be float32, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"riccati_backward kernel: {name} is not on a CUDA device")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"riccati_backward kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"riccati_backward kernel: {name} must be contiguous")


def riccati_backward(A, B, lxx, luu, lx, lu, reg, lux=None, diag_cost=False,
                     symmetrize=False) -> Gains:
    """Batched Riccati backward pass on lane-minor operands.

    A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/riccati_backward.cu or raises. The kernel takes the main path's
    form: diagonal lxx [N+1, n, B] and luu [N, m, B], no cross Hessian,
    float32, (n, m) in KERNEL_SHAPES. `symmetrize` is refused: P is
    symmetric by construction (upper triangle mirrored).
    """
    global LAUNCHES
    if symmetrize:
        raise ValueError("riccati_backward computes a symmetric P by construction; "
                         "symmetrize_ctg is not supported")
    if not A.is_cuda:
        return riccati_backward_ref(A, B, lxx, luu, lx, lu, reg, lux=lux)
    if not diag_cost or lux is not None:
        raise NotImplementedError(
            "riccati_backward kernel: only the diagonal-cost form without a cross "
            "Hessian (diag_cost=True, lux=None) is implemented")
    N, n, m, Bsz = A.shape[0], A.shape[1], B.shape[2], A.shape[-1]
    if (n, m) not in KERNEL_SHAPES:
        raise NotImplementedError(
            f"riccati_backward kernel: no instantiation for n={n}, m={m}")
    _check("A", A, (N, n, n, Bsz))
    _check("B", B, (N, n, m, Bsz))
    _check("lxx", lxx, (N + 1, n, Bsz))
    _check("luu", luu, (N, m, Bsz))
    _check("lx", lx, (N + 1, n, Bsz))
    _check("lu", lu, (N, m, Bsz))
    _check("reg", reg, (Bsz,))

    from altro_tpu_torch.ops import _build

    lib = _build.load()
    K = torch.empty((N, m, n, Bsz), dtype=A.dtype, device=A.device)
    d = torch.empty((N, m, Bsz), dtype=A.dtype, device=A.device)
    P = torch.empty((N + 1, n, n, Bsz), dtype=A.dtype, device=A.device)
    p = torch.empty((N + 1, n, Bsz), dtype=A.dtype, device=A.device)
    dV = torch.empty((2, Bsz), dtype=A.dtype, device=A.device)
    ok = torch.empty((Bsz,), dtype=torch.bool, device=A.device)
    fail = torch.empty((Bsz,), dtype=torch.int32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.riccati_backward_diag_f32(
        A.data_ptr(), B.data_ptr(), lxx.data_ptr(), luu.data_ptr(),
        lx.data_ptr(), lu.data_ptr(), reg.data_ptr(),
        K.data_ptr(), d.data_ptr(), P.data_ptr(), p.data_ptr(),
        dV.data_ptr(), ok.data_ptr(), fail.data_ptr(),
        N, n, m, Bsz, stream)
    _build.check(err, "riccati_backward_diag_f32")
    LAUNCHES += 1
    return Gains(K, d, P, p, dV, ok, fail)
