"""Sequence-parallel Riccati on `torch.distributed` (PyTorch port).

Counterpart: altro_tpu/parallel/horizon.py (`tvlqr_backward_horizon_sharded`,
`tvlqr_backward_batch_horizon_sharded`). The associative pass's value
elements (tvlqr.py) are split by blocks of the horizon over one dim of a
`DeviceMesh`: each rank suffix-scans its block, the block totals go round
in one `all_gather`, each rank composes the totals after its block (a
serial compose over the ranks), applies that tail to its block and forms
its gains; delta_V is summed over the ranks and ok reduced with MIN.

Written SPMD, as JAX's `shard_map` callers call theirs: every rank calls
with the whole arrays and gets the whole `TVLQRGains` back (one more
`all_gather` of K, d, P, p and the per-knot flags), so the results equal
the single-process passes to roundoff. JAX's masked tail compose exists
only because of an XLA miscompile and is not ported. The collectives ride
the mesh dim's process group: gloo on CPU tensors, NCCL on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from altro_tpu_torch.tvlqr import (
    TVLQRGains,
    _combine_value_elements,
    _gains,
    _identity_elements,
    _stage_elements,
    _suffix_scan,
)

__all__ = ["tvlqr_backward_horizon_sharded", "tvlqr_backward_batch_horizon_sharded"]


def _axis(mesh, name: str):
    """(size, this rank's index, process group) of the mesh dim `name`."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)


def _gather(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """Every rank's `t` of the group, concatenated along `dim` in rank order."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _local_block(A, B, f, lxx, luu, lux, lx, lu, term, reg, D, r, group):
    """This rank's block of the (N+1)-row staged horizon (any leading batch
    dims, the knot axis third from last on matrices), JAX's `local_block`
    (altro_tpu/parallel/horizon.py:50-145). Returns the block's rows of K,
    d, P, p (p as [..., L, n]), delta_V summed over the ranks, ok reduced
    with MIN over them, and the block's per-knot flags (terminal slot ok)."""
    n, m = A.shape[-1], B.shape[-1]
    dt = A.dtype
    col = lambda v: v[..., None]  # noqa: E731
    reg_m = reg * torch.eye(m, dtype=dt, device=A.device)
    tm = term[:, None, None]

    stage, ok = _stage_elements(A, B, col(f), lxx, luu, lux, col(lx), col(lu), reg_m)
    zero = torch.zeros((), dtype=dt, device=A.device)
    # the terminal slot: a pure cost element (A = 0, b = 0, C = 0)
    terminal = (zero, zero, zero, -col(lx), lxx)
    elems = tuple(torch.where(tm, t_, s_) for t_, s_ in zip(terminal, stage))
    ok_elems = ok | term

    suffix = _suffix_scan(elems)
    total = torch.cat([s[..., 0, :, :] for s in suffix], dim=-1)  # [..., n, 3n + 2]
    totals = _gather(total[None], group, D, 0)
    cut = [n, 1, n, 1, n]
    tail = _identity_elements(total.shape[:-2], n, dt, A.device)
    for d in reversed(range(r + 1, D)):  # totals[r+1] o .. o totals[D-1]
        tail = _combine_value_elements(tuple(torch.split(totals[d], cut, dim=-1)), tail)

    full = _combine_value_elements(
        suffix, tuple(t_[..., None, :, :].expand_as(s) for t_, s in zip(tail, suffix)))
    P_loc, p_loc = full[4], -full[3]
    P1 = torch.cat([P_loc[..., 1:, :, :], tail[4][..., None, :, :]], dim=-3)
    p1 = torch.cat([p_loc[..., 1:, :, :], -tail[3][..., None, :, :]], dim=-3)

    K, d, dV, ok_g = _gains(A, B, col(f), luu, lux, col(lu), P1, p1, reg_m)
    K, d = torch.where(tm, 0.0, K), torch.where(tm, 0.0, d)
    dV = torch.where(term[:, None], 0.0, dV).sum(-2)
    ok_rows = ok_elems & (ok_g | term)
    dist.all_reduce(dV, op=dist.ReduceOp.SUM, group=group)
    ok_all = ok_rows.all(-1).to(torch.int32)
    dist.all_reduce(ok_all, op=dist.ReduceOp.MIN, group=group)
    return K, d[..., 0], P_loc, p_loc[..., 0], dV, ok_all.bool(), ok_rows


def _staged(A, B, f, luu, lux, lu):
    """JAX's (N+1)-row staging (altro_tpu/parallel/horizon.py:166-174): the
    stage arrays padded by one zero row (luu by the identity, so the
    padded solve is well posed); row N is the terminal slot."""
    m = B.shape[-1]
    pad = lambda a: torch.cat([a, torch.zeros_like(a[..., :1, :])], dim=-2)  # noqa: E731
    pad_m = lambda a: torch.cat([a, torch.zeros_like(a[..., :1, :, :])], dim=-3)  # noqa: E731
    if f is None:
        f = torch.zeros_like(A[..., 0])
    if lux is None:
        lux = torch.zeros_like(_t(B))
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(luu.shape[:-3] + (1, m, m))
    return pad_m(A), pad_m(B), pad(f), torch.cat([luu, eye], dim=-3), pad_m(lux), pad(lu)


def _sharded(A, B, f, lxx, luu, lux, lx, lu, reg, hz, bt):
    """The pass over batch-major stacks [Bsz, ...] with the horizon split
    over `hz` and the batch over `bt` ((size, rank, group) each, or None
    for a batch kept whole); every rank returns the whole gains."""
    N, n, m = A.shape[-3], A.shape[-1], B.shape[-1]
    Bsz = A.shape[0]
    D, r, group = hz
    L = (N + 1) // D
    rows = slice(r * L, (r + 1) * L)
    lanes = slice(None)
    if bt is not None:
        Db, rb, _ = bt
        lanes = slice(rb * (Bsz // Db), (rb + 1) * (Bsz // Db))
    stacks = _staged(A, B, f, luu, lux, lu) + (lxx, lx)
    A_, B_, f_, luu_, lux_, lu_, lxx_, lx_ = (
        s[lanes][:, rows] for s in stacks)
    term = torch.arange(N + 1, device=A.device)[rows] == N
    reg = torch.as_tensor(reg, dtype=A.dtype, device=A.device)
    K, d, P, p, dV, ok, ok_rows = _local_block(A_, B_, f_, lxx_, luu_, lux_, lx_, lu_, term,
                                               reg, D, r, group)
    nb = K.shape[0]
    # one gather over the horizon: K, d, P, p and the per-knot flags by row
    packed = torch.cat([K.reshape(nb, L, m * n), d, P.reshape(nb, L, n * n), p,
                        ok_rows[..., None].to(K.dtype)], dim=-1)
    rows_all = _gather(packed, group, D, 1)
    summary = torch.cat([dV, ok[:, None].to(dV.dtype)], dim=-1)
    if bt is not None:  # and the lanes over the batch dim
        rows_all = _gather(rows_all, bt[2], bt[0], 0)
        summary = _gather(summary, bt[2], bt[0], 0)
    cut = [m * n, m, n * n, n, 1]
    K_f, d_f, P_f, p_f, okr = torch.split(rows_all, cut, dim=-1)
    fail = torch.where(okr[:, :N, 0] > 0, N, torch.arange(N, device=A.device))
    return TVLQRGains(*(t.contiguous() for t in (
        K_f[:, :N].reshape(Bsz, N, m, n), d_f[:, :N], P_f.reshape(Bsz, N + 1, n, n), p_f,
        summary[:, :2])), summary[:, 2] > 0, fail.amin(-1).to(torch.int32))


def tvlqr_backward_horizon_sharded(A, B, f, lxx, luu, lux, lx, lu, mesh, axis: str = "horizon",
                                   reg=0.0) -> TVLQRGains:
    """The parallel Riccati backward pass with the horizon split over the
    mesh dim `axis`: the results of `tvlqr.tvlqr_backward_associative` on
    one lane (A [N, n, n], ..., lx [N+1, n]). (N + 1) must be divisible by
    the dim's size; luu must be positive definite on its own. Every rank
    of the dim calls it with the whole arrays and gets the whole gains."""
    N = A.shape[0]
    hz = _axis(mesh, axis)
    if (N + 1) % hz[0] != 0:
        raise ValueError(f"(N+1)={N + 1} must be divisible by mesh axis size {hz[0]}")
    g = _sharded(*(None if t is None else t[None] for t in (A, B, f, lxx, luu, lux, lx, lu)),
                 reg, hz, None)
    return TVLQRGains(*(t[0] for t in g))


def tvlqr_backward_batch_horizon_sharded(A, B, f, lxx, luu, lux, lx, lu, mesh,
                                         batch_axis: str = "batch", axis: str = "horizon",
                                         reg=0.0) -> TVLQRGains:
    """The 2-D form: independent lanes (A [Bsz, N, n, n], ..., lx [Bsz, N+1,
    n]) split over the mesh dim `batch_axis`, each lane's horizon over
    `axis`. The batch dim's size must divide Bsz, the horizon dim's
    (N + 1). Returns the batched gains of the serial pass on every rank."""
    N = A.shape[1]
    hz, bt = _axis(mesh, axis), _axis(mesh, batch_axis)
    if (N + 1) % hz[0] != 0:
        raise ValueError(f"(N+1)={N + 1} must be divisible by mesh axis size {hz[0]}")
    if A.shape[0] % bt[0] != 0:
        raise ValueError(f"batch {A.shape[0]} must be divisible by mesh axis size {bt[0]}")
    return _sharded(A, B, f, lxx, luu, lux, lx, lu, reg, hz, bt)
