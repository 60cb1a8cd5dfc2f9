"""Time-varying LQR backward and forward passes, batched (PyTorch port).

Counterpart: altro_tpu/tvlqr.py (`tvlqr_backward`, `tvlqr_forward`,
`tvlqr_backward_associative`, `tvlqr_forward_associative`).
Where the JAX function
handles one lane (and is vmapped), this one takes a batch, batch-major
like `jax.vmap(tvlqr_backward)`: A [B, N, n, n], B [B, N, n, m],
f [B, N, n], lxx [B, N+1, n, n] (or diagonals [B, N+1, n]), luu
[B, N, m, m] (or [B, N, m]), lux [B, N, m, n] or None, lx [B, N+1, n],
lu [B, N, m], reg a scalar or [B]. It is the plain reference of the
backward kernel: the arrays go lane-minor and through
ops/riccati_backward.py::riccati_backward_ref.

The cost-to-go uses the Cholesky identity P = Qxx - Qux'K - reg K'K,
equal in exact arithmetic to the JAX scan's Qxx + K'QuuK - K'Qux - Qux'K,
with its upper triangle mirrored, so P is symmetric by construction and
`symmetrize` changes nothing.

The associative (parallel-in-time) passes take dense operands with any
leading batch dims, the knot axis third from last on matrices ([..., N,
n, n]) and second from last on vectors ([..., N, n]). JAX suffix-scans
the value elements with `lax.associative_scan`; here the scan is an
explicit log-depth loop (Hillis-Steele doubling: for offsets 1, 2, 4, ..
element i is composed with element i + offset), each step one batched
composition over the knot axis. The tree differs from XLA's, which
moves roundoff only. The small solves are `torch.linalg.cholesky_ex` and
`solve_ex` (no error check, so no host sync on the card); vectors ride
as [..., n, 1] columns inside. On the card, float32 products must not
run in TF32 (`torch.backends.cuda.matmul.allow_tf32`, off by default):
its 10-bit mantissa is far outside the pass's 1e-5 accuracy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref

__all__ = ["TVLQRGains", "tvlqr_backward", "tvlqr_forward", "tvlqr_backward_associative",
           "tvlqr_forward_associative"]


class TVLQRGains(NamedTuple):
    K: torch.Tensor  # [B, N, m, n]
    d: torch.Tensor  # [B, N, m]
    P: torch.Tensor  # [B, N+1, n, n]
    p: torch.Tensor  # [B, N+1, n]
    delta_V: torch.Tensor  # [B, 2]
    ok: torch.Tensor  # [B] bool
    fail_index: torch.Tensor  # [B] int32


def _lanes(t):
    return None if t is None else t.movedim(0, -1)


def _batch(t):
    return t.movedim(-1, 0)


def tvlqr_backward(A, B, f, lxx, luu, lux, lx, lu, reg=0.0,
                   symmetrize: bool = False) -> TVLQRGains:
    """Batched Riccati backward pass (see module docstring)."""
    del symmetrize  # P is symmetric by construction
    g = riccati_backward_ref(_lanes(A), _lanes(B), _lanes(lxx), _lanes(luu),
                             _lanes(lx), _lanes(lu), reg, lux=_lanes(lux), f=_lanes(f))
    return TVLQRGains(_batch(g.K), _batch(g.d), _batch(g.P), _batch(g.p),
                      _batch(g.delta_V), g.ok, g.fail_index)


def tvlqr_forward(A, B, f, K, d, P, p, x0):
    """Affine closed-loop rollout of the linearized dynamics:
    u_k = d_k - K_k x_k, x_{k+1} = A_k x_k + B_k u_k + f_k, and the dual
    estimate y_k = P_k x_k + p_k. One lane (A [N, n, n], B [N, n, m],
    f [N, n], K [N, m, n], d [N, m], P [N+1, n, n], p [N+1, n], x0 [n]) or
    a leading batch on every operand, batch-major as `tvlqr_backward`.
    Returns (x [.., N+1, n], u [.., N, m], y [.., N+1, n])."""
    N = A.shape[-3]

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    x, xs, us, ys = x0, [], [], []
    for k in range(N):
        u = d[..., k, :] - mv(K[..., k, :, :], x)
        xs.append(x)
        us.append(u)
        ys.append(mv(P[..., k, :, :], x) + p[..., k, :])
        x = mv(A[..., k, :, :], x) + mv(B[..., k, :, :], u) + f[..., k, :]
    xs.append(x)
    ys.append(mv(P[..., N, :, :], x) + p[..., N, :])
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2), torch.stack(ys, dim=-2)


# ---------------------------------------------------------------------------
# Parallel-in-time (associative) passes: altro_tpu/tvlqr.py:198-426. Each
# stage becomes a conditional value element (A, b, C, eta, J) with an
# associative composition; its suffix scan gives the cost-to-go, and the
# gains follow knot by knot in one batched solve.
# ---------------------------------------------------------------------------


def _t(M):
    return M.transpose(-1, -2)


def _sym(M):
    return 0.5 * (M + _t(M))


def _psd_solve(M, rhs):
    """Solve M X = rhs for symmetric positive definite M [..., m, m]:
    (X, ok [...]); ok is False where a pivot is not positive and finite
    (X is then finite and meaningless, as JAX's psd_solve_small's)."""
    L, info = torch.linalg.cholesky_ex(M)
    ok = (info == 0) & torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    L = torch.where(ok[..., None, None], L, eye)
    return torch.cholesky_solve(rhs, L), ok


def _lu_solve(M, rhs):
    """Solve M X = rhs for general square M (LU, partial pivoting)."""
    return torch.linalg.solve_ex(M, rhs)[0]


def _combine_value_elements(a, b):
    """Compose element a (the earlier span) with element b (the later one).

    Elements (A, b, C, eta, J), b and eta as [..., n, 1] columns,
    parameterize V(x_i, x_j) = 0.5 |x_j - A x_i - b|^2_{C^-1}
    + 0.5 x_i' J x_i - eta' x_i; only (I + C J)^-1 appears, and I + C J
    is not symmetric, so both solves are LU."""
    Aa, ba, Ca, etaa, Ja = a
    Ab, bb, Cb, etab, Jb = b
    n = Aa.shape[-1]
    eye = torch.eye(n, dtype=Aa.dtype, device=Aa.device)

    M = _lu_solve(eye + Ca @ Jb, torch.cat([Aa, ba + Ca @ etab, Ca], dim=-1))
    A = Ab @ M[..., :n]
    b_out = Ab @ M[..., n:n + 1] + bb
    C = Ab @ M[..., n + 1:] @ _t(Ab) + Cb

    N2 = _lu_solve(eye + Jb @ Ca, torch.cat([etab - Jb @ ba, Jb @ Aa], dim=-1))
    eta = _t(Aa) @ N2[..., :1] + etaa
    J = _t(Aa) @ N2[..., 1:] + Ja
    return A, b_out, _sym(C), eta, _sym(J)


def _identity_elements(shape, n, dtype, device):
    """Composition-identity elements (A = I, b = 0, C = 0, eta = 0, J = 0)
    with leading dims `shape`: combine(x, id) == combine(id, x) == x."""
    def z(k):
        return torch.zeros(shape + (n, k), dtype=dtype, device=device)

    eye = torch.eye(n, dtype=dtype, device=device).expand(shape + (n, n))
    return eye.clone(), z(1), z(n), z(1), z(n)


def _knots(elems, sl):
    """The elements at knots `sl` (the knot axis is third from last)."""
    return tuple(e[..., sl, :, :] for e in elems)


def _suffix_scan(elems):
    """Inclusive suffix composition along the knot axis: out[i] = e_i o
    e_{i+1} o .. o e_{T-1}, in ceil(log2 T) batched compositions."""
    T = elems[0].shape[-3]
    off = 1
    while off < T:
        head = _combine_value_elements(_knots(elems, slice(0, T - off)),
                                       _knots(elems, slice(off, T)))
        elems = tuple(torch.cat([h, e[..., T - off:, :, :]], dim=-3)
                      for h, e in zip(head, elems))
        off *= 2
    return elems


def _two_level_suffix(elems, L):
    """Two-level suffix composition (altro_tpu/tvlqr.py:254-307): the scan
    within chunks of L knots, then a serial composition across the
    chunks' totals, so no element spans more than L stages (the f32 form
    at long horizons). Returns the cost-to-go (P [..., T, n, n],
    p [..., T, n])."""
    T, n = elems[0].shape[-3], elems[0].shape[-1]
    lead = elems[0].shape[:-3]
    S = -(-T // L)
    if S * L > T:
        ids = _identity_elements(lead + (S * L - T,), n, elems[0].dtype, elems[0].device)
        elems = tuple(torch.cat([e, i], dim=-3) for e, i in zip(elems, ids))
    within = _suffix_scan(tuple(e.reshape(lead + (S, L) + e.shape[-2:]) for e in elems))
    totals = tuple(w[..., 0, :, :] for w in within)  # [..., S, n, k]
    carry = _identity_elements(lead, n, elems[0].dtype, elems[0].device)
    after = [None] * S  # after[s]: chunks s+1 .. S-1 composed
    for s in reversed(range(S)):
        after[s] = carry
        carry = _combine_value_elements(_knots(totals, s), carry)
    after = tuple(torch.stack(a, dim=-3)[..., None, :, :].expand_as(w)
                  for a, w in zip(zip(*after), within))
    full = _combine_value_elements(within, after)
    P = full[4].reshape(lead + (S * L, n, n))[..., :T, :, :]
    p = -full[3].reshape(lead + (S * L, n))[..., :T, :]
    return P, p


def tvlqr_backward_associative(A, B, f, lxx, luu, lux, lx, lu, reg=0.0,
                               chunk=None) -> TVLQRGains:
    """Parallel Riccati backward pass (altro_tpu/tvlqr.py:310-403): the
    results of `tvlqr_backward` to roundoff, in O(log N) sequential depth.

    Dense operands with any leading batch dims (module docstring): A
    [..., N, n, n], B [..., N, n, m], f [..., N, n] or None (zero), lxx
    [..., N+1, n, n], luu [..., N, m, m], lux [..., N, m, n] or None, lx
    [..., N+1, n], lu [..., N, m]; reg a scalar or one per batch entry.
    chunk None (or outside 0 < chunk < N + 1, as JAX) runs the pure
    suffix scan; chunk=L the two-level form, whose elements span at most
    L stages. Each stage inverts luu + reg I (not Quu), so luu must be
    positive definite on its own, as an AL problem's is. A failed
    factorization is flagged per knot: ok is False, fail_index the first
    failing knot (N when none), and that knot's gains are zero."""
    N, n, m = A.shape[-3], A.shape[-1], B.shape[-1]
    dt, dev = A.dtype, A.device
    lead = A.shape[:-3]
    reg = torch.as_tensor(reg, dtype=dt, device=dev)
    reg_m = reg.reshape(reg.shape + (1, 1, 1)) * torch.eye(m, dtype=dt, device=dev)
    f = A.new_zeros(lead + (N, n, 1)) if f is None else f[..., None]
    if lux is None:
        lux = A.new_zeros(lead + (N, m, n))
    lx_, lu_ = lx[..., None], lu[..., None]

    elems, ok_stage = _stage_elements(A, B, f, lxx[..., :N, :, :], luu, lux, lx_[..., :N, :, :],
                                      lu_, reg_m)
    # the terminal element: a pure cost on x_N
    zm = A.new_zeros(lead + (1, n, n))
    term = (zm, A.new_zeros(lead + (1, n, 1)), zm, -lx_[..., N:, :, :], lxx[..., N:, :, :])
    elems = tuple(torch.cat([e, t], dim=-3) for e, t in zip(elems, term))

    if chunk is not None and 0 < int(chunk) < N + 1:
        P, p = _two_level_suffix(elems, int(chunk))
    else:
        suffix = _suffix_scan(elems)
        P, p = suffix[4], -suffix[3][..., 0]

    K, d, dV, ok_gain = _gains(A, B, f, luu, lux, lu_, P[..., 1:, :, :], p[..., 1:, :, None],
                               reg_m)
    ok_all = ok_stage & ok_gain
    fail = torch.where(ok_all, N, torch.arange(N, device=dev)).amin(-1).to(torch.int32)
    # contiguous, as the kernels downstream (the trial rollout) take them
    return TVLQRGains(*(t.contiguous() for t in (K, d[..., 0], P, p, dV.sum(-2))),
                      ok_all.all(-1), fail)


def _stage_elements(A, B, f, Q, R, H, q, r, reg_m):
    """Each stage's value element and its factorization flag
    (altro_tpu/tvlqr.py:338-353): with R^-1 = (luu + reg I)^-1, the
    element (A - B R^-1 H, f - B R^-1 r, B R^-1 B', -(q - H' R^-1 r),
    Q - H' R^-1 H); f, q, r as columns."""
    n = A.shape[-1]
    sol, ok = _psd_solve(R + reg_m, torch.cat([H, r, _t(B)], dim=-1))
    RiH, Rir, RiBt = sol[..., :n], sol[..., n:n + 1], sol[..., n + 1:]
    Ht = _t(H)
    return (A - B @ RiH, f - B @ Rir, _sym(B @ RiBt), -(q - Ht @ Rir), _sym(Q - Ht @ RiH)), ok


def _gains(A, B, f, R, H, r, P1, p1, reg_m):
    """Each knot's gains from the next knot's cost-to-go (P1, p1 as a
    column), every knot at once (altro_tpu/tvlqr.py:379-392): K, d (a
    column), delta_V's two terms [..., 2] and the flag; a failed knot's
    gains are zero."""
    n = A.shape[-1]
    Bt = _t(B)
    BtP = Bt @ P1
    Quu = R + BtP @ B
    Qux = H + BtP @ A
    Qu = r + Bt @ (P1 @ f + p1)
    sol, ok = _psd_solve(Quu + reg_m, torch.cat([Qux, -Qu], dim=-1))
    keep = ok[..., None, None]
    K = torch.where(keep, sol[..., :n], 0.0)
    d = torch.where(keep, sol[..., n:], 0.0)
    dV = torch.cat([(_t(d) @ Qu)[..., 0], 0.5 * (_t(d) @ Quu @ d)[..., 0]], dim=-1)
    return K, d, dV, ok


def tvlqr_forward_associative(A, B, f, K, d, P, p, x0):
    """Parallel affine closed-loop rollout (altro_tpu/tvlqr.py:406-426):
    x' = (A - BK) x + (Bd + f) composed as affine maps by a log-depth
    prefix scan. The results of `tvlqr_forward`, with its shapes."""
    N = A.shape[-3]
    M = A - B @ K
    v = B @ d[..., None] + f[..., None]
    off = 1
    while off < N:  # inclusive prefix: (M, v)[k] maps x_0 to x_{k+1}
        Ma, va = M[..., :N - off, :, :], v[..., :N - off, :, :]
        Mb, vb = M[..., off:, :, :], v[..., off:, :, :]
        M = torch.cat([M[..., :off, :, :], Mb @ Ma], dim=-3)
        v = torch.cat([v[..., :off, :, :], Mb @ va + vb], dim=-3)
        off *= 2
    x_rest = (M @ x0[..., None, :, None] + v)[..., 0]
    x = torch.cat([x0[..., None, :], x_rest], dim=-2)
    u = d - (K @ x[..., :N, :, None])[..., 0]
    y = (P @ x[..., None])[..., 0] + p
    return x, u, y
