"""Time-varying LQR backward pass, batched (PyTorch port).

Counterpart: altro_tpu/tvlqr.py::tvlqr_backward. Where the JAX function
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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref

__all__ = ["TVLQRGains", "tvlqr_backward"]


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
