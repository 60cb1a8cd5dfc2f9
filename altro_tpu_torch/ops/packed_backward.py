"""Latency-path Riccati backward dispatch (one lane).

Counterpart: altro_tpu/ops/packed_backward.py::tvlqr_backward_latency.
The JAX dispatcher picked the packed Pallas kernel on an unbatched f32
TPU trace and the scan otherwise. Here the device of the operands
decides, through the kernel wrapper (ops/riccati_latency.py): CPU
tensors run the plain version; CUDA tensors run the kernel
(csrc/riccati_latency.cu) or raise with the reason (float64 on the card
is such a case: a caller who wants the plain path there sets
`SolverOptions.pallas_latency_backward=False`).
"""

from __future__ import annotations

from altro_tpu_torch.ops.riccati_latency import riccati_latency
from altro_tpu_torch.tvlqr import TVLQRGains

__all__ = ["tvlqr_backward_latency"]


def tvlqr_backward_latency(A, B, f, lxx, luu, lux, lx, lu, reg,
                           symmetrize: bool = False) -> TVLQRGains:
    """Single-lane backward pass on unbatched operands (A [N, n, n], ...).
    f=None declares the affine dynamics term identically zero and elides
    its products; `symmetrize` is accepted and ignored (P is symmetric by
    construction)."""
    return riccati_latency(A, B, lxx, luu, lx, lu, reg, lux=lux, f=f, symmetrize=symmetrize)
