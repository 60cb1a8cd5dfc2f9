"""The Gauss-Newton backward pass of `diff.implicit_solve` as a torch operator.

Counterpart: the `tvlqr_backward` call of altro_tpu/diff.py::_gn_solve
(JAX ran its scan there, on one lane or vmapped). Here it is one
operator, `altro_tpu_torch::gn_backward`, so that it composes with
`torch.func.vmap`: the implicit solve's backward runs under the vmap
level with one lane's logical shapes, where a raw-pointer kernel call
cannot run, and the operator's vmap rule takes the whole batch instead.

* One lane (`gn_backward`): with `kernel`, a CUDA tensor runs
  csrc/riccati_latency.cu (ops/riccati_latency.py: dense lxx / luu with
  lux, f elided) or raises with the kernel's reason (float64, an (n, m)
  it lacks); a CPU tensor, or `kernel=False`, runs the plain recursion.
* Under `torch.func.vmap` (`_gn_backward_vmap`): the operands go
  lane-minor and, with `kernel`, a CUDA tensor runs csrc/riccati_dense.cu
  (ops/riccati_dense.py, `<n, m, f=0, lux=1, diag=0>`) or raises; a CPU
  tensor, or `kernel=False`, the batched plain recursion.

Each kernel counts its launches in its own wrapper. The operator has no
derivative of its own: the implicit solve passes it detached operands.
"""

from __future__ import annotations

from typing import Tuple

import torch

from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref
from altro_tpu_torch.ops.riccati_dense import riccati_backward_dense
from altro_tpu_torch.ops.riccati_latency import riccati_latency, riccati_latency_ref

__all__ = ["gn_backward", "lane_minor"]


def lane_minor(t: torch.Tensor, dim, size=None) -> torch.Tensor:
    """An operand of a vmap rule lane-minor: its batched dim moved last;
    an unbatched one (dim None) as it is, or, with `size`, expanded to
    that many lanes."""
    if dim is not None:
        return t.movedim(dim, -1).contiguous()
    return t if size is None else t[..., None].expand(*t.shape, size).contiguous()


@torch.library.custom_op("altro_tpu_torch::gn_backward", mutates_args=())
def gn_backward(A: torch.Tensor, B: torch.Tensor, lxx: torch.Tensor, luu: torch.Tensor,
                lux: torch.Tensor, lx: torch.Tensor, lu: torch.Tensor, reg: torch.Tensor,
                kernel: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lane's Riccati backward pass with f = 0: A [N, n, n],
    B [N, n, m], lxx [N+1, n, n], luu [N, m, m], lux [N, m, n],
    lx [N+1, n], lu [N, m], reg 0-dim. Returns (K [N, m, n], d [N, m],
    P [N+1, n, n], p [N+1, n])."""
    if kernel and A.is_cuda:
        ops = [t.contiguous() for t in (A, B, lxx, luu, lx, lu)]
        g = riccati_latency(*ops, reg.reshape(1).contiguous(), lux=lux.contiguous())
    else:
        g = riccati_latency_ref(A, B, lxx, luu, lx, lu, reg, lux=lux)
    # the kernel's gains are views of one buffer; an operator's outputs own theirs
    return g.K.clone(), g.d.clone(), g.P.clone(), g.p.clone()


@torch.library.register_vmap("altro_tpu_torch::gn_backward")
def _gn_backward_vmap(info, in_dims, A, B, lxx, luu, lux, lx, lu, reg, kernel):
    """The batch of lanes in one call: every operand lane-minor
    ([..., B]; a shared one expanded), the batched backward, the gains
    batch-major on their leading axis."""
    A, B, lxx, luu, lux, lx, lu, reg = (
        lane_minor(t, dim, info.batch_size)
        for t, dim in zip((A, B, lxx, luu, lux, lx, lu, reg), in_dims))
    if kernel and A.is_cuda:
        g = riccati_backward_dense(A, B, None, lxx, luu, lux, lx, lu, reg)
    else:
        g = riccati_backward_ref(A, B, lxx, luu, lx, lu, reg, lux=lux)
    return tuple(t.movedim(-1, 0) for t in (g.K, g.d, g.P, g.p)), (0, 0, 0, 0)
