"""Phase-split parallel backtracking line search (PyTorch port, one lane).

Counterpart: altro_tpu/linesearch.py (`LineSearchOptions`,
`LineSearchResult`, `parallel_backtracking_search_split`). The JAX
`lax.while_loop` over grid blocks becomes a Python loop with one host
sync per block beyond the first (on `found`). Scalars are 0-dim tensors
on the solve's device and dtype; a payload is a tensor, a (named) tuple
of payloads, or None. The strong-Wolfe search and the non-split grid are
not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from altro_tpu_torch.status import LineSearchCode

__all__ = [
    "LineSearchOptions",
    "LineSearchResult",
    "parallel_backtracking_search_split",
    "tree_map",
]


class LineSearchOptions(NamedTuple):
    c1: float = 1e-4
    c2: float = 0.9
    max_iters: int = 25
    alpha_max: float = 2.0
    beta_increase: float = 1.5
    beta_decrease: float = 0.5
    min_interval_size: float = 1e-6
    try_cubic_first: bool = True
    use_backtracking: bool = False
    armijo_slack: float = 0.0
    verbose: bool = False


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor
    phi: torch.Tensor
    dphi: torch.Tensor
    code: torch.Tensor  # int32 LineSearchCode
    n_iters: torch.Tensor  # merit evaluations the sequential search would make
    aux: object = ()  # payload of the accepted step
    aux_alpha: object = float("nan")  # alpha of that payload


def tree_map(fn, tree, *rest):
    """Apply fn leaf by leaf over tensors in (named) tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def _stack(trees):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _where(cond, a, b):
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def parallel_backtracking_search_split(
    merit_value: Callable,
    complete: Callable,
    phi0,
    dphi0,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    width: int = 8,
    armijo_only: bool = False,
    reconstruct: Optional[Callable] = None,
    merit_grid: Optional[Callable] = None,
    best_decrease_fallback: bool = False,
) -> LineSearchResult:
    """Grid of trials alpha0 * beta^k in blocks of `width`, first Armijo
    pass wins (trial 0 also needs strong Wolfe unless armijo_only), up to
    opts.max_iters trials; the accepted payload is completed once.

    merit_value(alpha) -> (phi, payload) per trial, or merit_grid(alphas)
    -> (phis [W], payloads stacked on a leading W axis) for a block;
    reconstruct(payload, alpha, phi) rebuilds the light payload from a
    minimal carrier; complete(light, with_dphi) -> (dphi, full payload).
    best_decrease_fallback: when no trial passes, take the lowest-merit
    trial if it decreases the merit (code BEST_DECREASE).
    """
    phi0 = torch.as_tensor(phi0)
    dtype, dev = phi0.dtype, phi0.device
    scal = dict(dtype=dtype, device=dev)
    dphi0 = torch.as_tensor(dphi0, **scal)
    alpha0 = torch.as_tensor(alpha0, **scal)
    beta = torch.as_tensor(opts.beta_decrease, **scal)
    c1 = torch.as_tensor(opts.c1, **scal)
    c2 = torch.as_tensor(opts.c2, **scal)
    slack = torch.as_tensor(opts.armijo_slack, **scal)
    n_blocks = max(1, -(-int(opts.max_iters) // width))
    ar = torch.arange(width, device=dev)

    if merit_grid is None:
        def eval_grid(alphas):
            outs = [merit_value(a) for a in alphas]
            return (torch.stack([torch.as_tensor(p, **scal) for p, _ in outs]),
                    _stack([light for _, light in outs]))
    else:
        def eval_grid(alphas):
            phis, lights = merit_grid(alphas)
            return phis.to(dtype), lights

    def armijo_mask(alphas, phis):
        return phis <= phi0 + c1 * alphas * dphi0 + slack * torch.abs(phi0)

    def pick(lights, i):
        return tree_map(lambda a: a[i], lights)

    # block 0: needs trial 0's dphi for the strong-Wolfe test (unless armijo_only)
    ks0 = ar
    alphas0 = alpha0 * beta ** ks0.to(dtype)
    phis0, lights0 = eval_grid(alphas0)
    armijo0 = armijo_mask(alphas0, phis0)
    if armijo_only:
        passes0 = armijo0
    else:
        light_first = pick(lights0, 0)
        if reconstruct is not None:
            light_first = reconstruct(light_first, alphas0[0], phis0[0])
        dphi_first, _ = complete(light_first)
        wolfe_first = torch.abs(dphi_first) <= -c2 * dphi0
        passes0 = torch.where(ks0 == 0, armijo0 & wolfe_first, armijo0)
    found = torch.any(passes0)
    idx = torch.argmax(passes0.to(torch.int32))
    k_acc, alpha_acc, phi_acc, light_acc = ks0[idx], alphas0[idx], phis0[idx], pick(lights0, idx)
    if best_decrease_fallback:
        bi = torch.argmin(phis0)
        bk, balpha, bphi, blight = ks0[bi], alphas0[bi], phis0[bi], pick(lights0, bi)

    # deeper blocks: Armijo only, one host sync per block on `found`
    block = 1
    while block < n_blocks and not bool(found):
        ks = block * width + ar
        alphas = alpha0 * beta ** ks.to(dtype)
        phis, lights = eval_grid(alphas)
        passes = armijo_mask(alphas, phis)
        found = torch.any(passes)
        idx = torch.argmax(passes.to(torch.int32))
        k_acc, alpha_acc, phi_acc, light_acc = ks[idx], alphas[idx], phis[idx], pick(lights, idx)
        if best_decrease_fallback:
            bi = torch.argmin(phis)
            take_best = phis[bi] < bphi
            bk = torch.where(take_best, ks[bi], bk)
            balpha = torch.where(take_best, alphas[bi], balpha)
            bphi = torch.where(take_best, phis[bi], bphi)
            blight = _where(take_best, pick(lights, bi), blight)
        block += 1

    not_descent = dphi0 >= 0
    ok = found & ~not_descent
    if best_decrease_fallback:
        fb = ~ok & (bphi < phi0)
        k_acc = torch.where(fb, bk, k_acc)
        alpha_acc = torch.where(fb, balpha, alpha_acc)
        phi_acc = torch.where(fb, bphi, phi_acc)
        light_acc = _where(fb, blight, light_acc)
    else:
        fb = torch.zeros_like(ok)

    # complete the accepted step's payload (once)
    if reconstruct is not None:
        light_acc = reconstruct(light_acc, alpha_acc, phi_acc)
    dphi_acc, aux_acc = complete(light_acc, with_dphi=not armijo_only)

    def code_of(c):
        return torch.tensor(int(c), dtype=torch.int32, device=dev)

    code = torch.where(ok, code_of(LineSearchCode.MINIMUM_FOUND),
                       torch.where(fb, code_of(LineSearchCode.BEST_DECREASE),
                                   torch.where(not_descent,
                                               code_of(LineSearchCode.NOT_DESCENT_DIRECTION),
                                               code_of(LineSearchCode.NO_ERROR))))
    take = ok | fb
    zero = torch.zeros((), **scal)
    nan = torch.full((), float("nan"), **scal)
    return LineSearchResult(
        alpha=torch.where(take, alpha_acc, zero),
        phi=phi_acc,
        dphi=dphi_acc,
        code=code,
        n_iters=torch.where(ok, k_acc + 1,
                            torch.full_like(k_acc, opts.max_iters)).to(torch.int32),
        aux=aux_acc,
        aux_alpha=torch.where(take, alpha_acc, nan),
    )
