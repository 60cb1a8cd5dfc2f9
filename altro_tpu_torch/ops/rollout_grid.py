"""Batched W-trial line-search rollout: the CUDA kernel and its plain twin.

Counterparts: altro_tpu/ops/pallas_rollout_tiled.py
(`rollout_grid_pallas_tiled`, `rollout_tiled_eligible`),
altro_tpu/ops/tile_iter.py::rollout_grid_tiled (the scan grid the plain
version ports) and altro_tpu/ops/pallas_rollout.py::affine_constraint_stacks.

For each trial step alpha_w and each lane, from x_0 = x0:

    u_k = u_ref_k - K_k (x_k - x_ref_k) + alpha_w d_k
    phi += AL cost at (x_k, u_k);  x_{k+1} = f(x_k, u_k, h_k)

and phi adds the terminal AL cost at x_N. Returns phi [W, B] and the
state stacks [W, N+1, n, B]; the stored state at knot k is the state
before the step.

The kernel (csrc/rollout_grid.cu) evaluates the merit from the diagonal
cost rows and, for affine NEGATIVE_ORTHANT groups, from rho-premultiplied
rows: w = wg - wax.x - wau.u equals z - rho c(x, u) on active knots, and
the AL term is min(w, 0)^2 / (2 rho).
"""

from __future__ import annotations

from typing import Optional

import torch

from altro_tpu_torch import al
from altro_tpu_torch.cones import Cone
from altro_tpu_torch.models.tile_steps import INTEGRATOR_MIDPOINT, MODEL_BICYCLE
from altro_tpu_torch.problem import DiagonalCost, Problem

__all__ = [
    "LAUNCHES",
    "rollout_tiled_eligible",
    "ineligibility",
    "affine_constraint_stacks",
    "premultiplied_rows",
    "rollout_grid_ref",
    "rollout_grid",
]

# Count of kernel launches (plain integer; the CPU path never adds to it).
LAUNCHES = 0

# (model, integrator) pairs the CUDA kernel has a __device__ step for.
DEVICE_STEPS = {(MODEL_BICYCLE, INTEGRATOR_MIDPOINT): "bicycle_midpoint"}


def ineligibility(problem: Problem) -> Optional[str]:
    """Why the kernel cannot run this problem, or None when it can."""
    cols = problem.dynamics_cols
    if cols is None:
        return "the problem has no column-form step (Problem.dynamics_cols)"
    ds = getattr(cols, "device_step", None)
    if ds is None:
        return "the column-form step names no device step (models/tile_steps.py)"
    if (ds.model, ds.integrator) not in DEVICE_STEPS:
        return f"no __device__ step for model {ds.model}, integrator {ds.integrator}"
    if (ds.n, ds.m) != (problem.n, problem.m):
        return f"device step is for n={ds.n}, m={ds.m}, problem has n={problem.n}, m={problem.m}"
    if not isinstance(problem.cost, DiagonalCost):
        return "the cost is not a DiagonalCost"
    for spec in problem.constraints:
        if not (spec.affine and spec.cone is Cone.NEGATIVE_ORTHANT):
            return (f"constraint group {spec.label!r} is not an affine "
                    "NEGATIVE_ORTHANT group")
    return None


def rollout_tiled_eligible(problem: Problem) -> bool:
    """True when the batched trial-grid rollout can run as the kernel."""
    return ineligibility(problem) is None


def affine_constraint_stacks(problem: Problem):
    """Per-knot affine coefficients of the constraint groups, concatenated:
    cax [N+1, P, n], cau [N+1, P, m], cg [N+1, P], act [N+1, P], with
    c_e(x, u) = cax_e.x + cau_e.u + cg_e (the ConstraintSpec.affine
    contract). Evaluated once per problem at (x, u) = (0, 0)."""
    n, m, N = problem.n, problem.m, problem.N
    dt, dev = problem.dtype, problem.device
    ks = torch.arange(N + 1, device=dev)
    xz = torch.zeros((n, N + 1), dtype=dt, device=dev)
    uz = torch.zeros((m, N + 1), dtype=dt, device=dev)
    AX, AU, G, ACT = [], [], [], []
    for spec in problem.constraints:
        J = spec.jacobian(xz, uz, ks).permute(2, 0, 1)  # [N+1, p, n+m]
        g = spec.fn(xz, uz, ks).movedim(0, 1)  # [N+1, p]
        AX.append(J[:, :, :n])
        AU.append(J[:, :, n:])
        G.append(g)
        ACT.append(spec.active[:, None].expand(g.shape).to(dt))
    if not AX:
        return (torch.zeros((N + 1, 0, n), dtype=dt, device=dev),
                torch.zeros((N + 1, 0, m), dtype=dt, device=dev),
                torch.zeros((N + 1, 0), dtype=dt, device=dev),
                torch.zeros((N + 1, 0), dtype=dt, device=dev))
    return (torch.cat(AX, 1), torch.cat(AU, 1), torch.cat(G, 1), torch.cat(ACT, 1))


def premultiplied_rows(stacks, z, rho):
    """rho-premultiplied, active-masked constraint rows for the kernel:
    wax [N+1, P, n, B], wau [N+1, P, m, B], wg [N+1, P, B], rhoi [B]."""
    cax, cau, cg, act = stacks
    if z:
        z_cat = torch.cat(z, dim=1)
    else:
        z_cat = rho.new_zeros((cg.shape[0], 0, rho.shape[0]))
    wax = rho * (cax * act[:, :, None])[..., None]
    wau = rho * (cau * act[:, :, None])[..., None]
    wg = act[..., None] * z_cat - rho * (cg * act)[..., None]
    return wax.contiguous(), wau.contiguous(), wg.contiguous(), 1.0 / (2.0 * rho)


def rollout_grid_ref(problem: Problem, ref_x, ref_u, K, d, z, rho, alphas, x0):
    """Plain W-trial rollout through the problem's own dynamics and AL cost.

    ref_x [N+1, n, B], ref_u [N, m, B], K [N, m, n, B], d [N, m, B],
    z per group [N+1, p, B], rho [B], alphas [W], x0 [n, B].
    Returns (phi [W, B], xstack [W, N+1, n, B]).
    """
    N, n = problem.N, problem.n
    W, Bsz = alphas.shape[0], x0.shape[-1]
    a = alphas[:, None, None]
    x = x0[None].expand(W, n, Bsz)
    xs = x0.new_empty((W, N + 1, n, Bsz))
    phi = x0.new_zeros((W, Bsz))
    for k in range(N):
        xs[:, k] = x
        ks = torch.full((W,), k, device=x0.device)
        u = ref_u[k] - torch.einsum("jib,wib->wjb", K[k], x - ref_x[k]) + a * d[k]
        zk = tuple(zj[k].expand(W, -1, -1) for zj in z)
        cost, _, _ = al.al_cost(problem, ks, x, u, zk, rho, terminal=False)
        phi = phi + cost
        x = problem.dyn_step(k, x.movedim(1, 0), u.movedim(1, 0)).movedim(0, 1)
    xs[:, N] = x
    ks = torch.full((W,), N, device=x0.device)
    zN = tuple(zj[N].expand(W, -1, -1) for zj in z)
    cost, _, _ = al.al_cost(problem, ks, x, None, zN, rho, terminal=True)
    return phi + cost, xs


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"rollout_grid kernel: {name} must be float32, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"rollout_grid kernel: {name} is not on a CUDA device")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rollout_grid kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rollout_grid kernel: {name} must be contiguous")


def rollout_grid(problem: Problem, ref_x, ref_u, K, d, z, rho, alphas, x0,
                 stacks=None):
    """W-trial rollout grid: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or a raise). `stacks` are the problem's
    `affine_constraint_stacks`, computed here when not given."""
    global LAUNCHES
    if not x0.is_cuda:
        return rollout_grid_ref(problem, ref_x, ref_u, K, d, z, rho, alphas, x0)
    why = ineligibility(problem)
    if why is not None:
        raise NotImplementedError(f"rollout_grid kernel: {why}")
    N, n, m = problem.N, problem.n, problem.m
    W, Bsz = alphas.shape[0], x0.shape[-1]
    cost = problem.cost
    if stacks is None:
        stacks = affine_constraint_stacks(problem)
    wax, wau, wg, rhoi = premultiplied_rows(stacks, z, rho)
    P = wg.shape[1]
    xref = ref_x[:N].contiguous()
    ops = {
        "xref": (xref, (N, n, Bsz)), "uref": (ref_u, (N, m, Bsz)),
        "K": (K, (N, m, n, Bsz)), "d": (d, (N, m, Bsz)),
        "Q": (cost.Q, (N + 1, n)), "q": (cost.q, (N + 1, n)),
        "R": (cost.R, (N + 1, m)), "r": (cost.r, (N + 1, m)),
        "c": (cost.c, (N + 1,)), "h": (problem.h, (N,)),
        "wax": (wax, (N + 1, P, n, Bsz)), "wau": (wau, (N + 1, P, m, Bsz)),
        "wg": (wg, (N + 1, P, Bsz)), "alphas": (alphas, (W,)),
        "x0": (x0, (n, Bsz)), "rhoi": (rhoi, (Bsz,)),
    }
    for name, (t, shape) in ops.items():
        _check(name, t, shape)
    ds = problem.dynamics_cols.device_step
    frame, length, rear = ds.params

    from altro_tpu_torch.ops import _build

    lib = _build.load()
    phi = torch.empty((W, Bsz), dtype=x0.dtype, device=x0.device)
    xstack = torch.empty((W, N + 1, n, Bsz), dtype=x0.dtype, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = lib.rollout_grid_f32(
        *(t.data_ptr() for t, _ in ops.values()),
        phi.data_ptr(), xstack.data_ptr(),
        N, Bsz, W, P, ds.model, ds.integrator, int(frame), float(length),
        float(rear), stream)
    _build.check(err, "rollout_grid_f32")
    LAUNCHES += 1
    return phi, xstack
