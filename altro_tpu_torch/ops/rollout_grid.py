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
the AL term is min(w, 0)^2 / (2 rho). It forms those rows itself from the
lane-shared `affine_constraint_stacks`, the lane's duals z and its rho;
`premultiplied_rows` is their plain twin. The cost rows (Q, q, R, r, c)
and h are read once a block when every lane shares them, or one row per
lane (the kernel's LANE_COST instantiations) when any of them is per
lane, the shared ones broadcast to every lane as JAX's `_bcast_tiled`
does (`lane_rows`, once a solve). The wrapper runs no eager op besides
allocating the outputs (and broadcasting the rows when the caller did
not pass them).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from altro_tpu_torch import al
from altro_tpu_torch.cones import Cone
from altro_tpu_torch.models.tile_steps import (
    INTEGRATOR_DISCRETE,
    INTEGRATOR_MIDPOINT,
    INTEGRATOR_RK4,
    MODEL_BICYCLE,
    MODEL_DOUBLE_INTEGRATOR,
    MODEL_PENDULUM,
    MODEL_QUADROTOR,
)
from altro_tpu_torch.ops import _build
from altro_tpu_torch.problem import DiagonalCost, Problem

__all__ = [
    "LAUNCHES",
    "LANE_COST_LAUNCHES",
    "rollout_tiled_eligible",
    "ineligibility",
    "lane_rows",
    "affine_constraint_stacks",
    "premultiplied_rows",
    "plain_rollout",
    "rollout_grid_ref",
    "rollout_grid",
]

# Count of kernel launches (plain integer; the CPU path never adds to it), and
# of those that ran a LANE_COST instantiation (per-lane cost rows and h).
LAUNCHES = 0
LANE_COST_LAUNCHES = 0

# (model, integrator) pairs the CUDA kernel has a __device__ step for, and
# the constraint row counts P each step is instantiated with.
DEVICE_STEPS = {(MODEL_BICYCLE, INTEGRATOR_MIDPOINT): ("bicycle_midpoint", (0, 2)),
                (MODEL_QUADROTOR, INTEGRATOR_RK4): ("quadrotor_rk4", (0,)),
                (MODEL_PENDULUM, INTEGRATOR_MIDPOINT): ("pendulum_midpoint", (0, 2)),
                (MODEL_DOUBLE_INTEGRATOR, INTEGRATOR_DISCRETE): ("double_integrator", (0, 2))}


def device_params(ds) -> ctypes.Array:
    """A DeviceStep's parameters as the C entry points take them: eight
    floats in host memory (the bicycle's frame code as a float)."""
    return (ctypes.c_float * 8)(*(float(v) for v in ds.params))


def ineligibility(problem: Problem) -> Optional[str]:
    """Why the kernel cannot run this problem, or None when it can: as
    JAX's `rollout_tiled_eligible` (altro_tpu/ops/pallas_rollout_tiled.py:
    78-92), a column-form step with a __device__ twin, a DiagonalCost and
    affine NEGATIVE_ORTHANT groups with masks shared by all lanes; linear
    dynamics arrays have no column-form step in either package."""
    if problem.linear_dynamics:
        return "linear dynamics arrays (Problem.A, B, f_aff) have no column-form step"
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
        if spec.per_lane:
            return (f"constraint group {spec.label!r} has a per-lane active mask (the "
                    "kernel's affine rows are shared by all lanes, as JAX's kernel takes "
                    "an unbatched constraint spec)")
    rows = sum(spec.dim for spec in problem.constraints)
    name, step_rows = DEVICE_STEPS[(ds.model, ds.integrator)]
    if rows not in step_rows or len(problem.constraints) > 2:
        return (f"{rows} constraint rows in {len(problem.constraints)} groups (the {name} "
                f"step is instantiated for {step_rows} rows in at most two groups)")
    return None


def per_lane(problem: Problem) -> bool:
    """True when a cost leaf or h holds one row per lane."""
    return problem.cost.per_lane or problem.h.ndim == 2


def lane_rows(problem: Problem, Bsz: int):
    """The kernel's cost rows and h one row per lane, contiguous: Q, q
    [N+1, n, B], R, r [N+1, m, B], c [N+1, B], h [N, B], a shared leaf
    broadcast to every lane (JAX's `_bcast_tiled`,
    altro_tpu/ops/pallas_rollout_tiled.py:237-242); None when every leaf
    is shared (the kernel then reads one row a block)."""
    if not per_lane(problem):
        return None
    cost = problem.cost

    def lanes(t, base):
        return (t if t.ndim == base + 1 else t[..., None].expand(*t.shape, Bsz)).contiguous()

    return {"Q": lanes(cost.Q, 2), "q": lanes(cost.q, 2), "R": lanes(cost.R, 2),
            "r": lanes(cost.r, 2), "c": lanes(cost.c, 1), "h": lanes(problem.h, 1)}


def rollout_tiled_eligible(problem: Problem) -> bool:
    """True when the batched trial-grid rollout can run as the kernel."""
    return ineligibility(problem) is None


def affine_constraint_stacks(problem: Problem):
    """Per-knot affine coefficients of the constraint groups, concatenated:
    cax [N+1, P, n], cau [N+1, P, m], cg [N+1, P], act [N+1, P], with
    c_e(x, u) = cax_e.x + cau_e.u + cg_e (the ConstraintSpec.affine
    contract). Evaluated once per problem at (x, u) = (0, 0). The masks
    are shared by all lanes (`ineligibility` refuses a per-lane one)."""
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
        if spec.per_lane:
            raise ValueError(f"affine_constraint_stacks: group {spec.label!r} has a per-lane "
                             "active mask")
        ACT.append(spec.active[:, None].expand(g.shape).to(dt))
    if not AX:
        return (torch.zeros((N + 1, 0, n), dtype=dt, device=dev),
                torch.zeros((N + 1, 0, m), dtype=dt, device=dev),
                torch.zeros((N + 1, 0), dtype=dt, device=dev),
                torch.zeros((N + 1, 0), dtype=dt, device=dev))
    return (torch.cat(AX, 1), torch.cat(AU, 1), torch.cat(G, 1), torch.cat(ACT, 1))


def premultiplied_rows(stacks, z, rho):
    """The rows the kernel forms per lane and knot, as a plain twin:
    wax = rho (cax act) [N+1, P, n, B], wau = rho (cau act) [N+1, P, m, B],
    wg = act z - rho (cg act) [N+1, P, B] and rhoi = 1 / (2 rho) [B], each
    product rounded as the kernel rounds it. `stacks` are
    `affine_constraint_stacks`, z the per-group duals [N+1, p, B]."""
    cax, cau, cg, act = stacks
    if z:
        z_cat = torch.cat(z, dim=1)
    else:
        z_cat = rho.new_zeros((cg.shape[0], 0, rho.shape[0]))
    wax = rho * (cax * act[:, :, None])[..., None]
    wau = rho * (cau * act[:, :, None])[..., None]
    wg = act[..., None] * z_cat - rho * (cg * act)[..., None]
    return wax, wau, wg, 1.0 / (2.0 * rho)


def plain_rollout(step, ref_x, ref_u, K, d, alphas, x0):
    """The W-trial rollout of both rollout grids' plain versions (this one
    and the single-lane ops/trial_rollout.py's): a Python loop over knots
    with the trials on the leading axis, x [W, n, B], the policy
    u = u_ref - K (x - x_ref) + alpha d and step(k, x, u) -> [W, n, B].
    ref_x [N(+1), n, B], ref_u [N, m, B], K [N, m, n, B], d [N, m, B],
    x0 [n, B]; alphas [W], shared by the lanes, or [W, B], each lane its
    own. Returns (xstack [W, N+1, n, B], ustack [W, N, m, B]); the merit
    follows from them knot by knot."""
    N = K.shape[0]
    W, (n, Bsz) = alphas.shape[0], x0.shape
    a = (alphas[:, None, None] if alphas.ndim == 1 else alphas[:, None, :]).to(x0.dtype)
    x = x0[None].expand(W, n, Bsz)
    xs = x0.new_empty((W, N + 1, n, Bsz))
    us = x0.new_empty((W, N, ref_u.shape[1], Bsz))
    for k in range(N):
        xs[:, k] = x
        u = ref_u[k] - torch.einsum("jib,wib->wjb", K[k], x - ref_x[k]) + a * d[k]
        us[:, k] = u
        x = step(k, x, u)
    xs[:, N] = x
    return xs, us


def rollout_grid_ref(problem: Problem, ref_x, ref_u, K, d, z, rho, alphas, x0, states=None):
    """Plain W-trial rollout through the problem's own dynamics and AL cost.

    ref_x [N+1, n, B], ref_u [N, m, B], K [N, m, n, B], d [N, m, B],
    z per group [N+1, p, B], rho [B], alphas [W] or [W, B] (per lane), x0 [n, B].
    Returns (phi [W, B], xstack [W, N+1, n, B]). states(ref_x, ref_u, K,
    d, alphas, x0) -> (xstack, ustack): the rollout of the states, by
    default `plain_rollout` (the exported graph passes its scan,
    graph_solve.scan_rollout).

    The JAX scan adds each knot's AL cost inside the sequential step; the
    cost needs only that knot's (x, u), so here the states roll out with
    the policy and the dynamics alone, the AL costs of every knot and
    trial follow in one knot-parallel call, and phi sums them knot by knot
    in the scan's order (as solver.merit_rollout_phi_x does for one lane).
    """
    N = problem.N
    W, (n, Bsz) = alphas.shape[0], x0.shape
    if states is None:
        xs, us = plain_rollout(
            lambda k, x, u: problem.dyn_step(k, x.movedim(1, 0), u.movedim(1, 0)).movedim(0, 1),
            ref_x, ref_u, K, d, alphas, x0)
    else:
        xs, us = states(ref_x, ref_u, K, d, alphas, x0)
    x = xs[:, N]
    ks = torch.arange(N, device=x0.device).repeat(W)  # trial-major: row w * N + k
    zs = tuple(zj[:N].repeat(W, 1, 1) for zj in z)
    cost = al.al_cost(problem, ks, xs[:, :N].reshape(W * N, n, Bsz),
                      us.reshape(W * N, -1, Bsz), zs, rho, terminal=False)[0].reshape(W, N, Bsz)
    kN = torch.full((W,), N, device=x0.device)
    cost_N = al.al_cost(problem, kN, x, None, tuple(zj[N].expand(W, -1, -1) for zj in z), rho,
                        terminal=True)[0]
    phi = x0.new_zeros((W, Bsz))
    for k in range(N):
        phi = phi + cost[:, k]
    return phi + cost_N, xs


def rollout_grid(problem: Problem, ref_x, ref_u, K, d, z, rho, alphas, x0,
                 stacks=None, rows=None):
    """W-trial rollout grid: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or a raise). `stacks` are the problem's
    `affine_constraint_stacks` and `rows` its `lane_rows` (each computed
    here when not given: pass them once per solve)."""
    global LAUNCHES, LANE_COST_LAUNCHES
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
    if rows is None:
        rows = lane_rows(problem, Bsz)
    lane_cost = rows is not None
    if not lane_cost:
        rows = {"Q": cost.Q, "q": cost.q, "R": cost.R, "r": cost.r, "c": cost.c, "h": problem.h}
    lb = (Bsz,) if lane_cost else ()
    cax, cau, cg, act = stacks
    P = cg.shape[1]
    z0 = z[0] if z else None
    z1 = z[1] if len(z) > 1 else None
    p0 = 0 if z0 is None else z0.shape[1]
    ops = {
        "xref": (ref_x, (N + 1, n, Bsz)), "uref": (ref_u, (N, m, Bsz)),
        "K": (K, (N, m, n, Bsz)), "d": (d, (N, m, Bsz)),
        "Q": (rows["Q"], (N + 1, n) + lb), "q": (rows["q"], (N + 1, n) + lb),
        "R": (rows["R"], (N + 1, m) + lb), "r": (rows["r"], (N + 1, m) + lb),
        "c": (rows["c"], (N + 1,) + lb), "h": (rows["h"], (N,) + lb),
        "cax": (cax, (N + 1, P, n)), "cau": (cau, (N + 1, P, m)),
        "cg": (cg, (N + 1, P)), "act": (act, (N + 1, P)),
        "z0": (z0, (N + 1, p0, Bsz)), "z1": (z1, (N + 1, P - p0, Bsz)),
        "rho": (rho, (Bsz,)), "alphas": (alphas, (W,)), "x0": (x0, (n, Bsz)),
    }
    for name, (t, shape) in ops.items():
        if t is not None:
            _build.check_operand("rollout_grid", name, t, shape)
    ds = problem.dynamics_cols.device_step

    lib = _build.load()
    phi = torch.empty((W, Bsz), dtype=x0.dtype, device=x0.device)
    xstack = torch.empty((W, N + 1, n, Bsz), dtype=x0.dtype, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = lib.rollout_grid_f32(
        *(None if t is None else t.data_ptr() for t, _ in ops.values()),
        phi.data_ptr(), xstack.data_ptr(),
        N, Bsz, W, P, p0, int(lane_cost), ds.model, ds.integrator, device_params(ds), stream)
    _build.check(err, "rollout_grid_f32")
    LAUNCHES += 1
    LANE_COST_LAUNCHES += int(lane_cost)
    return phi, xstack
