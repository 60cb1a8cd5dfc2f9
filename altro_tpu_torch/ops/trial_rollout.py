"""Single-lane W-trial line-search rollout: the CUDA kernel and its plain twin.

Counterparts: altro_tpu/ops/pallas_rollout.py (`_pallas_rollout` and its
Pallas `_kernel` / `_al_term`, the portable `_scan_rollout` that the
plain version computes, `make_trial_grid_rollout`,
`rollout_constraints_eligible` as `problem_ineligibility`;
`affine_constraint_stacks` is ops/rollout_grid.py's).

For each trial step alpha_w, from x_0 = x0 [n]:

    u_k = u_ref_k - K_k (x_k - x_ref_k) + alpha_w d_k
    phi += 0.5 Q_k.x.x + q_k.x + 0.5 R_k.u.u + r_k.u + c_k
           (+ rhoi * sum_e min(w_e, 0)^2,  w = wg_k - wa_k.x - wu_k.u)
    x_{k+1} = step(x_k, u_k, h_k)

and phi adds the terminal cost and AL term at x_N (no u). Returns
phis [W] and xstack [W, N+1, n]; the stored state at knot k is the state
before the step. `con` is the optional affine bundle (wa [N+1, P, n],
wu [N+1, P, m], wg [N+1, P], rhoi scalar), active-masked and
rho-premultiplied as the solver builds it. The kernel
(csrc/trial_rollout.cu) runs one block: for the bicycle, two lanes per
trial walk the state chain, splitting the model's steering-angle terms
between them, and a lane of another warp per trial accumulates the merit
behind them; for the quadrotor's RK4 step, three lanes per trial (one a
body axis) walk the chain on the same pipeline; for the pendulum's
midpoint step and the double integrator's exact step, one lane per trial.
"""

from __future__ import annotations

from typing import Optional

import torch

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
from altro_tpu_torch.ops.rollout_grid import device_params, plain_rollout
from altro_tpu_torch.problem import DiagonalCost

__all__ = [
    "LAUNCHES",
    "KERNEL_MAX_W",
    "KERNEL_P",
    "problem_ineligibility",
    "ineligibility",
    "trial_rollout_ref",
    "output_views",
    "trial_rollout",
]

# Count of kernel launches (plain integer; the CPU path never adds to it).
LAUNCHES = 0

# The kernel's merit warp holds one trial per lane.
KERNEL_MAX_W = 32

# Constraint-row counts some step is instantiated for (none, the steering
# bound's two rows, or two groups of two).
KERNEL_P = (0, 2, 4)

# (model, integrator) pairs the CUDA kernel has a __device__ step for, and
# the constraint row counts each step is instantiated with (the bicycle in
# the two-lanes-a-trial kernel, the quadrotor in the three-lanes-a-trial
# kernel, the pendulum in the one-lane-a-trial kernel, the double
# integrator's exact step in the generic one-lane-a-trial kernel).
DEVICE_STEPS = {(MODEL_BICYCLE, INTEGRATOR_MIDPOINT): ("bicycle_midpoint", (0, 2, 4)),
                (MODEL_QUADROTOR, INTEGRATOR_RK4): ("quadrotor_rk4", (0,)),
                (MODEL_PENDULUM, INTEGRATOR_MIDPOINT): ("pendulum_midpoint", (0, 2)),
                (MODEL_DOUBLE_INTEGRATOR, INTEGRATOR_DISCRETE): ("double_integrator",
                                                                 (0, 2, 4))}


def problem_ineligibility(problem, rows: bool = True) -> Optional[str]:
    """Why the single-lane solve cannot run this problem's grid through the
    trial rollout, or None when it can: it needs a block step, a diagonal
    cost, only affine NEGATIVE_ORTHANT groups (unconstrained problems
    qualify) and, with `rows`, a row count the kernel is instantiated for
    (KERNEL_P). The JAX `rollout_constraints_eligible` with the solver's
    own checks (altro_tpu/solver.py:924-930), as a reason; rows=False
    asks only what JAX asks (the plain version takes any row count)."""
    if problem.dynamics_tile is None:
        return "the problem has no block step (Problem.dynamics_tile)"
    if not isinstance(problem.cost, DiagonalCost):
        return "the cost is not a DiagonalCost"
    for spec in problem.constraints:
        if not (spec.affine and spec.cone is Cone.NEGATIVE_ORTHANT):
            return (f"constraint group {spec.label!r} is not an affine "
                    "NEGATIVE_ORTHANT group")
    count = sum(spec.dim for spec in problem.constraints)
    if rows and count not in KERNEL_P:
        return f"{count} constraint rows (the kernel takes {KERNEL_P})"
    return None


def ineligibility(step_tile, n: int, m: int, W: int = 1, P: int = 0) -> Optional[str]:
    """Why the kernel cannot run this block step with W trials and P
    constraint rows, or None when it can (an instantiation exists: every
    bicycle frame and the double integrator's step at P=0, 2 and 4, the
    pendulum's midpoint step at P=0 and 2, the quadrotor's RK4 step at
    P=0)."""
    ds = getattr(step_tile, "device_step", None)
    if ds is None:
        return "the block step names no device step (models/tile_steps.py)"
    if (ds.model, ds.integrator) not in DEVICE_STEPS:
        return f"no __device__ step for model {ds.model}, integrator {ds.integrator}"
    if (ds.n, ds.m) != (n, m):
        return f"device step is for n={ds.n}, m={ds.m}, operands have n={n}, m={m}"
    if W > KERNEL_MAX_W:
        return f"W={W} > {KERNEL_MAX_W} trials"
    name, rows = DEVICE_STEPS[(ds.model, ds.integrator)]
    if P not in rows:
        return f"P={P} constraint rows (the {name} step is instantiated for {rows})"
    return None


def trial_rollout_ref(step_tile, alphas, x0, xref, uref, K, d, Qd, ql, Rd, rl,
                      cconst, h, con=None):
    """Plain PyTorch version: ops/rollout_grid.py's `plain_rollout` with
    one lane and the block step on the [W, n] trial rows, then the merit
    added knot by knot: the diagonal cost rows plus the rows' AL term."""
    N, W = K.shape[0], alphas.shape[0]

    def merit(k, x, u):  # x [W, n], u [W, m] (None at x_N) -> [W]
        phi = 0.5 * torch.sum(Qd[k] * x * x, dim=1) + torch.sum(ql[k] * x, dim=1) + cconst[k]
        if u is not None:
            phi = phi + 0.5 * torch.sum(Rd[k] * u * u, dim=1) + torch.sum(rl[k] * u, dim=1)
        if con is not None:
            wa, wu, wg, rhoi = con
            w = wg[k] - x @ wa[k].T  # [W, P]
            if u is not None:
                w = w - u @ wu[k].T
            pw = torch.clamp(w, max=0.0)
            phi = phi + rhoi * torch.sum(pw * pw, dim=1)
        return phi

    def step(k, x, u):
        return step_tile(x[..., 0], u[..., 0], h[k].expand(W, 1))[..., None]

    xs, us = plain_rollout(step, xref[..., None], uref[..., None], K[..., None],
                           d[..., None], alphas, x0[:, None])
    xs, us = xs[..., 0], us[..., 0]
    phi = xs.new_zeros(W)
    for k in range(N):
        phi = phi + merit(k, xs[:, k], us[:, k])
    return phi + merit(N, xs[:, N], None), xs


def output_views(W: int, N: int, n: int, device):
    """The kernel's outputs as views of ONE float32 buffer: xstack
    [W, N+1, n] first (16-byte aligned at its start), then phis [W]."""
    size = W * (N + 1) * n
    buf = torch.empty(size + W, dtype=torch.float32, device=device)
    return buf.as_strided((W,), (1,), size), buf.as_strided((W, N + 1, n), ((N + 1) * n, n, 1), 0)


def trial_rollout(step_tile, alphas, x0, xref, uref, K, d, Qd, ql, Rd, rl, cconst, h,
                  con=None):
    """W-trial rollout of one lane: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, or a raise when the kernel does not take
    them (`ineligibility`: no __device__ twin of the step, W >
    KERNEL_MAX_W, P not in KERNEL_P; not float32, wrong shape, not
    contiguous). The kernel reads con's rhoi from the device: a
    one-element float32 CUDA tensor, as the solve passes it, or a Python
    number, copied there first."""
    global LAUNCHES
    if not x0.is_cuda:
        return trial_rollout_ref(step_tile, alphas, x0, xref, uref, K, d, Qd, ql, Rd, rl,
                                 cconst, h, con=con)
    N, m, n = K.shape
    W = alphas.shape[0]
    P = 0 if con is None else con[2].shape[1]
    why = ineligibility(step_tile, n, m, W, P)
    if why is not None:
        raise NotImplementedError(f"trial_rollout kernel: {why}")
    ops = [("alphas", alphas, (W,)), ("x0", x0, (n,)), ("xref", xref, (N + 1, n)),
           ("uref", uref, (N, m)), ("K", K, (N, m, n)), ("d", d, (N, m)),
           ("Q", Qd, (N + 1, n)), ("q", ql, (N + 1, n)), ("R", Rd, (N + 1, m)),
           ("r", rl, (N + 1, m)), ("c", cconst, (N + 1,)), ("h", h, (N,))]
    rows = (None,) * 4
    if con is not None:
        wa, wu, wg, rhoi = con
        if not torch.is_tensor(rhoi):
            rhoi = torch.tensor(float(rhoi), dtype=x0.dtype, device=x0.device)
        ops += [("wa", wa, (N + 1, P, n)), ("wu", wu, (N + 1, P, m)), ("wg", wg, (N + 1, P)),
                ("rhoi", rhoi.reshape(-1), (1,))]
        rows = tuple(t.data_ptr() for _, t, _ in ops[12:])
    _build.check_operands("trial_rollout", ops)
    ds = step_tile.device_step

    lib = _build.load()
    phi, xstack = output_views(W, N, n, x0.device)
    err = lib.trial_rollout_f32(
        *(t.data_ptr() for _, t, _ in ops[:12]), *rows,
        phi.data_ptr(), xstack.data_ptr(), N, W, P, ds.model, ds.integrator, device_params(ds),
        torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(err, "trial_rollout_f32")
    LAUNCHES += 1
    return phi, xstack


_FRAMES = {0: "cog", 1: "rear", 2: "front"}  # BICYCLE_FRAMES' codes


def block_step(model: int, integrator: int, params):
    """The block step of a device step, rebuilt from its codes and
    parameters (`models.tile_steps.DeviceStep`): the port's registry of
    the steps the kernel has a `__device__` twin of (DEVICE_STEPS), each
    the same function of (x, u, h) as the step that named it. What the
    `altro_tpu_torch::trial_rollout` operator runs, since an operator
    takes no callable."""
    from altro_tpu_torch.models import tile_steps as ts

    key = (model, integrator)
    if key == (MODEL_BICYCLE, INTEGRATOR_MIDPOINT):
        frame, length, rear = params[:3]
        return ts.midpoint_tile(ts.bicycle_tile(_FRAMES[int(frame)], length, rear))
    if key == (MODEL_QUADROTOR, INTEGRATOR_RK4):
        mass, gravity, arm, kf, km, jx, jy, jz = params[:8]
        return ts.rk4_tile(ts.quadrotor_tile(mass, gravity, arm, kf, km, (jx, jy, jz)))
    if key == (MODEL_PENDULUM, INTEGRATOR_MIDPOINT):
        return ts.midpoint_tile(ts.pendulum_tile(*params[:4]))
    if key == (MODEL_DOUBLE_INTEGRATOR, INTEGRATOR_DISCRETE):
        return ts.double_integrator_tile(2)
    raise NotImplementedError(f"trial_rollout: no block step for model {model}, "
                              f"integrator {integrator} (it has {sorted(DEVICE_STEPS)})")
