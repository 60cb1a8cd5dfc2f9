"""Differentiable solves: gradients of the optimal trajectory with respect
to the problem data, by implicit differentiation of the solver's fixed
point (PyTorch port).

Counterpart: altro_tpu/diff.py (`implicit_solve`, `_merit`, `_gn_solve`,
`_cg_solve` and the `jax.custom_vjp` pair `_implicit_fwd` /
`_implicit_bwd`). The data leaves are `problem.problem_leaves` (the
cost's arrays, h, x0, A / B / f_aff), the counterpart of the JAX
`Problem` pytree's; the custom VJP is a `torch.autograd.Function`,
`_ImplicitSolve`, that takes them as explicit inputs so autograd and
`torch.func` see them.

Math (as in JAX). At convergence u* satisfies g(u, theta) = d/du
phi(u, theta) = 0, phi the AL merit along the rollout x = R(u, theta) at
the converged duals z* and penalty rho*. For an output cotangent
(xbar, ubar):

    w         = ubar + R_u^T xbar
    lambda    = H^{-1} w
    theta_bar = R_theta^T xbar - (dg/dtheta)^T lambda,

with the linear solve by `method="tvlqr"` (the Gauss-Newton Hessian: one
TVLQR backward and forward pass at the solution, `_gn_solve`) or
`method="cg"` (conjugate gradients on the exact Hessian by
forward-over-reverse, `_cg_solve`). z*, rho* and u* are held fixed; the
warm-start state gets a zero cotangent.

Devices. The forward is the single-lane `solver.solve`; the Gauss-Newton
backward is ops/gn_backward.py (csrc/riccati_latency.cu on CUDA float32
under `pallas_latency_backward`, whatever `pallas_backward` says; the
plain recursion on the CPU or when the caller turns the option off). On
CUDA a problem that kernel cannot take is refused before anything runs
(`gn_refusal`).

Under `torch.func.vmap` (JAX's `jax.vmap` over `implicit_solve`):
`_ImplicitSolve.vmap` runs the forward as the lane-batched solve
(`parallel.batch.solve_lanes`, the per-lane semantics of
`jax.vmap(solve)`) with every batched leaf one row per lane (x0, the
cost's arrays, h, A, B, f_aff) and every batched mask one column per lane:
the constraints' `active` masks enter the Function as tensor inputs with
no derivative, as JAX's float0 leaves are batched and carry none. The
backward then runs under the vmap level on one lane's logical shapes,
with no host read: the Gauss-Newton backward's vmap rule runs the
batched csrc/riccati_dense.cu (or the batched plain recursion), and the
conjugate gradients run their `maxiter` iterations with converged lanes
frozen (the semantics of JAX's batched while loop; outside vmap they
stop on a host read).

Once differentiable, as JAX's `custom_vjp` is: forward mode over the
solve (`jacfwd`, `hessian`), a backward under a second reverse level
(`jacrev` or `grad` over `grad`) and a second `torch.autograd.grad`
through a first one taken with `create_graph=True` raise `ONCE`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from altro_tpu_torch.ops import riccati_backward as rb
from altro_tpu_torch.ops import riccati_latency as rl
from altro_tpu_torch.ops.gn_backward import gn_backward, lane_minor
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import Problem, problem_leaves, problem_with_leaves
from altro_tpu_torch.solver import (
    SolverState,
    al_expansions,
    al_total_cost,
    init_state,
    open_loop_rollout,
    solve,
)
from altro_tpu_torch.tvlqr import tvlqr_forward

__all__ = ["implicit_solve", "gn_refusal", "ONCE"]

ONCE = ("implicit_solve is once-differentiable (as JAX's custom_vjp is): no forward-mode "
        "derivative and no derivative of its gradient")


def _merit(problem: Problem, u, z, rho):
    """phi(u, theta): the AL merit as a function of the inputs alone
    (states eliminated through the rollout), at fixed duals and penalty."""
    x = open_loop_rollout(problem, u)
    return al_total_cost(problem, x, u, z, rho)


def gn_refusal(problem: Problem, opts: SolverOptions, *, vmapped: bool) -> Optional[str]:
    """Why the Gauss-Newton backward's kernel cannot take this CUDA
    problem, or None (a CPU problem, or `pallas_latency_backward` off, which
    alone selects the kernel: `pallas_backward` does not change it). One
    lane runs csrc/riccati_latency.cu, a vmapped batch
    csrc/riccati_dense.cu; each takes float32 at its instantiated (n, m)."""
    if not (problem.x0.is_cuda and opts.pallas_latency_backward):
        return None
    name, shapes = (("riccati_dense", rb.KERNEL_SHAPES) if vmapped
                    else ("riccati_latency", rl.KERNEL_SHAPES))
    bad = []
    if (problem.n, problem.m) not in shapes:
        bad.append(f"no instantiation for n={problem.n}, m={problem.m} (it has "
                   f"{', '.join(map(str, shapes))})")
    if problem.dtype != torch.float32:
        bad.append(f"{problem.dtype} (it takes float32)")
    if not bad:
        return None
    return (f"the Gauss-Newton backward's kernel ({name}): {', '.join(bad)}; "
            f"pallas_latency_backward=False selects the plain backward")


def _gn_solve(problem: Problem, u, z, rho, w, reg, kernel: bool):
    """lambda = H_GN^{-1} w by one TVLQR backward and forward pass: the
    LQR problem of the AL cost expansions along the linearized dynamics
    with lx = 0, lu = -w, f = 0 and dx0 = 0 has the solution du = H^{-1} w."""
    x = open_loop_rollout(problem, u)
    A, B, _, _, lxx, luu, lux = al_expansions(problem, x, u, z, rho)
    N, n = problem.N, problem.n
    kw = dict(dtype=u.dtype, device=u.device)
    lx = torch.zeros((N + 1, n), **kw)
    ops = (t.detach() for t in (A, B, lxx, luu, lux, lx, -w, reg))
    K, d, P, p = gn_backward(*ops, kernel)
    _, lam, _ = tvlqr_forward(A, B, torch.zeros((N, n), **kw), K, d, P, p,
                              torch.zeros((n,), **kw))
    return lam


def _levels(kinds) -> int:
    """How many `torch.func` transforms of these kinds are active."""
    from torch._C._functorch import get_interpreter_stack

    return sum(i.key() in kinds for i in get_interpreter_stack() or ())


def _under_vmap() -> bool:
    """True inside a `torch.func.vmap` level (where a host read fails)."""
    from torch._C._functorch import TransformType

    return _levels((TransformType.Vmap,)) > 0


def _second_order() -> Optional[str]:
    """Whether a second derivative differentiates this backward: "func"
    under two reverse or forward `torch.func` levels, "autograd" when plain
    autograd builds a graph of it (`create_graph=True`), else None."""
    from torch._C._functorch import TransformType, get_interpreter_stack

    if get_interpreter_stack():
        return "func" if _levels((TransformType.Grad, TransformType.Jvp)) > 1 else None
    return "autograd" if torch.is_grad_enabled() else None


def _forward_mode(problem: Problem) -> bool:
    """True when a forward-mode derivative would run through the solve: a
    `torch.func` forward level (`jacfwd`, `hessian`, `jvp`) or a leaf that
    is a dual tensor of `torch.autograd.forward_ad`."""
    import torch.autograd.forward_ad as fwad
    from torch._C._functorch import TransformType

    if _levels((TransformType.Jvp,)):
        return True
    return any(fwad.unpack_dual(t).tangent is not None for _, t in problem_leaves(problem))


class _NotTwice(torch.autograd.Function):
    """The identity on a gradient built with `create_graph=True`, tied to
    the leaves so that a second `torch.autograd.grad` reaches it: its own
    backward raises `ONCE`."""

    @staticmethod
    def forward(n, *tensors):
        return tuple(t.detach().clone() for t in tensors[:n])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(ONCE)


def _cg_solve(problem: Problem, u, z, rho, w, tol, maxiter):
    """lambda = H^{-1} w with the exact merit Hessian, matrix-free conjugate
    gradients (JAX's `jax.scipy.sparse.linalg.cg`: x0 = 0, stop when
    |r|^2 <= tol^2 |w|^2 or after maxiter iterations). Under vmap every
    iteration runs and a converged lane keeps its values."""
    grad_fn = torch.func.grad(lambda u_: _merit(problem, u_, z, rho))

    def hvp(v):
        return torch.func.jvp(grad_fn, (u,), (v,))[1]

    def dot(a, b):
        return torch.sum(a * b)

    frozen = _under_vmap()
    lam = torch.zeros_like(w)
    r = w - hvp(lam)
    p = r
    gamma = dot(r, r)
    atol2 = tol * tol * dot(w, w)
    for _ in range(maxiter):
        go = gamma > atol2
        if not frozen and not bool(go):
            break
        Ap = hvp(p)
        alpha = gamma / dot(p, Ap)
        lam_, r_ = lam + alpha * p, r - alpha * Ap
        gamma_ = dot(r_, r_)
        p_ = r_ + (gamma_ / gamma) * p
        lam, r, gamma, p = (torch.where(go, a, b) for a, b in
                            ((lam_, lam), (r_, r), (gamma_, gamma), (p_, p)))
    return lam


def _state_tensors(state: SolverState):
    return (state.x, state.u, state.y, *state.z, state.rho, state.K, state.d, state.P,
            state.p, state.reg)


def _state_from(tensors, n_groups: int) -> SolverState:
    x, u, y, *rest = tensors
    z, (rho, K, d, P, p, reg) = tuple(rest[:n_groups]), rest[n_groups:]
    return SolverState(x=x, u=u, y=y, z=z, rho=rho, K=K, d=d, P=P, p=p, reg=reg)


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What `_ImplicitSolve` takes besides tensors: the problem (its
    leaves and masks are replaced by the Function's inputs), the names of
    its leaves, the options and the linear solve's settings."""

    problem: Problem
    names: tuple
    opts: SolverOptions
    method: str
    cg_tol: float
    cg_maxiter: int

    @property
    def n_groups(self) -> int:
        return len(self.problem.constraints)

    def problem_of(self, leaves, masks) -> Problem:
        prob = problem_with_leaves(self.problem, leaves)
        return dataclasses.replace(prob, constraints=tuple(
            dataclasses.replace(spec, active=a) for spec, a in zip(prob.constraints, masks)))

    def split(self, tensors):
        """(leaves, masks, warm-start state) of the Function's tensor inputs."""
        nl, ng = len(self.names), self.n_groups
        return (tensors[:nl], tensors[nl:nl + ng],
                _state_from(tensors[nl + ng:], ng))


def _jacobians_on():
    """Forward-mode AD on inside a Function's forward (autograd turns it
    off there): the solve takes its Jacobians by forward mode
    (`problem.lane_jacobian`). The inputs are detached, so nothing is
    recorded."""
    from torch.autograd.forward_ad import _set_fwd_grad_enabled

    return _set_fwd_grad_enabled(True)


class _ImplicitSolve(torch.autograd.Function):
    """(spec, *leaves, *masks, *state) -> (x*, u*, rho*, *z*); x* and u*
    are differentiable in the leaves (the implicit function theorem), rho*
    and z* are not, nor is anything in the masks."""

    @staticmethod
    def forward(spec: _Spec, *tensors):
        leaves, masks, state = spec.split(tuple(t.detach() for t in tensors))
        with _jacobians_on():
            st, _ = solve(spec.problem_of(leaves, masks), state, spec.opts)
        return (st.x, st.u, st.rho, *st.z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, *tensors = inputs
        leaves, masks, _ = spec.split(tensors)
        _, u, rho, *z = output
        ctx.spec = spec
        ctx.n_state = len(tensors) - len(leaves) - len(masks)
        ctx.save_for_backward(*leaves, *masks, u, rho, *z)
        ctx.mark_non_differentiable(rho, *z)

    @staticmethod
    def backward(ctx, xbar, ubar, *_):
        second = _second_order()
        if second == "func":
            raise RuntimeError(ONCE)
        spec = ctx.spec
        saved = ctx.saved_tensors
        nl, ng = len(spec.names), spec.n_groups
        leaves, masks = saved[:nl], saved[nl:nl + ng]
        u, rho, *z = (t.detach() for t in saved[nl + ng:])
        z = tuple(z)
        problem = spec.problem_of(leaves, masks)

        # pull xbar back through the rollout x* = R(u*, theta): into the
        # u-cotangent (chained into the implicit term) and into theta_bar
        _, vjp_roll = torch.func.vjp(
            lambda u_, *lv: open_loop_rollout(spec.problem_of(lv, masks), u_), u, *leaves)
        w_from_x, *pbar_direct = vjp_roll(xbar)
        w = ubar + w_from_x

        if spec.method == "cg":
            lam = _cg_solve(problem, u, z, rho, w, spec.cg_tol, spec.cg_maxiter)
        else:
            reg = torch.tensor(spec.opts.reg_initial, dtype=u.dtype, device=u.device)
            lam = _gn_solve(problem, u, z, rho, w, reg, spec.opts.pallas_latency_backward)

        # theta_bar_implicit = -(dg/dtheta)^T lambda, g = d phi / du at the solution
        def g_of_theta(*lv):
            return torch.func.grad(
                lambda u_: _merit(spec.problem_of(lv, masks), u_, z, rho))(u)

        _, vjp_g = torch.func.vjp(g_of_theta, *leaves)
        pbar_implicit = vjp_g(lam)
        pbar = tuple(a - b for a, b in zip(pbar_direct, pbar_implicit))
        if second == "autograd":
            pbar = _NotTwice.apply(len(pbar), *pbar, *leaves)
        return (None, *pbar, *([None] * ng), *([None] * ctx.n_state))

    @staticmethod
    def vmap(info, in_dims, spec: _Spec, *tensors):
        """The batched forward: the lane-minor batched solve over every
        lane at once, each lane JAX's `solve` on its own data: a batched
        leaf or mask one row per lane, an unbatched one shared."""
        from altro_tpu_torch.parallel.batch import solve_lanes

        Bsz = info.batch_size
        nl, ng = len(spec.names), spec.n_groups
        dims = in_dims[1:]
        # x0 and the state one row per lane; the other leaves and the masks as batched
        tensors = tuple(t.detach() for t in tensors)
        leaves = [lane_minor(t, d, Bsz if name == "x0" else None)
                  for name, t, d in zip(spec.names, tensors[:nl], dims[:nl])]
        masks = [lane_minor(t, d) for t, d in zip(tensors[nl:nl + ng], dims[nl:nl + ng])]
        state = _state_from([lane_minor(t, d, Bsz)
                             for t, d in zip(tensors[nl + ng:], dims[nl + ng:])], ng)
        problem = spec.problem_of(leaves, masks)
        why = gn_refusal(problem, spec.opts, vmapped=True) if spec.method == "tvlqr" else None
        if why is not None:
            raise NotImplementedError(f"implicit_solve: {why}")
        with _jacobians_on():
            st, _ = solve_lanes(problem, state, spec.opts)
        out = tuple(t.movedim(-1, 0) for t in (st.x, st.u, st.rho, *st.z))
        return out, (0,) * len(out)


def implicit_solve(
    problem: Problem,
    state: Optional[SolverState] = None,
    opts: SolverOptions = SolverOptions(),
    method: str = "tvlqr",
    cg_tol: float = 1e-10,
    cg_maxiter: Optional[int] = None,
):
    """Solve and return (x*, u*), differentiable with respect to `problem`'s
    data leaves (`problem.problem_leaves`: the cost arrays, h, x0, A / B /
    f_aff) by autograd and `torch.func` (`grad`, `vjp`, `vmap` over them
    and over the constraints' masks). Once differentiable (`ONCE`).

    method: "tvlqr" (Gauss-Newton implicit differentiation, one extra
    TVLQR pass) or "cg" (exact-Hessian matrix-free conjugate gradients,
    `cg_tol`, at most `cg_maxiter` iterations, default N * m). Raises
    ValueError on another method, as JAX does; on CUDA, NotImplementedError
    for what the kernels cannot take (`gn_refusal`, `solver.solve`'s
    refusal) before anything runs.
    """
    if method not in ("tvlqr", "cg"):
        raise ValueError(f"unknown method {method!r}")
    if _forward_mode(problem):
        raise RuntimeError(ONCE)
    if method == "tvlqr" and not _under_vmap():
        why = gn_refusal(problem, opts, vmapped=False)
        if why is not None:
            raise NotImplementedError(f"implicit_solve: {why}")
    if state is None:
        state = init_state(problem)
    if cg_maxiter is None:
        cg_maxiter = problem.N * problem.m
    names, leaves = zip(*problem_leaves(problem))
    spec = _Spec(problem, names, opts, method, cg_tol, int(cg_maxiter))
    masks = tuple(c.active for c in problem.constraints)
    x, u, *_ = _ImplicitSolve.apply(spec, *leaves, *masks, *_state_tensors(state))
    return x, u
