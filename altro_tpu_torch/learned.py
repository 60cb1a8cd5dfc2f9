"""Learning cost weights through the solver (differentiable MPC; PyTorch port).

Counterpart: examples/learned_mpc.py (`build_problem`, `task_loss` and
its 40-step loop). A controller's diagonal cost weights (qx, qv, r), held
as log-weights theta, are tuned by gradient descent on a task loss that
is not the controller's own objective: it charges much more for terminal
error, so the learned weights tighten the controller. The gradient flows
through the solve by `diff.implicit_solve`; the optimizer is
`torch.optim.Adam(lr=0.1)` in place of `optax.adam(0.1)` (the same
update, m_hat / (sqrt(v_hat) + eps), eps 1e-8).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import torch

from altro_tpu_torch.diff import implicit_solve
from altro_tpu_torch.models.double_integrator import double_integrator_dynamics
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.problem import DiagonalCost, Problem

__all__ = ["build_problem", "task_loss", "run_learned_mpc", "LearnedMPCResult"]

X0 = (2.0, -1.5, 0.0, 0.0)  # the example's initial state


def build_problem(log_weights: torch.Tensor, N: int = 20, h: float = 0.1) -> Problem:
    """The controller: the planar double integrator (n=4, m=2) with the
    diagonal cost Q = (qx, qx, qv, qv), R = (r, r) at every knot from the
    learnable log-weights [log qx, log qv, log r]; on log_weights' device
    and dtype."""
    n, m = 4, 2
    kw = dict(dtype=log_weights.dtype, device=log_weights.device)
    qx, qv, r = torch.exp(log_weights).unbind()
    Q = torch.stack([qx, qx, qv, qv]).repeat(N + 1, 1)
    R = torch.stack([r, r]).repeat(N + 1, 1)
    return Problem(
        N=N, n=n, m=m, dynamics=double_integrator_dynamics(), dynamics_jac=None,
        constraints=(),
        cost=DiagonalCost(Q=Q, R=R, q=torch.zeros((N + 1, n), **kw),
                          r=torch.zeros((N + 1, m), **kw), c=torch.zeros((N + 1,), **kw)),
        h=torch.full((N,), h, **kw), x0=torch.tensor(X0, **kw))


def task_loss(log_weights: torch.Tensor, opts: SolverOptions = SolverOptions()) -> torch.Tensor:
    """What the example cares about: terminal accuracy and mild effort of
    the controller's solution, 100 |x_N|^2 + 0.05 |u|^2."""
    x, u = implicit_solve(build_problem(log_weights), opts=opts)
    return 100.0 * torch.sum(x[-1] ** 2) + 0.05 * torch.sum(u ** 2)


class LearnedMPCResult(NamedTuple):
    losses: torch.Tensor  # [steps + 1]: the task loss at each step, then after the last update
    weights: torch.Tensor  # [steps + 1, 3]: (qx, qv, r) at each step, then the final ones
    seconds: List[float]  # host seconds of each step (loss, gradient, update), synchronised


def run_learned_mpc(steps: int = 40, dtype=torch.float32, device="cuda",
                    opts: SolverOptions = SolverOptions()) -> LearnedMPCResult:
    """The example's loop: from theta = log(1, 1, 1), `steps` times the
    task loss and its gradient through the solver, then one Adam step;
    then the loss at the final weights. On CUDA float32 the solve and the
    Gauss-Newton backward run their kernels (`solver.solve`,
    ops/gn_backward.py); `opts.replace(pallas_latency_backward=False)`
    selects the plain backward on any device, and CUDA float64 needs it
    (the kernels take float32 and refuse it)."""
    theta = torch.zeros(3, dtype=dtype, device=device, requires_grad=True)
    adam = torch.optim.Adam([theta], lr=0.1)
    cuda = theta.is_cuda
    losses, weights, seconds = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        adam.zero_grad()
        loss = task_loss(theta, opts)
        loss.backward()
        losses.append(loss.detach())
        weights.append(torch.exp(theta.detach()))
        adam.step()
        if cuda:
            torch.cuda.synchronize(theta.device)
        seconds.append(time.perf_counter() - t0)
    with torch.no_grad():
        losses.append(task_loss(theta.detach(), opts))
    weights.append(torch.exp(theta.detach()))
    return LearnedMPCResult(torch.stack(losses), torch.stack(weights), seconds)
