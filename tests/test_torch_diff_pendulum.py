"""`diff.implicit_solve` on the port against altro_tpu/diff.py: tests/
test_diff.py's near-upright pendulum (:110), nonlinear dynamics, in f64
on the CPU, method "cg" (the exact Hessian by forward-over-reverse).
The port's gradient in the stage weights Qd equals JAX's to rtol 1e-8
and central finite differences of the port's own solves (lanes of one
batched solve) to test_diff.py's rtol 1e-3. The Gauss-Newton method is
tests/test_torch_diff_pendulum_tvlqr.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.diff import implicit_solve as jimplicit_solve  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import DiagonalCost as JDiagonalCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu_torch._finite_diff import fd_grad  # noqa: E402
from altro_tpu_torch.diff import implicit_solve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.reference_problems import DIFF_TIGHT, diff_pendulum_problem  # noqa: E402
from test_diff import _loss_of_solution, _pendulum_problem  # noqa: E402
from test_torch_diff_lqr import assert_same_leaves, loss_of_solution, t64  # noqa: E402

QD0 = (1.0, 0.1)
XG = (np.pi, 0.0)


def jax_pendulum(Qd):
    """test_diff.py:118-128."""
    base = _pendulum_problem(list(QD0))
    Q = base.cost.Q.at[: base.N].set(jnp.broadcast_to(Qd, (base.N, 2)))
    q = -Q * jnp.asarray(XG)
    c = 0.5 * jnp.sum(Q * jnp.asarray(XG) ** 2, axis=1)
    return JProblem(N=base.N, n=base.n, m=base.m, dynamics=base.dynamics, dynamics_jac=None,
                    constraints=(), cost=JDiagonalCost(Q, base.cost.R, q, base.cost.r, c),
                    h=base.h, x0=base.x0)


def check_pendulum(method, fd_rtol):
    opts = SolverOptions(**DIFF_TIGHT)
    Qd0 = t64(QD0)
    assert_same_leaves(diff_pendulum_problem(Qd0), jax_pendulum(jnp.asarray(QD0)))
    g = torch.func.grad(lambda Qd: loss_of_solution(
        *implicit_solve(diff_pendulum_problem(Qd), opts=opts, method=method)))(Qd0)
    jg = jax.jit(jax.grad(lambda Qd: _loss_of_solution(
        *jimplicit_solve(jax_pendulum(Qd), opts=JOpts(**DIFF_TIGHT), method=method))))(
            jnp.asarray(QD0))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8)
    fd = fd_grad(diff_pendulum_problem, Qd0, loss_of_solution, opts)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=fd_rtol)


def test_pendulum_grad_cg_exact():
    """CG on the exact Hessian matches finite differences (test_diff.py:147)."""
    check_pendulum("cg", 1e-3)
