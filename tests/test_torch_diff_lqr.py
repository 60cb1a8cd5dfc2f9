"""`diff.implicit_solve` on the port against altro_tpu/diff.py: tests/
test_diff.py's linear-quadratic case (:58), both linear solves, in f64 on
the CPU. The port's gradients in q[0] and x0 equal JAX's `implicit_solve`
gradients to rtol 1e-8 and central finite differences of the port's own
solves to test_diff.py's rtol 1e-6 / atol 1e-8. The problems are
`reference_problems`' twins of test_diff.py's, held to them leaf for
leaf; the helpers here serve the other test_torch_diff_*.py files.
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
from altro_tpu_torch.diff import implicit_solve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch._finite_diff import fd_grad  # noqa: E402
from altro_tpu_torch.problem import problem_leaves, problem_with_leaves  # noqa: E402
from altro_tpu_torch.reference_problems import diff_di_problem  # noqa: E402
from test_diff import _di_problem, _loss_of_solution  # noqa: E402

F64 = torch.float64


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def loss_of_solution(x, u):
    """test_diff.py's loss on the port's (x*, u*)."""
    return torch.sum(x ** 2) + 0.5 * torch.sum(u ** 2)


def jax_di(q_row0, x0):
    """test_diff.py's problem in the JAX package with q[0] and x0 replaced
    (test_diff.py:62-71)."""
    pb = _di_problem()
    c = pb.cost
    return JProblem(N=pb.N, n=pb.n, m=pb.m, dynamics=pb.dynamics, dynamics_jac=None,
                    constraints=(), cost=JDiagonalCost(c.Q, c.R, c.q.at[0].set(q_row0), c.r, c.c),
                    h=pb.h, x0=x0)


def assert_same_leaves(port_problem, jax_problem):
    """The port's builder gives the JAX builder's data leaves."""
    jleaves = [a for a in jax.tree_util.tree_leaves(jax_problem)
               if jnp.issubdtype(a.dtype, jnp.floating)]
    leaves = [t for _, t in problem_leaves(port_problem)]
    assert len(jleaves) == len(leaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=0)


@pytest.mark.parametrize("method", ["tvlqr", "cg"])
def test_lqr_grad_matches_jax_and_fd(method):
    """Linear dynamics and a quadratic cost: both linear solves are exact,
    so the port equals JAX's gradient and the finite differences."""
    opts = SolverOptions()
    pb0 = _di_problem()
    q0, x00 = t64(pb0.cost.q[0]), t64(pb0.x0)

    def loss_from(q, x0):
        return loss_of_solution(*implicit_solve(diff_di_problem(q, x0), opts=opts,
                                                method=method))

    g_q, g_x0 = torch.func.grad(loss_from, argnums=(0, 1))(q0, x00)

    def jloss(q, x0):
        return _loss_of_solution(*jimplicit_solve(jax_di(q, x0), opts=JOpts(), method=method))

    jg_q, jg_x0 = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pb0.cost.q[0], pb0.x0)
    np.testing.assert_allclose(g_q.numpy(), np.asarray(jg_q), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(g_x0.numpy(), np.asarray(jg_x0), rtol=1e-8, atol=1e-12)

    # plain autograd gives the same gradient as torch.func
    q_req, x0_req = q0.clone().requires_grad_(True), x00.clone().requires_grad_(True)
    loss_from(q_req, x0_req).backward()
    np.testing.assert_allclose(q_req.grad.numpy(), g_q.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x0_req.grad.numpy(), g_x0.numpy(), rtol=1e-12, atol=1e-12)

    fd_q = fd_grad(lambda q: diff_di_problem(q, x00), q0, loss_of_solution, opts)
    fd_x0 = fd_grad(lambda x0: diff_di_problem(q0, x0), x00, loss_of_solution, opts)
    np.testing.assert_allclose(g_q.numpy(), fd_q.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(g_x0.numpy(), fd_x0.numpy(), rtol=1e-6, atol=1e-8)


def test_unknown_method_raises_as_jax():
    pb0 = _di_problem()
    prob = diff_di_problem(t64(pb0.cost.q[0]), t64(pb0.x0))
    with pytest.raises(ValueError, match="unknown method 'newton'"):
        implicit_solve(prob, method="newton")
    with pytest.raises(ValueError, match="unknown method 'newton'"):
        jimplicit_solve(_di_problem(), method="newton")


def test_problem_leaves_follow_jax_tree_order():
    """The port's data leaves are the float leaves of JAX's tree_flatten of
    the same problem, in its order; rebuilding from them round-trips."""
    pb0 = _di_problem()
    prob = diff_di_problem(t64(pb0.cost.q[0]), t64(pb0.x0))
    names, leaves = zip(*problem_leaves(prob))
    assert names == ("cost.Q", "cost.R", "cost.q", "cost.r", "cost.c", "h", "x0")
    assert_same_leaves(prob, pb0)
    again = problem_with_leaves(prob, [2.0 * lv for lv in leaves])
    for (_, a), b in zip(problem_leaves(again), leaves):
        torch.testing.assert_close(a, 2.0 * b)
