"""`diff.implicit_solve` composes with `torch.func.vmap` and
`torch.func.grad` (tests/test_diff.py:205, `jax.jit(jax.vmap(jax.grad))`),
in f64 on the CPU: the vmapped gradient over two x0 lanes equals the
single-lane gradient to rtol 1e-10 and JAX's vmapped gradients to 1e-8,
under both linear solves (the Gauss-Newton backward's vmap rule, the
conjugate gradients with frozen lanes). Vmapping over the linear
dynamics' A takes one row per lane, as `jax.vmap` does."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.diff import implicit_solve as jimplicit_solve  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu_torch.diff import implicit_solve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from test_diff import _di_problem, _loss_of_solution  # noqa: E402
from altro_tpu_torch.reference_problems import diff_di_problem  # noqa: E402
from test_torch_diff_lqr import jax_di, loss_of_solution, t64  # noqa: E402


@pytest.mark.parametrize("method", ["tvlqr", "cg"])
def test_vmap_grad_matches_single_lane_and_jax(method):
    pb0 = _di_problem()
    q0 = t64(pb0.cost.q[0])

    def loss(x0):
        return loss_of_solution(*implicit_solve(diff_di_problem(q0, x0), opts=SolverOptions(),
                                                method=method))

    x0s = torch.stack([t64(pb0.x0), t64(pb0.x0) + 0.1])
    grads = torch.func.vmap(torch.func.grad(loss))(x0s)
    assert grads.shape == (2, 4)
    for b in range(2):
        np.testing.assert_allclose(grads[b].numpy(), torch.func.grad(loss)(x0s[b]).numpy(),
                                   rtol=1e-10)

    def jloss(x0):
        return _loss_of_solution(*jimplicit_solve(jax_di(pb0.cost.q[0], x0), opts=JOpts(),
                                                  method=method))

    jgrads = jax.jit(jax.vmap(jax.grad(jloss)))(jnp.asarray(x0s.numpy()))
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-8)


def test_vmap_over_shared_leaf_is_refused():
    """A leaf the batched solve kept shared until per-lane leaves came in
    (the linear dynamics' A) is taken one row per lane now, as `jax.vmap`
    batches it: the vmapped gradient in A over two lanes equals each
    lane's own gradient and JAX's vmapped gradients."""
    from altro_tpu.problem import Problem as JProblem

    pb0 = _di_problem()
    prob = diff_di_problem(t64(pb0.cost.q[0]), t64(pb0.x0))
    A = torch.eye(4, dtype=torch.float64).expand(prob.N, 4, 4).clone()
    A[:, 0, 2] = A[:, 1, 3] = 0.1
    Bm = torch.zeros((prob.N, 4, 2), dtype=torch.float64)
    Bm[:, :2, :] = 0.005 * torch.eye(2, dtype=torch.float64)
    Bm[:, 2:, :] = 0.1 * torch.eye(2, dtype=torch.float64)
    f = torch.zeros((prob.N, 4), dtype=torch.float64)
    linear = dataclasses.replace(prob, dynamics=None, A=A, B=Bm, f_aff=f)

    def loss(A_):
        return loss_of_solution(*implicit_solve(dataclasses.replace(linear, A=A_)))

    As = torch.stack([A, A * 0.99])
    grads = torch.func.vmap(torch.func.grad(loss))(As)
    for b in range(2):
        np.testing.assert_allclose(grads[b].numpy(), torch.func.grad(loss)(As[b]).numpy(),
                                   rtol=1e-10)
    jpb = JProblem(N=pb0.N, n=4, m=2, dynamics=None, dynamics_jac=None, constraints=(),
                   cost=pb0.cost, h=pb0.h, x0=pb0.x0, A=jnp.asarray(A.numpy()),
                   B=jnp.asarray(Bm.numpy()), f_aff=jnp.asarray(f.numpy()))

    def jloss(A_):
        return _loss_of_solution(*jimplicit_solve(dataclasses.replace(jpb, A=A_),
                                                  opts=JOpts()))

    jgrads = jax.jit(jax.vmap(jax.grad(jloss)))(jnp.asarray(As.numpy()))
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-8,
                               atol=1e-12 * float(np.abs(jgrads).max()))
