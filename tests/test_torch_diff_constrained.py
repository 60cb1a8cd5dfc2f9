"""`diff.implicit_solve` on the port against altro_tpu/diff.py: tests/
test_diff.py's control-bounded double integrator (:157) in f64 on the
CPU. The fixed-multiplier AL sensitivity equals JAX's gradient to rtol
1e-8 and the central finite differences of the port's own solves to
test_diff.py's rtol 1e-3 / atol 1e-6, with the bound binding."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.diff import implicit_solve as jimplicit_solve  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JConstraintSpec  # noqa: E402
from altro_tpu_torch._finite_diff import fd_grad  # noqa: E402
from altro_tpu_torch.diff import implicit_solve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.reference_problems import DIFF_TIGHT, diff_bounded_problem  # noqa: E402
from test_diff import _di_problem, _loss_of_solution  # noqa: E402
from test_torch_diff_lqr import (  # noqa: E402
    assert_same_leaves,
    jax_di,
    loss_of_solution,
    t64,
)

U_BND = 0.5
OPTS = dict(DIFF_TIGHT, penalty_max=1e10)


def jax_bounded(q_row0):
    base = _di_problem()
    bound = JConstraintSpec(fn=lambda x, u, k: jnp.concatenate([u - U_BND, -U_BND - u]),
                            cone=JCone.NEGATIVE_ORTHANT, dim=4,
                            active=jnp.arange(base.N + 1) < base.N)
    return dataclasses.replace(jax_di(q_row0, base.x0), constraints=(bound,))


def test_constrained_grad_matches_jax_and_fd():
    opts = SolverOptions(**OPTS)
    q0 = t64(_di_problem().cost.q[0]) * 4.0  # push harder so the bound is active
    assert_same_leaves(diff_bounded_problem(q0), jax_bounded(jnp.asarray(q0.numpy())))
    x, u = implicit_solve(diff_bounded_problem(q0), opts=opts)
    assert float(u.abs().max()) > U_BND - 1e-6  # the bound binds

    g = torch.func.grad(lambda q: loss_of_solution(
        *implicit_solve(diff_bounded_problem(q), opts=opts)))(q0)
    jg = jax.jit(jax.grad(lambda q: _loss_of_solution(
        *jimplicit_solve(jax_bounded(q), opts=JOpts(**OPTS)))))(jnp.asarray(q0.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-12)
    fd = fd_grad(diff_bounded_problem, q0, loss_of_solution, opts, eps=1e-5)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-3, atol=1e-6)
