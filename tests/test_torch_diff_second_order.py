"""Second derivatives through `diff.implicit_solve` are refused, as JAX's
`custom_vjp` refuses them, on tests/test_diff.py's LQR loss in q[0] and
x0 (f64, CPU).

JAX: `jax.hessian` (forward over reverse) raises, since forward mode does
not run through a `custom_vjp`, and reverse over reverse raises at the
solve's while loop. The port raises `diff.ONCE`, which names the
once-differentiability, for `torch.func.jacrev` / `jacfwd` over
`torch.func.grad`, `torch.func.hessian`, `grad` over `grad`, a
forward-mode `torch.func.jvp` and a second `torch.autograd.grad` through a
first one taken with `create_graph=True`; no Hessian comes back. The
first-order gradient of that first call (and under `vmap`) is JAX's."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.diff import implicit_solve as jimplicit_solve  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu_torch.diff import ONCE, implicit_solve  # noqa: E402
from altro_tpu_torch.reference_problems import diff_di_problem  # noqa: E402
from test_diff import _di_problem, _loss_of_solution  # noqa: E402
from test_torch_diff_lqr import jax_di, loss_of_solution, t64  # noqa: E402

PB0 = _di_problem()


def _jloss(x0):
    return _loss_of_solution(*jimplicit_solve(jax_di(PB0.cost.q[0], x0), opts=JOpts()))


def _loss(x0):
    return loss_of_solution(*implicit_solve(diff_di_problem(t64(PB0.cost.q[0]), x0)))


@pytest.mark.parametrize("kind, error, words", [
    ("hessian", AssertionError, ""),
    ("grad_of_grad", ValueError, "Linearization failed")])
def test_jax_refuses_second_derivatives(kind, error, words):
    if kind == "hessian":
        f = jax.hessian(_jloss)
    else:
        f = jax.grad(lambda x0: jnp.sum(jax.grad(_jloss)(x0)))
    with pytest.raises(error, match=words):
        f(PB0.x0)


SECOND = {
    "jacrev_of_grad": lambda x0: torch.func.jacrev(torch.func.grad(_loss))(x0),
    "jacfwd_of_grad": lambda x0: torch.func.jacfwd(torch.func.grad(_loss))(x0),
    "hessian": lambda x0: torch.func.hessian(_loss)(x0),
    "grad_of_grad": lambda x0: torch.func.grad(lambda v: torch.func.grad(_loss)(v).sum())(x0),
    "jvp": lambda x0: torch.func.jvp(_loss, (x0,), (torch.ones_like(x0),)),
}


@pytest.mark.parametrize("kind", list(SECOND))
def test_port_refuses_second_derivatives_by_name(kind):
    with pytest.raises(RuntimeError, match="once-differentiable"):
        SECOND[kind](t64(PB0.x0))


def test_autograd_create_graph_then_second_grad_raises():
    jg = np.asarray(jax.grad(_jloss)(PB0.x0))
    x0 = t64(PB0.x0).requires_grad_(True)
    (g,) = torch.autograd.grad(_loss(x0), x0, create_graph=True)
    np.testing.assert_allclose(g.detach().numpy(), jg, rtol=1e-8)
    with pytest.raises(RuntimeError, match="once-differentiable") as err:
        torch.autograd.grad(g.sum(), x0)
    assert str(err.value) == ONCE
    # first order as before, one lane and vmapped
    (g1,) = torch.autograd.grad(_loss(x0), x0)
    np.testing.assert_allclose(g1.numpy(), jg, rtol=1e-8)
    gv = torch.func.vmap(torch.func.grad(_loss))(torch.stack([t64(PB0.x0)] * 2))
    np.testing.assert_allclose(gv.numpy(), np.stack([jg] * 2), rtol=1e-8)
