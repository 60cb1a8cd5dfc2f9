"""`torch.func.vmap(torch.func.grad(loss))` through `diff.implicit_solve`
with every leaf of the fleet one row per lane (tests/
test_torch_per_lane_dynamics.py's B=8 double integrators at N=10), in f64
on the CPU: the gradients in A, B, f_aff and the QuadraticCost's Q equal
`jax.vmap(jax.grad(loss))` to rtol 1e-8. `_ImplicitSolve.vmap` solves the
lanes as `solve_lanes` and the Gauss-Newton backward's vmap rule takes the
per-lane A and B (ops/gn_backward.py). On lane 1, whose control bound is
off at every knot (linear dynamics and a quadratic cost: the implicit
gradient is exact), the same gradients equal central finite differences
of the port's own solves to tests/test_diff.py's rtol 1e-6 / atol 1e-8
(Q along symmetric directions: the solve's cost gradient is Q x, so an
asymmetric Q solves another problem than the one its value states, in
JAX as here)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.diff import implicit_solve as jimplicit_solve  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch._finite_diff import fd_grad  # noqa: E402
from altro_tpu_torch.diff import implicit_solve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from test_torch_per_lane_dynamics import ARRAYS, N, jax_problem, lane  # noqa: E402

GRAD = ("A", "B", "f_aff", "Q")


def port_lane_problem(b=0, dtype=torch.float64):
    """Lane b's fleet problem on one lane (x0 [n]), from the same arrays."""
    return convert.problem_from_numpy(lane(ARRAYS, b), N=N, n=4, m=2, dynamics=None,
                                      constraints=(rp.fleet_bound(N, device="cpu"),),
                                      dtype=dtype, device="cpu")


def port_with(base, A, Bm, f, Q, active, x0):
    spec = dataclasses.replace(base.constraints[0], active=active)
    return dataclasses.replace(base, A=A, B=Bm, f_aff=f, x0=x0, constraints=(spec,),
                               cost=dataclasses.replace(base.cost, Q=Q))


def loss_of_solution(x, u):
    return torch.sum(x ** 2) + 0.5 * torch.sum(u ** 2)


def test_vmapped_gradients_in_every_dynamics_and_cost_leaf_match_jax():
    base = port_lane_problem()

    def loss(A, Bm, f, Q, active, x0):
        return loss_of_solution(*implicit_solve(port_with(base, A, Bm, f, Q, active, x0)))

    t = {k: torch.as_tensor(ARRAYS[k]) for k in GRAD + ("x0",)}
    act = torch.as_tensor(ARRAYS["active"][0])
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3)))(
        *(t[k] for k in GRAD), act, t["x0"])

    one = {k: jnp.asarray(v) for k, v in lane(ARRAYS).items()}

    def jloss(A, Bm, f, Q, active, x0):
        prob = jax_problem(dict(one, A=A, B=Bm, f_aff=f, Q=Q, x0=x0), active)
        x, u = jimplicit_solve(prob, opts=JOpts())
        return jnp.sum(x ** 2) + 0.5 * jnp.sum(u ** 2)

    jgrads = jax.jit(jax.vmap(jax.grad(jloss, argnums=(0, 1, 2, 3))))(
        *(jnp.asarray(ARRAYS[k]) for k in GRAD), jnp.asarray(ARRAYS["active"][0]),
        jnp.asarray(ARRAYS["x0"]))
    for name, g, jg in zip(GRAD, grads, jgrads):
        assert g.shape == ARRAYS[name].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8,
                                   atol=1e-12 * float(np.abs(jg).max()), err_msg=name)

    # lane 1 (its batched leaves, lane 0's shared ones): no active bound,
    # so the implicit gradient is exact
    assert not ARRAYS["active"][0, 1].any()
    theta = {k: t[k][1] for k in GRAD}
    opts = SolverOptions()
    for i, name in enumerate(GRAD):
        def build(th, name=name):
            # Q perturbed symmetrically: the solve's cost gradient is Q x
            kw = dict(theta, **{name: 0.5 * (th + th.transpose(1, 2)) if name == "Q" else th})
            return port_with(base, kw["A"], kw["B"], kw["f_aff"], kw["Q"], act[1], t["x0"][1])

        g = grads[i][1]
        if name == "Q":
            g = 0.5 * (g + g.transpose(1, 2))
        fd = fd_grad(build, theta[name], loss_of_solution, opts)
        np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-6, atol=1e-8, err_msg=name)
