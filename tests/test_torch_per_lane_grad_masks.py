"""`torch.func.vmap` over the constraints' masks through
`diff.implicit_solve`, as `jax.vmap` batches `ConstraintSpec.active`, in
f64 on the CPU: the fleet's lane-0 problem (tests/
test_torch_per_lane_dynamics.py) with the control bound's mask and x0 one
row per lane, every other leaf shared, and the gradient in x0 and in the
cost's q. The masks enter `_ImplicitSolve` as tensor inputs with no
derivative (JAX's float0 leaves), so the vmap rule solves each lane with
its own mask and the backward reads it under the vmap level. Both linear
solves (the Gauss-Newton backward's vmap rule, the conjugate gradients with
frozen lanes) equal `jax.vmap(jax.grad(loss))` to rtol 1e-8 (entries
below 1e-10 of the largest, the conjugate gradients' stopping residual,
to that scale). On lane 0,
whose bound binds, the Gauss-Newton gradient in x0 of the tight solve
(test_diff.py's options) equals central finite differences of the port's
own tight solves to tests/test_diff.py's
constrained tolerance (rtol 1e-3, atol 1e-6: the fixed-multiplier AL
sensitivity)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.diff import implicit_solve as jimplicit_solve  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu_torch._finite_diff import fd_grad  # noqa: E402
from altro_tpu_torch.diff import implicit_solve  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from test_torch_per_lane_dynamics import ARRAYS, jax_problem, lane  # noqa: E402
from test_torch_per_lane_grad import loss_of_solution, port_lane_problem  # noqa: E402


def _port(base, active, x0, q):
    spec = dataclasses.replace(base.constraints[0], active=active)
    return dataclasses.replace(base, x0=x0, constraints=(spec,),
                               cost=dataclasses.replace(base.cost, q=q))


@pytest.mark.parametrize("method", ["tvlqr", "cg"])
def test_vmap_over_masks_matches_jax(method):
    base = port_lane_problem()

    def loss(active, x0, q):
        return loss_of_solution(*implicit_solve(_port(base, active, x0, q), method=method))

    act = torch.as_tensor(ARRAYS["active"][0])
    x0 = torch.as_tensor(ARRAYS["x0"])
    q = base.cost.q
    gx, gq = torch.func.vmap(torch.func.grad(loss, argnums=(1, 2)), in_dims=(0, 0, None))(
        act, x0, q)
    assert gq.shape == (act.shape[0],) + tuple(q.shape)

    one = {k: jnp.asarray(v) for k, v in lane(ARRAYS).items()}

    def jloss(active, x0_, q_):
        prob = jax_problem(dict(one, x0=x0_, q=q_), active)
        x, u = jimplicit_solve(prob, opts=JOpts(), method=method)
        return jnp.sum(x ** 2) + 0.5 * jnp.sum(u ** 2)

    jgx, jgq = jax.jit(jax.vmap(jax.grad(jloss, argnums=(1, 2)), in_axes=(0, 0, None)))(
        jnp.asarray(ARRAYS["active"][0]), jnp.asarray(ARRAYS["x0"]), one["q"])
    # the conjugate gradients stop at a residual of cg_tol = 1e-10 of |w|: an
    # entry far below the gradient's largest is equal to that scale
    floor = 1e-12 if method == "tvlqr" else 1e-10
    for g, jg in ((gx, jgx), (gq, jgq)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8,
                                   atol=floor * float(np.abs(jg).max()))
    # lanes with different masks and starts have different gradients
    assert not np.allclose(gx[0].numpy(), gx[2].numpy())

    if method == "tvlqr":  # lane 0: its bound binds
        tight = SolverOptions(tol_stationarity=1e-9, tol_primal_feasibility=1e-9,
                              penalty_max=1e10)
        g0 = torch.func.grad(lambda x0_: loss_of_solution(*implicit_solve(
            _port(base, act[0], x0_, q), opts=tight)))(x0[0])
        fd = fd_grad(lambda th: _port(base, act[0], th, q), x0[0], loss_of_solution, tight,
                     eps=1e-5)
        np.testing.assert_allclose(g0.numpy(), fd.numpy(), rtol=1e-3, atol=1e-6)
