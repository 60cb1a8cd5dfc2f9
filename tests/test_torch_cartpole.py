"""The cart-pole against altro_tpu (tests/test_models_extra.py).

`models.cartpole.cartpole_continuous` against the JAX model's f and its
rk4 step (h = 0.05) at random states and forces, batched
component-first, to 1e-12. The swing-up of test_cartpole_swing_up
(`reference_problems.cartpole_swingup_problem`, N=100, the sequential
backtracking with cubic first) cut to its first 8 and 30 iterations,
through the port's `solver.solve` and JAX's `solve` in f64: status,
iterations and ls_iterations equal; x and u to 1e-8 at 8 iterations,
and at 30 to the tolerances CUTS states with their reason (the
interpolated steps amplify the two solves' roundoff; the full 300 run
on the card, held to the oracle's |theta_N - pi| < 0.05, |x_N| < 0.1).
CPU tensors run the plain backward; on the card in f32 it is
csrc/riccati_latency.cu at (4, 1).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.cartpole import cartpole_continuous as jcartpole  # noqa: E402
from altro_tpu.models.integrators import rk4 as jrk4  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.models.cartpole import cartpole_continuous  # noqa: E402
from altro_tpu_torch.models.integrators import rk4  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.reference_problems import cartpole_swingup_problem  # noqa: E402

N, n, m = 100, 4, 1
ITERS = 30


def test_model_and_rk4_step_match_jax():
    rng = np.random.default_rng(0)
    K = 16
    x = rng.standard_normal((K, n)) * np.array([1.0, 3.0, 2.0, 5.0])
    u = 10.0 * rng.standard_normal((K, m))
    jf = jax.vmap(jcartpole())(jnp.asarray(x), jnp.asarray(u))
    jstep = jax.vmap(lambda xi, ui: jrk4(jcartpole())(xi, ui, 0.05, 0))(jnp.asarray(x),
                                                                       jnp.asarray(u))
    tx, tu = torch.as_tensor(x.T.copy()), torch.as_tensor(u.T.copy())
    np.testing.assert_allclose(cartpole_continuous()(tx, tu).numpy().T, np.asarray(jf),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(rk4(cartpole_continuous())(tx, tu, 0.05, 0).numpy().T,
                               np.asarray(jstep), rtol=0, atol=1e-12)
    # one point unbatched, as the solve's dynamics take it
    np.testing.assert_allclose(cartpole_continuous()(tx[:, 0], tu[:, 0]).numpy(),
                               np.asarray(jf[0]), rtol=0, atol=1e-12)


def _jax_swingup(iterations):
    xf = np.array([0.0, np.pi, 0.0, 0.0])
    Qd = np.tile(np.full(n, 1e-2), (N + 1, 1))
    Qd[N] = [10.0, 400.0, 10.0, 10.0]
    cost = jlqr(jnp.asarray(Qd), jnp.full((N + 1, m), 1e-3), jnp.tile(jnp.asarray(xf), (N + 1, 1)),
                jnp.zeros((N + 1, m)))
    prob = JProblem(N=N, n=n, m=m, dynamics=jrk4(jcartpole()), dynamics_jac=None, constraints=(),
                    cost=cost, h=jnp.full(N, 0.05), x0=jnp.zeros(n))
    st = dataclasses.replace(jinit(prob), u=jnp.full((N, m), 0.2))
    opts = JOpts(iterations_max=iterations, use_backtracking_linesearch=True)
    return jax.jit(lambda s: jsolve(prob, s, opts))(st)


# iterations, (x, u, x_N, objective relative) tolerances. Until iteration 8
# the two solves agree to roundoff (x to 7e-11, u to 5e-10); from
# iteration 9 the cubic-first backtracking's interpolated step amplifies
# it (alpha 0.49989667 in both, 4e-8 apart), and at 30 iterations x
# differs by up to 1.0e-5, u by 9.0e-5, x_N by 2.3e-7 and the objective
# by 2.3e-8 relative (JAX's own float32 run differs from its float64 run
# by 0.48 in x there).
CUTS = {8: (1e-8, 1e-8, 1e-8, 1e-10), 30: (1e-4, 1e-3, 1e-5, 1e-6)}


@pytest.mark.parametrize("iterations", list(CUTS))
def test_swingup_first_iterations_match_jax(iterations):
    tol_x, tol_u, tol_xn, tol_obj = CUTS[iterations]
    jst, jstats = _jax_swingup(iterations)
    prob, st = cartpole_swingup_problem(dtype=torch.float64, device="cpu")
    before = rl.LAUNCHES
    res = mpc.run_cartpole_swingup(prob, st, mpc.cartpole_swingup_options(iterations))
    assert rl.LAUNCHES == before  # CPU: the plain backward only
    for k in ("status", "iterations", "ls_iterations"):
        assert int(getattr(res.stats, k)) == int(getattr(jstats, k)), k
    assert int(res.stats.iterations) == iterations  # every iteration compared
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(jst.x), rtol=0, atol=tol_x)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(jst.u), rtol=0, atol=tol_u)
    np.testing.assert_allclose(res.state.x[-1].numpy(), np.asarray(jst.x[-1]), rtol=0,
                               atol=tol_xn)
    np.testing.assert_allclose(float(res.stats.objective_value), float(jstats.objective_value),
                               rtol=tol_obj)
    assert res.metrics()["finite"]
