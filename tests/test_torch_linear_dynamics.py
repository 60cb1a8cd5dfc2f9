"""Linear dynamics arrays in the port's `Problem` (A [N, n, n], B [N, n, m],
f_aff [N, n], dynamics=None: `linear_dynamics`, `dyn_step`,
`dyn_expansion`), against the JAX package in f64 on
tests/test_merit.py:49's problem (the linear double integrator with the
affine term and a prescribed reference):

* `dyn_step` and `dyn_expansion` for one lane, a batch and knot stacks;
* the merit goldens of tests/test_merit.py (phi and dphi at alpha 0 and
  1, and the finite-difference derivative) through the port's
  `merit_function` on the port's own backward pass;
* the single-lane solve and the vmapped solve on the linear problem,
  held to JAX's `solve` / `jax.vmap(solve)`: status and iterations equal,
  x and u within 1e-10.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.parallel.batch import batch_init_state, vmap_solve  # noqa: E402
from altro_tpu_torch.problem import DiagonalCost, Problem  # noqa: E402
from altro_tpu_torch.tvlqr import tvlqr_backward  # noqa: E402

test_merit = pytest.importorskip("test_merit")


def port_problem():
    """test_merit.make_problem's problem and reference in the port (f64)."""
    jp, xref, uref = test_merit.make_problem()
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    c = jp.cost
    prob = Problem(N=jp.N, n=jp.n, m=jp.m, dynamics=None, dynamics_jac=None, constraints=(),
                   cost=DiagonalCost(t(c.Q), t(c.R), t(c.q), t(c.r), t(c.c)), h=t(jp.h),
                   x0=t(jp.x0), A=t(jp.A), B=t(jp.B), f_aff=t(jp.f_aff))
    return prob, t(xref), t(uref)


def test_dyn_step_and_expansion_match_jax():
    jp, _, _ = test_merit.make_problem()
    prob, xref, uref = port_problem()
    assert prob.linear_dynamics and jp.linear_dynamics
    rng = np.random.default_rng(0)
    x, u = rng.standard_normal((4, 6)), rng.standard_normal((2, 6))
    for k in (0, 3, 9):
        want = np.stack([np.asarray(jp.dyn_step(k, jnp.asarray(x[:, b]), jnp.asarray(u[:, b])))
                         for b in range(6)], 1)
        got = prob.dyn_step(k, torch.as_tensor(x), torch.as_tensor(u))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
        one = prob.dyn_step(k, torch.as_tensor(x[:, 0]), torch.as_tensor(u[:, 0]))
        np.testing.assert_allclose(one.numpy(), want[:, 0], rtol=1e-14, atol=1e-14)
    ks = torch.arange(prob.N)
    A, B = prob.dyn_expansion(ks[:, None], xref[:-1].T[:, :, None].expand(-1, -1, 3),
                              uref.T[:, :, None].expand(-1, -1, 3))
    assert A.shape == (4, 4, prob.N, 3) and B.shape == (4, 2, prob.N, 3)
    for k in range(prob.N):
        Aj, Bj = jp.dyn_expansion(k, None, None)
        np.testing.assert_array_equal(A[:, :, k, 1].numpy(), np.asarray(Aj))
        np.testing.assert_array_equal(B[:, :, k, 2].numpy(), np.asarray(Bj))


def test_merit_goldens_on_linear_dynamics():
    prob, xref, uref = port_problem()
    rho = torch.tensor(1.0, dtype=torch.float64)
    lx, lu, lxx, luu, _, _ = solver._cost_expansions_and_cost_diag(prob, xref, uref, (), rho)
    A, B = solver.dynamics_expansions(prob, xref, uref)
    g = tvlqr_backward(A[None], B[None], torch.zeros_like(lx[:-1])[None], lxx[None], luu[None],
                       None, lx[None], lu[None])
    assert bool(g.ok.all())

    def merit(alpha, deriv=True):
        return solver.merit_function(prob, xref, uref, g.K[0], g.d[0], g.P[0], g.p[0], (), rho,
                                     alpha, prob.x0, deriv)

    m1 = merit(1.0)
    np.testing.assert_allclose(float(m1.phi), 25992.822836536347, rtol=1e-6)
    np.testing.assert_allclose(float(m1.dphi), -43.52330058003784, rtol=1e-6)
    eps = 1e-6
    dphi_fd = (float(merit(1.0 + eps, False).phi) - float(m1.phi)) / eps
    assert abs(float(m1.dphi) - dphi_fd) / abs(float(m1.dphi)) < 1e-6
    m0 = merit(0.0)
    np.testing.assert_allclose(float(m0.phi), 26039.092492842017, rtol=1e-6)
    np.testing.assert_allclose(float(m0.dphi), -49.01601203132092, rtol=1e-6)


OPTS = dict(iterations_max=20, use_backtracking_linesearch=True, throw_errors=False)


def test_single_lane_solve_on_linear_dynamics_matches_jax():
    jp, _, _ = test_merit.make_problem()
    prob, _, _ = port_problem()
    js, jst = jsolve(jp, jinit(jp), JOpts(**OPTS))
    ts, tst = solver.solve(prob, solver.init_state(prob), SolverOptions(**OPTS))
    assert int(tst.status) == int(jst.status) and int(tst.iterations) == int(jst.iterations)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-10)


def test_vmapped_solve_on_linear_dynamics_matches_jax():
    jp, _, _ = test_merit.make_problem()
    prob, _, _ = port_problem()
    Bsz = 3
    x0s = np.asarray(jp.x0)[None] + np.random.default_rng(1).standard_normal((Bsz, 4))
    jst0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (Bsz,) + a.shape), jinit(jp))
    js, jst = jax.vmap(lambda x0, s: jsolve(dataclasses.replace(jp, x0=x0), s, JOpts(**OPTS)))(
        jnp.asarray(x0s), jst0)
    ts, tst = vmap_solve(prob, SolverOptions(**OPTS))(torch.as_tensor(x0s),
                                                      batch_init_state(prob, Bsz))
    np.testing.assert_array_equal(tst.status.numpy(), np.asarray(jst.status))
    np.testing.assert_array_equal(tst.iterations.numpy(), np.asarray(jst.iterations))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-10)
