"""The port's merit function against altro_tpu's, and the reference's goldens.

`solver.merit_function` (closed-loop rollout, AL cost, analytic
dphi/dalpha and the payload x, u, y, A, B, lx, lu, convals, zproj)
against the JAX `merit_function` on the same numpy-seeded reference
trajectory, gains, duals and penalty, at alpha in {0, 0.37, 1}: the
Scotty bicycle with its steering bound (N=30) and the double integrator
with the goal and SOC bounds (N=10), f64, everything to 1e-10 relative.
Then the MeritFunTest goldens of tests/test_merit.py
(solver_impl_test.cpp:186-271): the double integrator with linear
dynamics and an affine term, phi and dphi at alpha 0 and 1, and a
finite-difference check of dphi.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.io.scotty import load_scotty as jload  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.double_integrator import double_integrator_dynamics as jdi  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import DiagonalCost as JCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import merit_function as jmerit  # noqa: E402
from altro_tpu_torch import mpc, solver  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.models.double_integrator import double_integrator_linear  # noqa: E402
from altro_tpu_torch.ops.riccati_latency import riccati_latency_ref  # noqa: E402
from altro_tpu_torch.problem import DiagonalCost, Problem  # noqa: E402

CPU = dict(dtype=torch.float64, device="cpu")
DM = 60 * np.pi / 180.0


def _problems(kind):
    """(JAX problem, port problem, reference x for the inputs)."""
    if kind == "bicycle_steering":
        N = 30
        ref = jload()
        steering = JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                         cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool))
        jp = JProblem(N=N, n=4, m=2, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
                      constraints=(steering,),
                      cost=jlqr(np.full((N + 1, 4), 1e-2), np.full((N + 1, 2), 1e-3),
                                ref.x[: N + 1], ref.u[: N + 1]),
                      h=jnp.full(N, float(np.float32(ref.tf / ref.N))),
                      x0=jnp.asarray(ref.x[0]))
        tp, _ = mpc.scotty_reference_problem(load_scotty(), N=N, **CPU)
        xr = ref.x[: N + 1].copy()
        xr[:, 3] = 1.0  # steering near the bound, so its AL term is in play
        return jp, tp, xr, ref.u[:N]
    N = rp.DI_N
    goal = JSpec(fn=lambda x, u, k: x - jnp.zeros(4), cone=JCone.ZERO, dim=4,
                 active=jnp.zeros(N + 1, bool).at[N].set(True))
    soc = JSpec(fn=lambda x, u, k: jnp.concatenate([u, jnp.full((1,), 1.0)]),
                cone=JCone.SECOND_ORDER, dim=3, active=jnp.ones(N + 1, bool).at[N].set(False))
    cost = JCost(Q=jnp.ones((N + 1, 4)), R=jnp.full((N + 1, 2), 1e-2), q=jnp.zeros((N + 1, 4)),
                 r=jnp.zeros((N + 1, 2)), c=jnp.zeros(N + 1))
    jp = JProblem(N=N, n=4, m=2, dynamics=jdi(2), dynamics_jac=None, constraints=(goal, soc),
                  cost=cost, h=jnp.full(N, rp.DI_H), x0=jnp.asarray([2.0, 2.0, 0.0, 0.0]))
    tp = rp.double_integrator_problem(
        [2.0, 2.0, 0.0, 0.0], (rp.di_goal_constraint(np.zeros(4), **CPU),
                               rp.di_soc_control_bound(1.0, device="cpu")), **CPU)
    xr = np.linspace([2.0, 2.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0], N + 1)
    return jp, tp, xr, np.full((N, 2), -0.6)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("kind", ["bicycle_steering", "double_integrator_soc"])
def test_merit_function_matches_jax(kind, alpha):
    jp, tp, xr, ur = _problems(kind)
    N, n, m = tp.N, tp.n, tp.m
    rng = np.random.default_rng(11)
    K = 0.05 * rng.standard_normal((N, m, n))
    d = 0.3 * rng.standard_normal((N, m))
    P = rng.standard_normal((N + 1, n, n))
    P = P @ P.transpose(0, 2, 1)
    p = rng.standard_normal((N + 1, n))
    # duals in the dual cones (NEGATIVE_ORTHANT: <= 0), so the AL terms are live
    z = tuple(rng.standard_normal((N + 1, s.dim)) for s in tp.constraints)
    z = tuple(-np.abs(zj) if s.cone.name == "NEGATIVE_ORTHANT" else zj
              for s, zj in zip(tp.constraints, z))
    x0 = xr[0] + 0.01 * rng.standard_normal(n)
    rho = 3.0
    args = (xr, ur, K, d, P, p)

    j = jmerit(jp, *map(jnp.asarray, args), tuple(map(jnp.asarray, z)), jnp.asarray(rho),
               alpha, jnp.asarray(x0), True)
    t = solver.merit_function(tp, *(torch.as_tensor(a) for a in args),
                              tuple(torch.as_tensor(a) for a in z), torch.tensor(rho, **CPU),
                              alpha, torch.as_tensor(x0), True)
    for name in ("phi", "dphi", "x", "u", "y", "A", "B", "lx", "lu"):
        jv = np.asarray(getattr(j, name))
        np.testing.assert_allclose(getattr(t, name).numpy(), jv, rtol=1e-10,
                                   atol=1e-10 * max(1.0, float(np.abs(jv).max())), err_msg=name)
    for name in ("convals", "zproj"):
        for tv, jv in zip(getattr(t, name), getattr(j, name)):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-12,
                                       err_msg=name)
    assert float(t.phi) > 0 and float(t.dphi) != 0.0
    if kind == "bicycle_steering":  # the bound's AL term is in play
        assert float(torch.cat(t.zproj).abs().max()) > 0


def _golden_problem():
    """tests/test_merit.py::make_problem: linear dynamics x' = A x + B u + f
    (h = 0.01, f = A x_eq) as a dynamics callable."""
    N, dim = 10, 2
    n, m = 2 * dim, dim
    A1, B1 = double_integrator_linear(dim, 0.01)
    f1 = A1 @ np.array([1.0, 2.0, 0.0, 0.0])
    A1t, B1t, f1t = (torch.as_tensor(a) for a in (A1, B1, f1))

    def dyn(x, u, h, k):
        col = (-1,) + (1,) * (x.ndim - 1)
        return (torch.einsum("ij,j...->i...", A1t, x) + torch.einsum("ij,j...->i...", B1t, u)
                + f1t.reshape(col))

    Qd, Rd = np.full(n, 1.1), np.full(m, 0.1)
    t = lambda a: torch.as_tensor(a, **CPU)  # noqa: E731
    cost = DiagonalCost(Q=t(np.concatenate([np.tile(Qd, (N, 1)), (Qd * 100)[None]])),
                        R=t(np.tile(Rd, (N + 1, 1))), q=t(np.full((N + 1, n), 0.01)),
                        r=t(np.full((N + 1, m), 0.001)), c=torch.zeros(N + 1, **CPU))
    x0 = np.array([10.5, -20.5, -4.0, 5.0])
    prob = Problem(N=N, n=n, m=m, dynamics=dyn, dynamics_jac=None, constraints=(), cost=cost,
                   h=torch.full((N,), 0.01, **CPU), x0=t(x0))
    xf = np.array([-1.0, 2.0, 0.0, 0.0])
    theta = np.arange(N) / N
    xref = np.concatenate([x0[None] + (xf - x0)[None] * theta[:, None], xf[None]])
    return prob, t(xref), t(np.tile(theta[:, None], (1, m)))


def test_merit_goldens():
    """solver_impl_test.cpp:186-271 (tests/test_merit.py::test_merit_goldens)."""
    prob, xref, uref = _golden_problem()
    rho = torch.tensor(1.0, **CPU)
    A, B = solver.dynamics_expansions(prob, xref, uref)
    lx, lu, lxx, luu, lux, _ = solver._cost_expansions_and_cost(prob, xref, uref, (), rho)
    g = riccati_latency_ref(A, B, lxx, luu, lx, lu, 0.0, lux=lux)
    assert bool(g.ok)

    def merit(alpha, deriv=True):
        return solver.merit_function(prob, xref, uref, g.K, g.d, g.P, g.p, (), rho, alpha,
                                     prob.x0, deriv)

    m1 = merit(1.0)
    np.testing.assert_allclose(float(m1.phi), 25992.822836536347, rtol=1e-6)
    np.testing.assert_allclose(float(m1.dphi), -43.52330058003784, rtol=1e-6)
    eps = 1e-6
    dphi_fd = (float(merit(1.0 + eps, deriv=False).phi) - float(m1.phi)) / eps
    assert abs(float(m1.dphi) - dphi_fd) / abs(float(m1.dphi)) < 1e-6
    m0 = merit(0.0)
    np.testing.assert_allclose(float(m0.phi), 26039.092492842017, rtol=1e-6)
    np.testing.assert_allclose(float(m0.dphi), -49.01601203132092, rtol=1e-6)
    assert float(merit(1.0, deriv=False).dphi) == 0.0  # JAX's value without the derivative
