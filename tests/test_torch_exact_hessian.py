"""The exact AL Hessian (`al.al_hess_exact`, SolverOptions.exact_al_hessian)
and `al.knot_violation` against the JAX package in float64.

* `al_hess_exact` at random knots against JAX's autodiff Hessian of its
  `al_cost` (`jax.hessian`), within 1e-10: the nonconvex obstacle rows and
  an affine input row of tests/test_al_formulas.py's fixture in the
  NEGATIVE_ORTHANT and the SECOND_ORDER cone, the terminal knot included
  (lxx only there), and knots where the projection ties (z - rho c = 0
  exactly, zero duals on a row at its bound), where JAX's derivative of
  min(., 0) is 1/2.
* The finite-difference oracle of tests/test_al_formulas.py:133.
* `knot_violation` against JAX's at every knot.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu import al as jal  # noqa: E402
from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import DiagonalCost as JDiag  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu_torch import al  # noqa: E402
from altro_tpu_torch.cones import Cone  # noqa: E402
from altro_tpu_torch.problem import ConstraintSpec, DiagonalCost, Problem  # noqa: E402

Nk, n, m, p = 4, 3, 2, 3
C1 = np.array([1.0, 2.0, 3.0])
C2 = np.array([4.0, 4.0, 4.0])


def jcon(x, u, k):
    return jnp.stack([1.0 - jnp.sum((x - C1) ** 2), 4.0 - jnp.sum((x - C2) ** 2), u[0] + u[1]])


def tcon(x, u, k):
    c1 = torch.as_tensor(C1, dtype=x.dtype).reshape((3,) + (1,) * (x.ndim - 1))
    c2 = torch.as_tensor(C2, dtype=x.dtype).reshape((3,) + (1,) * (x.ndim - 1))
    return torch.stack([1.0 - torch.sum((x - c1) ** 2, dim=0),
                        4.0 - torch.sum((x - c2) ** 2, dim=0), u[0] + u[1]])


def jbound(x, u, k):  # an affine group, on x_0 and u_1
    return jnp.stack([x[0] - 0.5, -0.5 - u[1]])


def tbound(x, u, k):
    return torch.stack([x[0] - 0.5, -0.5 - u[1]])


def _problems(cone_name):
    rng = np.random.default_rng(0)
    Q, R = rng.uniform(0.5, 2.0, (Nk + 1, n)), rng.uniform(0.5, 2.0, (Nk + 1, m))
    q, r, c = rng.standard_normal((Nk + 1, n)), rng.standard_normal((Nk + 1, m)), np.zeros(Nk + 1)
    active = np.ones(Nk + 1, bool)
    active[1] = False
    bound_active = np.ones(Nk + 1, bool)
    jp = JProblem(
        N=Nk, n=n, m=m, dynamics=lambda x, u, h, k: x, dynamics_jac=None,
        constraints=(JSpec(fn=jcon, cone=getattr(JCone, cone_name), dim=p,
                           active=jnp.asarray(active), label="c"),
                     JSpec(fn=jbound, cone=JCone.NEGATIVE_ORTHANT, dim=2,
                           active=jnp.asarray(bound_active), label="b", affine=True)),
        cost=JDiag(*(jnp.asarray(a) for a in (Q, R, q, r, c))), h=jnp.full(Nk, 0.1),
        x0=jnp.zeros(n))
    tt = [torch.as_tensor(a) for a in (Q, R, q, r, c)]
    tp = Problem(
        N=Nk, n=n, m=m, dynamics=lambda x, u, h, k: x, dynamics_jac=None,
        constraints=(ConstraintSpec(fn=tcon, cone=getattr(Cone, cone_name), dim=p,
                                    active=torch.as_tensor(active), label="c"),
                     ConstraintSpec(fn=tbound, cone=Cone.NEGATIVE_ORTHANT, dim=2,
                                    active=torch.as_tensor(bound_active), label="b",
                                    affine=True)),
        cost=DiagonalCost(*tt), h=torch.full((Nk,), 0.1, dtype=torch.float64),
        x0=torch.zeros(n, dtype=torch.float64))
    return jp, tp


def _points(cone_name, seed):
    """(x [K, n], u [K, m], z per group [K, p]) at knots 0..N: random, then
    knot 2 at a tie on every NEGATIVE_ORTHANT row (zero duals, c = 0)."""
    rng = np.random.default_rng(seed)
    x = 2.0 + 0.6 * rng.standard_normal((Nk + 1, n))
    u = 3.0 * rng.standard_normal((Nk + 1, m))
    z0 = rng.standard_normal((Nk + 1, p)) * (3.0 if cone_name == "SECOND_ORDER" else 1.0)
    z1 = -np.abs(rng.standard_normal((Nk + 1, 2)))
    # knot 2: obstacle row 0 at its boundary |x - C1| = 1, the sum row at 0,
    # the bound rows at 0; duals zero there
    x[2] = C1 + np.array([1.0, 0.0, 0.0])
    u[2] = np.array([0.5, -0.5])  # the sum row u0 + u1 and bound row -0.5 - u1 at 0
    z0[2] = 0.0
    z1[2] = 0.0
    return x, u, (z0, z1)


@pytest.mark.parametrize("cone_name", ["NEGATIVE_ORTHANT", "SECOND_ORDER"])
@pytest.mark.parametrize("seed", [1, 2])
def test_al_hess_exact_matches_jax(cone_name, seed):
    jp, tp = _problems(cone_name)
    x, u, z = _points(cone_name, seed)
    rho = 1.7
    for k in range(Nk + 1):
        terminal = k == Nk
        zk = tuple(jnp.asarray(zj[k]) for zj in z)
        want = jal.al_hess_exact(jp, k, jnp.asarray(x[k]), None if terminal else jnp.asarray(u[k]),
                                 zk, jnp.asarray(rho), terminal=terminal)
        ks = torch.tensor([k])
        got = al.al_hess_exact(
            tp, ks, torch.as_tensor(x[k])[None, :, None],
            None if terminal else torch.as_tensor(u[k])[None, :, None],
            tuple(torch.as_tensor(zj[k])[None, :, None] for zj in z),
            torch.tensor([rho], dtype=torch.float64), terminal=terminal)
        for name, g, w in zip(("lxx", "luu", "lux"), got, want):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g[0, ..., 0].numpy(), np.asarray(w), rtol=0, atol=1e-10,
                                       err_msg=f"{name} at knot {k}")


def test_tie_knot_differs_from_gauss_newton():
    """At knot 2 every NEGATIVE_ORTHANT row ties; the exact Hessian's
    Gauss-Newton weight there is rho / 4 (JAX's balanced derivative of min),
    so exact and Gauss-Newton differ on the tied rows' terms."""
    _, tp = _problems("NEGATIVE_ORTHANT")
    x, u, z = _points("NEGATIVE_ORTHANT", 1)
    args = (tp, torch.tensor([2]), torch.as_tensor(x[2])[None, :, None],
            torch.as_tensor(u[2])[None, :, None],
            tuple(torch.as_tensor(zj[2])[None, :, None] for zj in z),
            torch.tensor([1.7], dtype=torch.float64))
    ex = al.al_hess_exact(*args, terminal=False)
    gn = al.al_hess(*args, terminal=False)
    # the sum row u0 + u1 ties: its GN term rho (1 1)'(1 1) scaled by 1/4
    d_uu = (gn[1] - ex[1])[0, :, :, 0].numpy()
    np.testing.assert_allclose(d_uu[0, 1], 0.75 * 1.7, atol=1e-12)


def test_exact_hessian_matches_finite_differences():
    """tests/test_al_formulas.py:133's oracle on the port: the exact Hessian
    equals central differences of al_grad through active obstacle rows, and
    differs from the Gauss-Newton one there."""
    _, tp = _problems("NEGATIVE_ORTHANT")
    rho = torch.tensor([1.2], dtype=torch.float64)
    z = (torch.tensor([-0.7, -0.3, 0.1], dtype=torch.float64)[None, :, None],
         torch.zeros((1, 2, 1), dtype=torch.float64))
    x = torch.tensor([1.5, 1.8, 2.5], dtype=torch.float64)
    u = torch.tensor([3.0, -2.0], dtype=torch.float64)
    ks = torch.tensor([0])

    def grad(xx, uu):
        return al.al_grad(tp, ks, xx[None, :, None], uu[None, :, None], z, rho, terminal=False)

    lxx, luu, _ = al.al_hess_exact(tp, ks, x[None, :, None], u[None, :, None], z, rho,
                                   terminal=False)
    gxx = al.al_hess(tp, ks, x[None, :, None], u[None, :, None], z, rho, terminal=False)[0]
    eps = 1e-6
    fd_xx = torch.stack([(grad(x + eps * e, u)[0] - grad(x - eps * e, u)[0])[0, :, 0] / (2 * eps)
                         for e in torch.eye(3, dtype=torch.float64)])
    fd_uu = torch.stack([(grad(x, u + eps * e)[1] - grad(x, u - eps * e)[1])[0, :, 0] / (2 * eps)
                         for e in torch.eye(2, dtype=torch.float64)])
    np.testing.assert_allclose(lxx[0, :, :, 0].numpy(), fd_xx.numpy(), atol=1e-6)
    np.testing.assert_allclose(luu[0, :, :, 0].numpy(), fd_uu.numpy(), atol=1e-6)
    assert float((lxx - gxx).abs().max()) > 0.1


@pytest.mark.parametrize("seed", [3, 4])
def test_knot_violation_matches_jax(seed):
    jp, tp = _problems("NEGATIVE_ORTHANT")
    x, u, _ = _points("NEGATIVE_ORTHANT", seed)
    for k in range(Nk + 1):
        uk = np.zeros(m) if k == Nk else u[k]
        jconv = jal.constraint_values(jp, k, jnp.asarray(x[k]), jnp.asarray(uk))
        want = float(jal.knot_violation(jp, k, jconv))
        tconv = al.constraint_values(tp, torch.tensor([k]), torch.as_tensor(x[k])[None, :, None],
                                     torch.as_tensor(uk)[None, :, None])
        got = al.knot_violation(tp, torch.tensor([k]), tconv)
        assert got.shape == (1, 1)
        np.testing.assert_allclose(float(got[0, 0]), want, rtol=0, atol=1e-12)
