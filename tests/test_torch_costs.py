"""QuadraticCost and GenericCost of the PyTorch port against altro_tpu.

The port's costs take knot stacks (x [K, n, B], u [K, m, B], knot
indices ks); the JAX costs take one knot of one lane. At random stacks in
f64 on the CPU, every value, gradient and Hessian (lux included) of the
port's equals the JAX cost's at each (knot, lane), to 1e-12. The generic
cost's callables are written once in `jnp` and once in `torch`.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.problem import GenericCost as JGeneric  # noqa: E402
from altro_tpu.problem import QuadraticCost as JQuadratic  # noqa: E402
from altro_tpu_torch import al  # noqa: E402
from altro_tpu_torch.problem import GenericCost, Problem, QuadraticCost  # noqa: E402

N, n, m, B = 6, 3, 2, 4
KS = np.array([0, 2, 5, 1])  # stage knots, in no particular order


def _stacks(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(KS), n, B)), rng.standard_normal((len(KS), m, B))


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N + 1, n, n))
    Mu = rng.standard_normal((N + 1, m, m))
    return dict(Q=M @ M.transpose(0, 2, 1) + np.eye(n), R=Mu @ Mu.transpose(0, 2, 1) + np.eye(m),
                H=0.3 * rng.standard_normal((N + 1, m, n)), q=rng.standard_normal((N + 1, n)),
                r=rng.standard_normal((N + 1, m)), c=rng.standard_normal(N + 1))


W_X = np.array([1.0, 2.0, 0.5])


def _jstage(x, u, k):
    return (0.5 * jnp.sum(jnp.asarray(W_X) * x * x) + jnp.sin(x[0]) * u[1]
            + 0.1 * k * jnp.sum(u * u) + x[1] * x[2] * u[0])


def _jterm(x):
    return jnp.sum(jnp.cos(x)) + x[0] * x[1] * x[2]


def _tstage(x, u, k):
    w = torch.as_tensor(W_X, dtype=x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    kf = torch.as_tensor(k, dtype=x.dtype)  # an integer tensor times 0.1 would be float32
    return (0.5 * torch.sum(w * x * x, dim=0) + torch.sin(x[0]) * u[1]
            + 0.1 * kf * torch.sum(u * u, dim=0) + x[1] * x[2] * u[0])


def _tterm(x):
    return torch.sum(torch.cos(x), dim=0) + x[0] * x[1] * x[2]


def _pairs():
    qd = _quadratic()
    return {
        "quadratic": (JQuadratic(**{k: jnp.asarray(v) for k, v in qd.items()}),
                      QuadraticCost(**{k: torch.as_tensor(v) for k, v in qd.items()})),
        "generic": (JGeneric(stage=_jstage, term=_jterm), GenericCost(stage=_tstage, term=_tterm)),
    }


def _per_lane(fn, *arrays, ks=KS):
    """fn(k, x_k, u_k) at every (knot, lane) of the stacks [K, c, B] ->
    array [K, B, ...] (vmapped over lanes, then knots)."""
    lanes = jax.vmap(fn, in_axes=(None,) + (1,) * len(arrays))
    out = jax.vmap(lanes)(jnp.asarray(ks), *(jnp.asarray(a) for a in arrays))
    return np.asarray(out)


@pytest.mark.parametrize("kind", ["quadratic", "generic"])
def test_stage_value_grad_hess_match_jax(kind):
    jc, tc = _pairs()[kind]
    x, u = _stacks(1)
    ks = torch.as_tensor(KS)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)

    want_v = _per_lane(jc.stage_value, x, u)
    np.testing.assert_allclose(tc.stage_value(ks, tx, tu).numpy(), want_v, rtol=1e-12,
                               atol=1e-12)
    lx, lu = tc.stage_grad(ks, tx, tu)
    want = [_per_lane(lambda k, xi, ui, j=j: jc.stage_grad(k, xi, ui)[j], x, u)
            for j in range(2)]
    np.testing.assert_allclose(lx.permute(0, 2, 1).numpy(), want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(lu.permute(0, 2, 1).numpy(), want[1], rtol=1e-12, atol=1e-12)
    got = tc.stage_hess(ks, tx, tu)
    for j, g in enumerate(got):  # lxx, luu, lux
        w = _per_lane(lambda k, xi, ui, j=j: jc.stage_hess(k, xi, ui)[j], x, u)
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.permute(0, 3, 1, 2).numpy(), w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["quadratic", "generic"])
def test_terminal_value_grad_hess_match_jax(kind):
    jc, tc = _pairs()[kind]
    x, _ = _stacks(2)
    x = x[:1]
    tx = torch.as_tensor(x)
    ks = KS[:1]
    np.testing.assert_allclose(
        tc.term_value(tx).numpy(), _per_lane(lambda k, xi: jc.term_value(xi), x, ks=ks),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tc.term_grad(tx).permute(0, 2, 1).numpy(),
        _per_lane(lambda k, xi: jc.term_grad(xi), x, ks=ks), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tc.term_hess(tx).permute(0, 3, 1, 2).numpy(),
        _per_lane(lambda k, xi: jc.term_hess(xi), x, ks=ks), rtol=1e-12, atol=1e-12)


def test_generic_cost_keeps_float32():
    """Forward mode through torch.stack can return float64 for float32
    inputs; the cost casts back to the input dtype."""

    def stage(x, u, k):
        return torch.stack([x[0] * u[0], x[1]]).sum(dim=0) ** 2

    gc = GenericCost(stage=stage, term=lambda x: torch.stack([x[0], x[2]]).sum(dim=0) ** 2)
    x, u = (torch.as_tensor(a, dtype=torch.float32) for a in _stacks(3))
    ks = torch.as_tensor(KS)
    for t in (gc.stage_value(ks, x, u), *gc.stage_grad(ks, x, u), *gc.stage_hess(ks, x, u),
              gc.term_value(x), gc.term_grad(x), gc.term_hess(x)):
        assert t.dtype == torch.float32


@pytest.mark.parametrize("kind", ["quadratic", "generic"])
def test_dense_expansions_take_the_new_costs(kind):
    """al.diag_expansion_eligible is False for both; the dense AL Hessian
    of an unconstrained problem is the cost's own."""
    _, tc = _pairs()[kind]
    prob = Problem(N=N, n=n, m=m, dynamics=lambda x, u, h, k: x, dynamics_jac=None,
                   constraints=(), cost=tc, h=torch.full((N,), 0.1, dtype=torch.float64),
                   x0=torch.zeros(n, dtype=torch.float64))
    assert not al.diag_expansion_eligible(prob)
    x, u = (torch.as_tensor(a) for a in _stacks(4))
    ks = torch.as_tensor(KS)
    got = al.al_hess(prob, ks, x, u, (), torch.ones(B, dtype=torch.float64), terminal=False)
    for g, w in zip(got, tc.stage_hess(ks, x, u)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
