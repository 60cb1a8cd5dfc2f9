"""Options, status codes and cones of the PyTorch port against altro_tpu.

Counterparts: altro_tpu/options.py, altro_tpu/status.py, altro_tpu/cones.py.
The cone goldens are those of tests/test_cones.py (re-hosted from the C++
reference suite), held to 1e-10.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu import cones as jc  # noqa: E402
from altro_tpu import options as jo  # noqa: E402
from altro_tpu import status as js  # noqa: E402
from altro_tpu_torch import cones as tc  # noqa: E402
from altro_tpu_torch import options as to  # noqa: E402
from altro_tpu_torch import status as ts  # noqa: E402

X = np.array([0.1, -0.5, 0.2, 0.0])
B = np.array([10.0, 20.0, -30.0, 40.0])
MAG = np.linalg.norm(X)


def soc_point(scale):
    x = X.copy()
    x[-1] = MAG * scale
    return torch.as_tensor(x)


def test_solver_options_fields_and_defaults_match():
    jf = {f.name: f for f in dataclasses.fields(jo.SolverOptions)}
    tf = {f.name: f for f in dataclasses.fields(to.SolverOptions)}
    assert list(jf) == list(tf)
    jd, td = jo.SolverOptions(), to.SolverOptions()
    for name in jf:
        a, b = getattr(jd, name), getattr(td, name)
        if isinstance(a, jo.Verbosity):
            assert int(a) == int(b) and a.name == b.name
        else:
            assert a == b or (a != a and b != b), name
    assert td.replace(iterations_max=3).iterations_max == 3


@pytest.mark.parametrize("name", ["SolveStatus", "ErrorCode"])
def test_status_enums_match(name):
    a, b = getattr(js, name), getattr(ts, name)
    assert [(m.name, int(m)) for m in a] == [(m.name, int(m)) for m in b]


def test_verbosity_enum_matches():
    assert [(m.name, int(m)) for m in jo.Verbosity] == [(m.name, int(m)) for m in to.Verbosity]


PROJECTION_GOLDENS = [
    (tc.Cone.ZERO, torch.as_tensor(X), np.zeros(4)),
    (tc.Cone.NEGATIVE_ORTHANT, torch.as_tensor(X), [0.0, -0.5, 0.0, 0.0]),
    (tc.Cone.IDENTITY, torch.as_tensor(X), X),
    (tc.Cone.SECOND_ORDER, soc_point(1.1), soc_point(1.1).numpy()),
    (tc.Cone.SECOND_ORDER, soc_point(-1.1), np.zeros(4)),
    (tc.Cone.SECOND_ORDER, soc_point(0.9), [0.095, -0.475, 0.19, 0.5203364296299079]),
    (tc.Cone.SECOND_ORDER, torch.tensor([0.0, 0.0, 0.0, 0.5], dtype=torch.float64),
     [0.0, 0.0, 0.0, 0.5]),
    (tc.Cone.SECOND_ORDER, torch.tensor([0.0, 0.0, 0.0, -0.5], dtype=torch.float64),
     np.zeros(4)),
]


@pytest.mark.parametrize("case", range(len(PROJECTION_GOLDENS)))
def test_projection_goldens(case):
    cone, x, expected = PROJECTION_GOLDENS[case]
    np.testing.assert_allclose(tc.project(cone, x).numpy(), expected, atol=1e-10)


SOC_JAC_OUT = np.array([
    [0.9349999999999999, 0.07499999999999998, -0.029999999999999995, 0.09128709291752768],
    [0.07499999999999998, 0.5750000000000001, 0.14999999999999997, -0.4564354645876384],
    [-0.029999999999999995, 0.14999999999999997, 0.89, 0.18257418583505536],
    [0.09128709291752768, -0.45643546458763834, 0.18257418583505536, 0.5],
])
SOC_HESS_OUT = np.array([
    [52.54767592811069, 21.83580619450183, -5.434322477800736, 13.69306393762915],
    [21.83580619450183, 2.3358061945018775, 6.1716123890036805, -4.564354645876377],
    [-5.434322477800736, 6.1716123890036805, 63.146192211409584, -18.257418583505533],
    [13.69306393762915, -4.564354645876377, -18.257418583505533, 0.0],
])
JACOBIAN_GOLDENS = [
    (tc.Cone.ZERO, torch.as_tensor(X), np.zeros((4, 4))),
    (tc.Cone.IDENTITY, torch.as_tensor(X), np.eye(4)),
    (tc.Cone.NEGATIVE_ORTHANT, torch.as_tensor(X), np.diag([0.0, 1.0, 0.0, 1.0])),
    (tc.Cone.SECOND_ORDER, soc_point(1.1), np.eye(4)),
    (tc.Cone.SECOND_ORDER, soc_point(-1.1), np.zeros((4, 4))),
    (tc.Cone.SECOND_ORDER, soc_point(0.9), SOC_JAC_OUT),
]


@pytest.mark.parametrize("case", range(len(JACOBIAN_GOLDENS)))
def test_jacobian_goldens(case):
    cone, x, expected = JACOBIAN_GOLDENS[case]
    np.testing.assert_allclose(tc.project_jacobian(cone, x).numpy(), expected, atol=1e-10)


@pytest.mark.parametrize("scale", [1.1, -1.1, 0.9])
def test_soc_hessian_goldens(scale):
    hess = tc.project_hessian(tc.Cone.SECOND_ORDER, soc_point(scale), torch.as_tensor(B))
    expected = SOC_HESS_OUT if scale == 0.9 else np.zeros((4, 4))
    np.testing.assert_allclose(hess.numpy(), expected, atol=1e-10)
    np.testing.assert_allclose(hess.numpy(), hess.numpy().T, atol=1e-10)


@pytest.mark.parametrize("cone", list(tc.Cone))
def test_batched_matches_jax(cone):
    """Lane-batched projections equal the vmapped JAX ones (f64)."""
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((64, 4))
    bs = rng.standard_normal((64, 4))
    jcone = jc.Cone(cone.value)
    jx, jb = jnp.asarray(xs), jnp.asarray(bs)
    tx, tb = torch.as_tensor(xs.T), torch.as_tensor(bs.T)  # component-first [4, 64]
    np.testing.assert_allclose(
        tc.project(cone, tx).numpy().T,
        np.asarray(jax.vmap(lambda v: jc.project(jcone, v))(jx)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.moveaxis(tc.project_jacobian(cone, tx).numpy(), -1, 0),
        np.asarray(jax.vmap(lambda v: jc.project_jacobian(jcone, v))(jx)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.moveaxis(tc.project_hessian(cone, tx, tb).numpy(), -1, 0),
        np.asarray(jax.vmap(lambda v, w: jc.project_hessian(jcone, v, w))(jx, jb)),
        rtol=1e-10, atol=1e-10)
    assert tc.dual_cone(cone).value == jc.dual_cone(jcone).value
    assert tc.cone_is_linear(cone) == jc.cone_is_linear(jcone)
