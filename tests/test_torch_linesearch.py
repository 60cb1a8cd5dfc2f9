"""The port's cubic spline, strong-Wolfe search and non-split grid against altro_tpu.

Every case of tests/test_linesearch.py (the reference's
linesearch_tests.cpp oracles: iteration counts, exact alpha, status
codes) through both packages in f64: `cubic_fit` / `cubic_argmin` (the
coefficients to 1e-12, found and the argmin equal, the degenerate cases
pinned) and `wolfe_line_search` with the reference's default
try_cubic_first=False and with the solver's True (alpha, code and
n_iters equal; phi and dphi to 1e-12), carrying a payload as the solve
does. `parallel_backtracking_search` (the non-split grid) on the same
merits and on one that no trial passes: alpha, code, n_iters, phi, dphi
and the payload equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu import linesearch as jls  # noqa: E402
from altro_tpu_torch import linesearch as tls  # noqa: E402
from altro_tpu_torch.status import LineSearchCode  # noqa: E402

CODE = LineSearchCode

CUBIC_CASES = {  # name: (fit arguments, valid, found, x_min or None)
    "constant_no_min": ((0.0, 1.2, 0.0, 1.0, 1.2, 0.0), True, False, None),
    "linear_no_min": ((0.0, 0.0, 1.0, 1.0, 1.0, 1.0), True, False, None),
    "positive_quadratic": ((0.3, 0.0, -1.0, 0.7, 0.0, 1.0), True, True, 0.5),
    "negative_quadratic_no_min": ((0.3, 0.0, 1.0, 0.7, 0.0, -1.0), True, False, None),
    "cubic": ((0.0, 0.0, -1.0, 1.0, 0.0, 2.0), True, True, 0.5773502691896257),
    "cubic_no_min": ((0.0, 0.0, -1.0, 1.0, -3.0, -10.0), True, False, None),
    "same_point_invalid": ((0.5, 1.0, 0.0, 0.5, 1.0, 0.0), False, None, None),
}


@pytest.mark.parametrize("name", list(CUBIC_CASES))
def test_cubic_spline_matches_jax(name):
    args, valid, found, x_min = CUBIC_CASES[name]
    j_spline, j_ok = jls.cubic_fit(*args)
    t_spline, t_ok = tls.cubic_fit(*args)
    assert bool(t_ok) == bool(j_ok) == valid
    np.testing.assert_allclose([float(v) for v in t_spline], [float(v) for v in j_spline],
                               rtol=1e-12, atol=0)
    if not valid:
        return
    j_x, j_found = jls.cubic_argmin(j_spline)
    t_x, t_found = tls.cubic_argmin(t_spline)
    assert bool(t_found) == bool(j_found) == found
    if found:
        np.testing.assert_allclose(float(t_x), float(j_x), rtol=1e-12)
        np.testing.assert_allclose(float(t_x), x_min, atol=1e-10)


def _merit(kind, *p):
    """(phi, dphi) as functions of alpha, for jnp and torch alike."""
    if kind == "quad":
        a, c = p
        return (lambda x: a * (x - c) ** 2, lambda x: 2 * a * (x - c))
    if kind == "cubic":
        (c,) = p
        return (lambda x: (x - c) ** 2 - (x - c) ** 3,
                lambda x: 2 * (x - c) - 3 * (x - c) ** 2)
    if kind == "ascent":
        return (lambda x: (x + 1.0) ** 2, lambda x: 2 * (x + 1.0))
    if kind == "sharp":
        return (lambda x: 100.0 * (x - 0.01) ** 2, lambda x: 200.0 * (x - 0.01))
    # "never": no trial of the grid (4 blocks of 8, down to 2^-31) meets Armijo
    return (lambda x: 1.0 - x + 1e12 * x * x, lambda x: -1.0 + 2e12 * x)


# name: (merit, option overrides, the reference oracle with try_cubic_first=False:
# n_iters or None, alpha, alpha rtol, code or None)
WOLFE_CASES = {
    "quadratic_single_iter": (("quad", 1.0, 1.0), {}, (1, 1.0, 0, CODE.MINIMUM_FOUND)),
    "quadratic_off_center_loose": (("quad", 1.0, 1.1), {}, (1, 1.0, 0, CODE.MINIMUM_FOUND)),
    "quadratic_tight_curvature": (("quad", 1.0, 1.1), dict(c2=0.01),
                                  (3, 1.1, 1e-10, CODE.MINIMUM_FOUND)),
    "quadratic_overshoot": (("quad", 1.0, 0.8), dict(c2=0.1),
                            (None, 0.8, 1e-10, CODE.MINIMUM_FOUND)),
    "hit_max_alpha": (("quad", -1.0, -0.1), dict(c2=0.9), (3, 2.0, 0, CODE.HIT_MAX_STEPSIZE)),
    "cubic_single_iter": (("cubic", 1.0), {}, (1, 1.0, 0, None)),
    "cubic_1.2": (("cubic", 1.2), dict(c2=1e-3), (3, 1.2, 1e-6, CODE.MINIMUM_FOUND)),
    "cubic_1.8": (("cubic", 1.8), dict(c2=0.01), (4, 1.8, 1e-6, CODE.MINIMUM_FOUND)),
    "cubic_0.8": (("cubic", 0.8), dict(c2=0.01), (2, 0.8, 1e-6, CODE.MINIMUM_FOUND)),
    "cubic_0.01": (("cubic", 0.01), dict(c2=0.01), (2, 0.01, 1e-4, CODE.MINIMUM_FOUND)),
    "not_descent_direction": (("ascent",), {}, (0, 0.0, 0, CODE.NOT_DESCENT_DIRECTION)),
    "backtracking": (("sharp",), dict(use_backtracking=True),
                     (None, None, None, CODE.MINIMUM_FOUND)),
}


def _search(pkg, merit, overrides, try_cubic, grid=False, lazy=False):
    """One search of package pkg ("jax" or "torch") with a payload
    [alpha, phi] carried from alpha = 0; lazy: the port's backtracking
    trials through merit_light / complete."""
    phi_fn, dphi_fn = _merit(*merit)
    if pkg == "jax":
        xp, ls, zero = jnp, jls, jnp.asarray(0.0)
    else:
        xp, ls, zero = torch, tls, torch.tensor(0.0, dtype=torch.float64)
    opts = ls.LineSearchOptions(**{"try_cubic_first": try_cubic, **overrides})

    def full(a):
        return phi_fn(a), dphi_fn(a), xp.stack([a, phi_fn(a)])

    phi0, dphi0 = phi_fn(zero), dphi_fn(zero)
    aux0 = xp.stack([zero, phi0])
    if grid:
        return ls.parallel_backtracking_search(full, phi0, dphi0, 1.0, opts, aux0=aux0, width=8)
    if lazy:
        return ls.wolfe_line_search(
            full, None, phi0, dphi0, 1.0, opts, aux0=aux0,
            merit_light=lambda a: (phi_fn(a), a),
            complete=lambda a: (dphi_fn(a), xp.stack([a, phi_fn(a)])))
    return ls.wolfe_line_search(full, None, phi0, dphi0, 1.0, opts, aux0=aux0)


def _assert_same(t, j):
    assert int(t.code) == int(j.code)
    assert int(t.n_iters) == int(j.n_iters)
    np.testing.assert_allclose(float(t.alpha), float(j.alpha), rtol=1e-15, atol=0)
    np.testing.assert_allclose(float(t.phi), float(j.phi), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(float(t.dphi), float(j.dphi), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(float(t.aux_alpha), float(j.aux_alpha), rtol=1e-15, atol=0)
    np.testing.assert_allclose(t.aux.numpy(), np.asarray(j.aux), rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("try_cubic", [False, True], ids=["reference", "cubic_first"])
@pytest.mark.parametrize("name", list(WOLFE_CASES))
def test_wolfe_search_matches_jax(name, try_cubic):
    merit, overrides, (n_iters, alpha, rtol, code) = WOLFE_CASES[name]
    j = _search("jax", merit, overrides, try_cubic)
    t = _search("torch", merit, overrides, try_cubic)
    _assert_same(t, j)
    if try_cubic:
        return
    if n_iters is not None:
        assert int(t.n_iters) == n_iters
    if code is not None:
        assert int(t.code) == code
    if alpha is not None:
        np.testing.assert_allclose(float(t.alpha), alpha, rtol=rtol, atol=0 if rtol else 0)
    if name == "backtracking":  # halves from 0.5 until sufficient decrease
        phi = _merit(*merit)[0]
        assert float(t.alpha) <= 0.5 and phi(float(t.alpha)) <= phi(0.0)


GRID_CASES = ["quadratic_tight_curvature", "quadratic_overshoot", "hit_max_alpha", "cubic_1.8",
              "not_descent_direction", "backtracking", "never_armijo"]


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_search_matches_jax(name):
    merit, overrides, _ = WOLFE_CASES.get(name, (("never",), {}, None))
    j = _search("jax", merit, overrides, False, grid=True)
    t = _search("torch", merit, overrides, False, grid=True)
    _assert_same(t, j)
    if name == "never_armijo":  # every trial fails: the first of the last block
        assert int(t.code) == CODE.NO_ERROR and int(t.n_iters) == 25
        assert float(t.alpha) == 0.5 ** 24 and np.isnan(float(t.aux_alpha))


@pytest.mark.parametrize("name", ["backtracking", "never_armijo", "cubic_1.8", "quadratic_overshoot"])
def test_lazy_backtracking_matches_jax(name):
    """The backtracking mode with light trials (merit_light, then complete
    on the trial that ends the search) returns what JAX's full evaluation
    of every trial returns: the accepted step, and on exhaustion the
    last trial's payload."""
    merit, _, _ = WOLFE_CASES.get(name, (("never",), {}, None))
    j = _search("jax", merit, dict(use_backtracking=True), False)
    t = _search("torch", merit, dict(use_backtracking=True), False, lazy=True)
    _assert_same(t, j)
    if name == "never_armijo":
        assert int(t.code) == CODE.NO_ERROR and int(t.n_iters) == 25
