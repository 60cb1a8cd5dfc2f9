"""The port's per-lane line-search machine against `jax.vmap(wolfe_line_search)`.

`linesearch.wolfe_line_search_lanes` runs B strong-Wolfe (or sequential
backtracking) searches in lockstep on [B] tensors, each lane's transition
selected by its mode; `cubic_fit_lanes` / `cubic_argmin_lanes` are the
spline on lane tensors. Each lane here has its own analytic 1-D merit,
phi(a) = k0 + k1 a + k2 a^2 + k3 a^3 + k4 |a - k5|, from the reference's
linesearch oracles (tests/test_linesearch.py) and from a numpy seed:
quadratics and cubics (bracket, cubic first, zoom), kinks that end in
the small-window midpoint, a concave lane that hits alpha_max, an ascent
lane (NOT_DESCENT_DIRECTION), a lane that no backtracking trial
satisfies, and a lane whose merit overflows to inf, so its unused cubic
root is NaN. In f64, for the strong-Wolfe search and the sequential
backtracking, with and without cubic-first: alpha, phi, dphi, the
payload and its alpha to 1e-12, code and n_iters exact, against JAX's
vmapped search and against the port's single-lane search lane by lane.
"""

import collections

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
NAMED = {  # lane: (k0, k1, k2, k3, k4, k5)
    "quad_single_iter": (1.0, -2.0, 1.0, 0, 0, 0),  # (a - 1)^2
    "quad_off_center": (1.21, -2.2, 1.0, 0, 0, 0),  # (a - 1.1)^2
    "quad_overshoot": (0.64, -1.6, 1.0, 0, 0, 0),  # (a - 0.8)^2
    "hit_max_alpha": (-0.01, -0.2, -1.0, 0, 0, 0),  # -(a + 0.1)^2
    "cubic_1.2": (1.44 + 1.728, -2.4 - 4.32, 1.0 + 3.6, -1.0, 0, 0),  # (a-c)^2 - (a-c)^3
    "cubic_0.01": (1e-4 + 1e-6, -0.02 - 3e-4, 1.03, -1.0, 0, 0),
    "ascent": (1.0, 2.0, 1.0, 0, 0, 0),  # (a + 1)^2
    "sharp": (0.01, -2.0, 100.0, 0, 0, 0),  # 100 (a - 0.01)^2
    "never_armijo": (1.0, -1.0, 1e12, 0, 0, 0),
    "overflow": (0.0, -1.0, 1e308, 1e308, 0, 0),  # inf at a = 1
    "kink_small_window": (0.0, -1.0, 0.0, 0.0, 2.5, 2e-8),  # -a + 2.5 |a - 2e-8|
}
RANDOM_LANES = 40


def _lanes():
    """[6, B] merit coefficients: the named lanes, then seeded quadratics,
    cubics and kinks."""
    rng = np.random.default_rng(7)
    cols = [np.asarray(v, float) for v in NAMED.values()]
    for i in range(RANDOM_LANES):
        c = rng.uniform(0.005, 2.5)
        kind = i % 4
        if kind == 0:  # a (x - c)^2, either curvature
            a = rng.uniform(-1.0, 2.0)
            cols.append(np.array([a * c * c, -2 * a * c, a, 0, 0, 0]))
        elif kind == 1:  # (x - c)^2 - (x - c)^3
            cols.append(np.array([c * c + c ** 3, -2 * c - 3 * c * c, 1 + 3 * c, -1, 0, 0]))
        elif kind == 2:  # -x + k |x - c|: no Wolfe point, the window shrinks
            cols.append(np.array([0, -1.0, 0, 0, rng.uniform(1.2, 4.0), 10 ** rng.uniform(-8, 0)]))
        else:
            cols.append(np.r_[rng.standard_normal(4) * [1, 1, 3, 3], 0, 0])
    return np.stack(cols, axis=1)


K = _lanes()
B = K.shape[1]


def _phi_dphi(xp, k, a):
    phi = ((k[3] * a + k[2]) * a + k[1]) * a + k[0] + k[4] * xp.abs(a - k[5])
    dphi = (3 * k[3] * a + 2 * k[2]) * a + k[1] + k[4] * xp.sign(a - k[5])
    return phi, dphi


OPTIONS = {
    "wolfe_cubic_first": dict(try_cubic_first=True),
    "wolfe_reference": dict(try_cubic_first=False),
    "backtracking_cubic_first": dict(try_cubic_first=True, use_backtracking=True),
    "backtracking": dict(try_cubic_first=False, use_backtracking=True),
}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's vmapped search per option set, on the same lanes."""
    out = {}
    kj = jnp.asarray(K)
    for name, kw in OPTIONS.items():
        opts = jls.LineSearchOptions(**kw)

        def one(k, opts=opts):
            def full(a):
                phi, dphi = _phi_dphi(jnp, k, a)
                return phi, dphi, jnp.stack([a, phi])

            phi0, dphi0 = _phi_dphi(jnp, k, jnp.asarray(0.0))
            return jls.wolfe_line_search(full, None, phi0, dphi0, 1.0, opts,
                                         aux0=jnp.stack([jnp.asarray(0.0), phi0]))

        out[name] = jax.tree.map(np.asarray, jax.jit(jax.vmap(one, in_axes=1))(kj))
    return out


def _lane_search(kw, k=K, trace=None):
    kt = torch.as_tensor(k)
    zero = torch.zeros(kt.shape[1], dtype=torch.float64)

    def full(a):
        phi, dphi = _phi_dphi(torch, kt, a)
        return phi, dphi, torch.stack([a, phi])

    phi0, dphi0 = _phi_dphi(torch, kt, zero)
    return tls.wolfe_line_search_lanes(full, phi0, dphi0, 1.0, tls.LineSearchOptions(**kw),
                                       aux0=torch.stack([zero, phi0]), trace=trace)


def _assert_lanes_equal(t, j, aux_t, aux_j):
    np.testing.assert_array_equal(t.code.numpy(), j.code)
    np.testing.assert_array_equal(t.n_iters.numpy(), j.n_iters)
    for name in ("alpha", "phi", "dphi", "aux_alpha"):
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(j, name), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(aux_t, aux_j, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_lane_machine_matches_jax_vmapped_search(jax_runs, name):
    trace = tls.Trace()
    t = _lane_search(OPTIONS[name], trace=trace)
    j = jax_runs[name]
    _assert_lanes_equal(t, j, t.aux.numpy(), j.aux.T)
    codes = collections.Counter(t.code.tolist())
    n_iters = t.n_iters.numpy()
    lane = {n: i for i, n in enumerate(NAMED)}
    assert codes[int(CODE.MINIMUM_FOUND)] > B // 2
    assert int(t.code[lane["ascent"]]) == CODE.NOT_DESCENT_DIRECTION
    assert len(set(n_iters.tolist())) >= 4  # lanes finish at different trials
    # one loop pass per trial of the slowest lane, one host read per pass and one first
    counts = trace.counts
    assert counts["passes"] == n_iters.max() and counts["syncs"] == counts["passes"] + 1
    if OPTIONS[name].get("use_backtracking"):
        # a lane that no trial satisfies backtracks to the end: NO_ERROR after 25
        assert codes[int(CODE.NO_ERROR)] >= 1 and n_iters.max() >= 25
        exhausted = "overflow" if OPTIONS[name]["try_cubic_first"] else "never_armijo"
        assert int(t.code[lane[exhausted]]) == CODE.NO_ERROR
    else:
        assert int(t.code[lane["hit_max_alpha"]]) == CODE.HIT_MAX_STEPSIZE
        assert codes[int(CODE.WINDOW_TOO_SMALL)] >= 1  # the small-window midpoint
        assert int(t.code[lane["kink_small_window"]]) == CODE.WINDOW_TOO_SMALL
        # the overflowing lane zooms in from inf: its cubic roots are NaN, the midpoint runs
        assert np.isfinite(float(t.alpha[lane["overflow"]]))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_lane_machine_matches_single_lane_search(name):
    """Lane by lane, the port's host-scalar search (the single-lane solve's)."""
    t = _lane_search(OPTIONS[name])
    opts = tls.LineSearchOptions(**OPTIONS[name])
    for b in range(B):
        kt = torch.as_tensor(K[:, b])

        def full(a, kt=kt):
            phi, dphi = _phi_dphi(torch, kt, a)
            return phi, dphi, torch.stack([a, phi])

        zero = torch.zeros((), dtype=torch.float64)
        phi0, dphi0 = _phi_dphi(torch, kt, zero)
        h = tls.wolfe_line_search(full, None, phi0, dphi0, 1.0, opts,
                                  aux0=torch.stack([zero, phi0]))
        assert int(h.code) == int(t.code[b]) and int(h.n_iters) == int(t.n_iters[b]), b
        for field in ("alpha", "phi", "dphi", "aux_alpha"):
            np.testing.assert_allclose(float(getattr(t, field)[b]), float(getattr(h, field)),
                                       rtol=1e-12, atol=1e-12, err_msg=f"lane {b}: {field}")
        np.testing.assert_allclose(t.aux[:, b].numpy(), h.aux.numpy(), rtol=1e-12, atol=1e-12)


def test_inactive_lanes_are_left_alone():
    """Lanes outside `active` start finished and take no part: the active
    lanes' results are those of a search of the active lanes alone."""
    active = torch.as_tensor(np.arange(B) % 3 != 0)
    kt = torch.as_tensor(K)
    zero = torch.zeros(B, dtype=torch.float64)
    phi0, dphi0 = _phi_dphi(torch, kt, zero)
    opts = tls.LineSearchOptions()
    t = tls.wolfe_line_search_lanes(lambda a: _phi_dphi(torch, kt, a), phi0, dphi0, 1.0, opts,
                                    active=active)
    sub = _lane_search({}, K[:, active.numpy()])
    for name in ("alpha", "phi", "dphi", "code", "n_iters"):
        assert torch.equal(getattr(t, name)[active], getattr(sub, name)), name
    assert bool((t.n_iters[~active] == 0).all())
    assert bool((t.code[~active] == CODE.NO_ERROR).all())


def test_cubic_spline_lanes_match_jax():
    """`cubic_fit_lanes` / `cubic_argmin_lanes` on every case of the
    single-lane test at once, plus random lanes: coefficients to 1e-12,
    valid and found equal, the argmin where found."""
    rng = np.random.default_rng(3)
    cases = [(0.0, 1.2, 0.0, 1.0, 1.2, 0.0), (0.0, 0.0, 1.0, 1.0, 1.0, 1.0),
             (0.3, 0.0, -1.0, 0.7, 0.0, 1.0), (0.3, 0.0, 1.0, 0.7, 0.0, -1.0),
             (0.0, 0.0, -1.0, 1.0, 0.0, 2.0), (0.0, 0.0, -1.0, 1.0, -3.0, -10.0),
             (0.5, 1.0, 0.0, 0.5, 1.0, 0.0), (0.0, 0.0, -1.0, 1.0, np.inf, np.inf)]
    args = np.concatenate([np.asarray(cases).T, rng.standard_normal((6, 64))], axis=1)
    (jx0, ja, jb, jc, jd), j_ok = jax.vmap(jls.cubic_fit)(*jnp.asarray(args))
    j_min, j_found = jax.vmap(lambda *s: jls.cubic_argmin(s))(jx0, ja, jb, jc, jd)
    t_spline, t_ok = tls.cubic_fit_lanes(*torch.as_tensor(args))
    t_min, t_found = tls.cubic_argmin_lanes(t_spline)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    for tv, jv in zip(t_spline, (jx0, ja, jb, jc, jd)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(t_found.numpy(), np.asarray(j_found))
    f = t_found.numpy()
    np.testing.assert_allclose(t_min.numpy()[f], np.asarray(j_min)[f], rtol=1e-12, atol=1e-12)
