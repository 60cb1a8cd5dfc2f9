"""Line searches (PyTorch port): one lane's, and B lanes' in lockstep.

Counterpart: altro_tpu/linesearch.py (`LineSearchOptions`,
`LineSearchResult`, `cubic_fit`, `cubic_argmin`, `wolfe_line_search`,
`parallel_backtracking_search`, `parallel_backtracking_search_split`).

* `wolfe_line_search`: the JAX `lax.while_loop` over the `_State` machine
  (bracket, one-shot cubic, zoom with the small-window midpoint, the
  sequential backtracking mode) becomes a Python loop with one host read
  per trial (phi and dphi of the merit evaluation). The decisions run on
  host scalars of the merit's dtype (numpy), in JAX's order, every
  constant cast to that dtype first, so an f64 search takes JAX's path
  trial for trial and an f32 one rounds as JAX's f32 search does.
* `wolfe_line_search_lanes`: the same machine under `jax.vmap`, for the
  batched solves: B lanes in lockstep on [B] tensors, each lane's
  transition selected by its mode, with `cubic_fit_lanes` /
  `cubic_argmin_lanes`, the spline on lane tensors; one host read per
  loop pass (the lanes' mode counts).
* `Trace`: the batched solve's host-side instrumentation (seconds by
  layer, host reads, machine passes, per-lane trials), one object that
  the lane machine, `tile_iter.retry_tiled` and `tile_solver.lane_loop`
  share.
* The grid searches: the JAX `lax.while_loop` over grid blocks becomes a
  Python loop with one host sync per block beyond the first (on
  `found`).
* `LineSearchOptions.verbose` prints the JAX searches' traces from the
  host, with their format strings: the strong-Wolfe search's start
  banner and one line a trial, the grid's one line a block.

Scalars returned are 0-dim tensors on the merit's device and dtype; a
payload is a tensor, a (named) tuple of payloads, or None.
"""

from __future__ import annotations

import math
import time
import types
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from altro_tpu_torch.status import LineSearchCode

__all__ = [
    "LineSearchOptions",
    "search_options",
    "LineSearchResult",
    "cubic_fit",
    "cubic_argmin",
    "wolfe_line_search",
    "parallel_backtracking_search",
    "parallel_backtracking_search_split",
    "cubic_fit_lanes",
    "cubic_argmin_lanes",
    "wolfe_line_search_lanes",
    "lane_modes",
    "LaneConstants",
    "lane_constants",
    "lanes_start",
    "lanes_pass",
    "lanes_result",
    "Trace",
    "tree_map",
]

_TOL = 1e-6  # cubicspline.c LINESEARCH_TOL, as in the JAX module


class Trace:
    """Host-side instrumentation of a batched solve. `seconds`: host
    seconds by layer, each `lap` adding the time since the previous one
    (`tile_solver.lane_loop` names the layers). `counts`: "syncs" (host
    reads, each through `read`), "passes" (the lane machine's loop
    passes, which every lane pays) and, in the vmapped solve, "trials"
    ([B], each lane's line-search trials, summed over its iterations)."""

    __slots__ = ("seconds", "counts", "t0")

    def __init__(self, seconds: Optional[dict] = None):
        self.seconds = {} if seconds is None else seconds
        self.counts = {}
        self.t0 = time.perf_counter()

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def lap(self, name: str) -> None:
        t = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self.t0
        self.t0 = t

    def add(self, name: str, k=1) -> None:
        self.counts[name] = self.counts.get(name, 0) + k

    def read(self, t: torch.Tensor):
        """t.tolist() (a bool for a 0-dim flag): one host read, counted."""
        self.add("syncs")
        return t.tolist()


class LineSearchOptions(NamedTuple):
    c1: float = 1e-4
    c2: float = 0.9
    max_iters: int = 25
    alpha_max: float = 2.0
    beta_increase: float = 1.5
    beta_decrease: float = 0.5
    min_interval_size: float = 1e-6
    try_cubic_first: bool = True
    use_backtracking: bool = False
    armijo_slack: float = 0.0
    verbose: bool = False


def search_options(opts, verbose: bool = False) -> LineSearchOptions:
    """The line-search options of a `SolverOptions` (its ls_* fields and
    use_backtracking_linesearch); verbose: print the searches' traces."""
    return LineSearchOptions(
        c1=opts.ls_c1, c2=opts.ls_c2, max_iters=opts.ls_max_iters,
        alpha_max=opts.ls_alpha_max, beta_increase=opts.ls_beta_increase,
        beta_decrease=opts.ls_beta_decrease, min_interval_size=opts.ls_min_interval_size,
        try_cubic_first=opts.ls_try_cubic_first,
        use_backtracking=opts.use_backtracking_linesearch,
        armijo_slack=opts.ls_armijo_slack, verbose=verbose)


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor
    phi: torch.Tensor
    dphi: torch.Tensor
    code: torch.Tensor  # int32 LineSearchCode
    n_iters: torch.Tensor  # merit evaluations the sequential search would make
    aux: object = ()  # payload of the accepted step
    aux_alpha: object = float("nan")  # alpha of that payload


def tree_map(fn, tree, *rest):
    """Apply fn leaf by leaf over tensors in (named) tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def _stack(trees):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _where(cond, a, b):
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


# ---------------------------------------------------------------------------
# Host scalars and the cubic spline
# ---------------------------------------------------------------------------

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}
_TORCH_FLOAT = {np.float32: torch.float32, np.float64: torch.float64}


def _host_type(v):
    """numpy float type of a value: a tensor's or a numpy scalar's dtype,
    float64 for a Python number (JAX's x64 default)."""
    if torch.is_tensor(v):
        return _NP_FLOAT.get(v.dtype, np.float64)
    if isinstance(v, np.generic) and np.issubdtype(v.dtype, np.floating):
        return v.dtype.type
    return np.float64


def _host(v, dt):
    return dt(v.item() if torch.is_tensor(v) else float(v))


def _scalars(*vals):
    """(dt, the values as host scalars of dt): dt promotes the dtypes of
    the typed values (tensors, numpy scalars); Python numbers are weak."""
    typed = [_host_type(v) for v in vals if torch.is_tensor(v) or isinstance(v, np.generic)]
    dt = np.result_type(*typed).type if typed else np.float64
    return dt, [_host(v, dt) for v in vals]


def _fit(dt, x1, y1, d1, x2, y2, d2):
    delta = x2 - x1
    same = bool(abs(delta) < dt(_TOL))
    ds = dt(1.0) if same else delta
    c = dt(3.0) * (y2 - y1) / (ds * ds) - (d2 + dt(2.0) * d1) / ds
    d = (d2 + d1) / (ds * ds) - dt(2.0) * (y2 - y1) / (ds * ds * ds)
    return (x1, y1, d1, c, d), not same


def _argmin(dt, spline):
    x0, _, b, c, d = spline
    tol = dt(_TOL)
    is_quadratic = bool(abs(d) < tol)
    is_linear = is_quadratic and bool(abs(c) < tol)

    # quadratic path
    c_safe = dt(1.0) if abs(c) < tol else c
    quad_min = -b / (dt(2.0) * c_safe) + x0
    quad_found = is_quadratic and not is_linear and bool(c > 0)

    # cubic path: roots of 3d t^2 + 2c t + b = 0
    qa, qb, qc = dt(3.0) * d, dt(2.0) * c, b
    qa_safe = dt(1.0) if abs(qa) < tol else qa
    s2 = qb * qb - dt(4.0) * qa * qc
    s2_zero = bool(abs(s2) < tol)
    s = dt(0.0) if s2_zero else np.sqrt(np.maximum(s2, dt(0.0)))
    roots_ok = s2_zero or bool(s2 >= 0)
    t1 = (-qb + s) / (dt(2.0) * qa_safe)
    t2 = (-qb - s) / (dt(2.0) * qa_safe)
    curv1 = dt(2.0) * c + dt(6.0) * d * t1
    curv2 = dt(2.0) * c + dt(6.0) * d * t2
    pick1 = bool(curv1 > 0) and bool(curv2 < 0)
    pick2 = bool(curv1 < 0) and bool(curv2 > 0)
    cubic_min = (t1 if pick1 else t2) + x0
    cubic_found = not is_quadratic and roots_ok and (pick1 or pick2)
    return (quad_min if is_quadratic else cubic_min), quad_found or cubic_found


def cubic_fit(x1, y1, d1, x2, y2, d2):
    """Fit y = a + b t + c t^2 + d t^3, t = x - x1, from two points and
    their slopes. Returns ((x0, a, b, c, d), valid) as host scalars;
    valid is False when the two points coincide (|x2 - x1| < 1e-6)."""
    dt, v = _scalars(x1, y1, d1, x2, y2, d2)
    with np.errstate(all="ignore"):
        return _fit(dt, *v)


def cubic_argmin(spline):
    """Closed-form argmin of a `cubic_fit` spline. Returns (x_min, found);
    found is False for every case without a minimum (constant, linear,
    concave quadratic, saddle, no real root)."""
    dt, v = _scalars(*spline)
    with np.errstate(all="ignore"):
        return _argmin(dt, v)


# ---------------------------------------------------------------------------
# Strong-Wolfe cubic line search
# ---------------------------------------------------------------------------

_BRACKET, _CUBIC, _ZOOM, _BACKTRACK, _DONE = range(5)


def _read(dt, *vals):
    """Host values of scalars as dt: the tensors among them in one device
    read (in the first tensor's dtype), Python numbers as they are."""
    ts = [v for v in vals if torch.is_tensor(v)]
    got = iter(torch.stack([v.reshape(()).to(ts[0].dtype) for v in ts]).tolist() if ts else ())
    return [dt(next(got)) if torch.is_tensor(v) else dt(float(v)) for v in vals]


def wolfe_line_search(
    merit_full: Callable,
    merit_value: Optional[Callable],
    phi0,
    dphi0,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    aux0=None,
    *,
    merit_light: Optional[Callable] = None,
    complete: Optional[Callable] = None,
) -> LineSearchResult:
    """Run the strong-Wolfe line search on the merit function phi(alpha).

    merit_full(alpha) -> (phi, dphi) or (phi, dphi, aux), alpha a 0-dim
    tensor of the merit's dtype on its device; merit_value is accepted
    and not called (as in JAX, every mode evaluates merit_full, which
    keeps the payload valid in the backtracking mode too). With aux0 the
    payload of the LAST evaluation is carried and returned (`aux`, valid
    at `aux_alpha`), so the caller reuses the accepted step's trajectory
    instead of evaluating it again. One host read per trial.

    merit_light(alpha) -> (phi, light) and complete(light) -> (dphi, aux),
    together: the backtracking mode, whose test reads phi alone, then
    evaluates each trial with merit_light and completes only the trial it
    accepts, or its last when it gives up (the reference's value-only
    backtracking, linesearch.cpp:385-412). Every value the search returns
    is the one merit_full would give.
    """
    del merit_value
    dt = _host_type(phi0)
    dev = phi0.device if torch.is_tensor(phi0) else torch.device("cpu")
    tdt = _TORCH_FLOAT[dt]
    phi0, dphi0 = _read(dt, phi0, dphi0)
    alpha0 = _host(alpha0, dt)
    c1, c2, slack = dt(opts.c1), dt(opts.c2), dt(opts.armijo_slack)
    beta_inc, beta_dec = dt(opts.beta_increase), dt(opts.beta_decrease)
    alpha_max, min_interval = dt(opts.alpha_max), dt(opts.min_interval_size)
    zero, half = dt(0.0), dt(0.5)
    has_aux = aux0 is not None

    s = types.SimpleNamespace(
        mode=_BRACKET, alpha_next=alpha0, aux=aux0 if has_aux else (), aux_alpha=dt(np.nan),
        small_window=False, n_iters=0, iter=0, zoom_iter=0, btr_iter=0,
        alpha=alpha0, phi=phi0, dphi=dphi0, fnd=False,
        alpha_prev=zero, phi_prev=phi0, dphi_prev=dphi0,
        alo=zero, ahi=zero, phi_lo=phi0, phi_hi=phi0, dphi_lo=dphi0, dphi_hi=dphi0,
        hit_max_alpha=False, code=int(LineSearchCode.NO_ERROR),
        res_alpha=zero, res_phi=phi0, res_dphi=dphi0)

    def done(code, alpha, phi, dphi):
        s.mode, s.code = _DONE, int(code)
        s.res_alpha, s.res_phi, s.res_dphi = alpha, phi, dphi

    def armijo(alpha, phi):
        return bool(phi <= phi0 + c1 * alpha * dphi0 + slack * abs(phi0))

    def wolfe(dphi):
        return bool(abs(dphi) <= -c2 * dphi0)

    def zoom_trial(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi):
        """Next zoom trial: cubic argmin, else midpoint; tiny window -> midpoint."""
        small = bool(abs(alo - ahi) < min_interval)
        spline, fit_ok = _fit(dt, alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi)
        amin, found = _argmin(dt, spline)
        mid = half * (alo + ahi)
        use_cubic = fit_ok and found and bool(np.isfinite(amin))
        return (mid if small or not use_cubic else amin), small

    def enter_zoom(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi):
        """Transition into the zoom stage (linesearch.cpp:233-303)."""
        nonfinite = not (np.isfinite(alo) and np.isfinite(ahi))
        s.zoom_iter = s.n_iters + 1
        s.alpha_next, s.small_window = zoom_trial(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi)
        s.mode = _ZOOM
        s.alo, s.ahi, s.phi_lo, s.phi_hi, s.dphi_lo, s.dphi_hi = (
            alo, ahi, phi_lo, phi_hi, dphi_lo, dphi_hi)
        if s.zoom_iter >= opts.max_iters:
            done(LineSearchCode.MAX_ITERATIONS, alo, phi_lo, dphi_lo)
        if nonfinite:
            done(LineSearchCode.GOT_NONFINITE_STEP_SIZE, zero, s.phi, s.dphi)

    def post_check(alpha, phi, dphi, fnd):
        """Bracket-stage logic after the Wolfe test fails (linesearch.cpp:
        137-213): the backtracking fallback, the two zoom entries, or the
        interval expansion with its alpha_max handling."""
        if opts.use_backtracking:
            s.mode, s.alpha_next, s.btr_iter = _BACKTRACK, alpha0 * beta_dec, 1
            return
        if not armijo(alpha, phi) or (s.iter > 0 and fnd):
            enter_zoom(s.alpha_prev, s.phi_prev, s.dphi_prev, alpha, phi, dphi)
        elif dphi >= 0:  # the "bowl": alo = current, ahi = previous
            enter_zoom(alpha, phi, dphi, s.alpha_prev, s.phi_prev, s.dphi_prev)
        else:
            new_alpha = alpha * beta_inc
            over = bool(new_alpha > alpha_max)
            new_alpha = np.minimum(new_alpha, alpha_max)
            stop = over and s.hit_max_alpha
            s.alpha_prev, s.phi_prev, s.dphi_prev = alpha, phi, dphi
            s.alpha_next, s.hit_max_alpha, s.iter = new_alpha, s.hit_max_alpha or over, s.iter + 1
            if stop:
                done(LineSearchCode.HIT_MAX_STEPSIZE, new_alpha, phi, dphi)
            if s.iter >= opts.max_iters:  # bracket loop exhausted
                done(s.code, new_alpha, phi, dphi)

    def bracket_step(phi_t, dphi_t):
        alpha = s.alpha_next
        s.n_iters += 1
        fnd = bool(phi_t >= s.phi_prev)
        s.alpha, s.phi, s.dphi, s.fnd = alpha, phi_t, dphi_t, fnd
        if armijo(alpha, phi_t) and wolfe(dphi_t):
            return done(LineSearchCode.MINIMUM_FOUND, alpha, phi_t, dphi_t)
        # one-shot cubic interpolation on the first interval
        spline, fit_ok = _fit(dt, zero, phi0, dphi0, alpha, phi_t, dphi_t)
        amin, found = _argmin(dt, spline)
        if (opts.try_cubic_first and s.iter == 0 and fit_ok and found
                and bool(np.isfinite(amin))):
            s.mode, s.alpha_next, s.iter = _CUBIC, amin, s.iter + 1
        else:
            post_check(alpha, phi_t, dphi_t, fnd)

    def cubic_step(phi_t, dphi_t):
        alpha_c = s.alpha_next
        s.n_iters += 1
        if armijo(alpha_c, phi_t) and wolfe(dphi_t):
            return done(LineSearchCode.MINIMUM_FOUND, alpha_c, phi_t, dphi_t)
        post_check(s.alpha, s.phi, s.dphi, s.fnd)  # back to the saved first trial

    def zoom_step(phi_t, dphi_t):
        alpha = s.alpha_next
        s.n_iters += 1
        suff, curv = armijo(alpha, phi_t), wolfe(dphi_t)
        if s.small_window:
            code = LineSearchCode.MINIMUM_FOUND if suff and curv else (
                LineSearchCode.WINDOW_TOO_SMALL)
            return done(code, alpha, phi_t, dphi_t)
        if suff and curv:
            return done(LineSearchCode.MINIMUM_FOUND, alpha, phi_t, dphi_t)
        if not suff or bool(phi_t > s.phi_lo):
            s.ahi, s.phi_hi, s.dphi_hi = alpha, phi_t, dphi_t
        else:
            if bool(dphi_t * (s.ahi - s.alo) <= 0):
                s.ahi, s.phi_hi, s.dphi_hi = s.alo, s.phi_lo, s.dphi_lo
            s.alo, s.phi_lo, s.dphi_lo = alpha, phi_t, dphi_t
        s.zoom_iter += 1
        s.alpha_next, s.small_window = zoom_trial(s.alo, s.phi_lo, s.dphi_lo, s.ahi,
                                                  s.phi_hi, s.dphi_hi)
        if s.zoom_iter >= opts.max_iters:
            done(LineSearchCode.MAX_ITERATIONS, alpha, phi_t, dphi_t)

    def backtrack_step(phi_t, dphi_t, finish=None):
        """finish() -> (dphi, aux): the completion of a light trial, run
        for the trial that ends the search."""
        alpha = s.alpha_next
        s.n_iters += 1
        accept = armijo(alpha, phi_t)
        if finish is not None and (accept or s.btr_iter + 1 >= opts.max_iters):
            dphi_t, s.aux = finish()
            s.aux_alpha = alpha
        if accept:
            return done(LineSearchCode.MINIMUM_FOUND, alpha, phi_t, dphi_t)
        new_alpha = alpha * beta_dec
        s.alpha_next, s.btr_iter = new_alpha, s.btr_iter + 1
        if s.btr_iter >= opts.max_iters:
            done(s.code, new_alpha, phi_t, s.res_dphi)

    steps = (bracket_step, cubic_step, zoom_step, backtrack_step)
    if dphi0 >= 0:  # not a descent direction: alpha = 0 (linesearch.cpp:49-52)
        done(LineSearchCode.NOT_DESCENT_DIRECTION, zero, phi0, dphi0)
    lazy = merit_light is not None and complete is not None

    def finisher(light):
        def finish():
            dphi_t, aux_t = complete(light)
            return _read(dt, dphi_t)[0], aux_t
        return finish

    def trace(alpha, phi, dphi):  # linesearch.cpp:70-73's trial trace
        if opts.verbose:
            print(f"    ls trial {s.n_iters}: alpha = {float(alpha):.6}, phi = {float(phi):.8}, "
                  f"dphi = {float(dphi):.6}")

    if opts.verbose:  # linesearch.cpp:70-73's start banner
        print(f"  Starting Cubic Line Search with phi0 = {float(phi0):.8}, "
              f"dphi0 = {float(dphi0):.6}")
    with np.errstate(all="ignore"):
        while s.mode != _DONE:
            a_t = s.alpha_next
            alpha_t = torch.tensor(float(a_t), dtype=tdt, device=dev)
            if lazy and s.mode == _BACKTRACK:
                phi_t, light = merit_light(alpha_t)
                phi_t = _read(dt, phi_t)[0]
                trace(a_t, phi_t, np.nan)  # a backtracking trial forms no dphi until it ends
                backtrack_step(phi_t, None, finisher(light))
                continue
            out = merit_full(alpha_t)
            if has_aux:
                phi_t, dphi_t, aux_t = out
            else:
                (phi_t, dphi_t), aux_t = out[:2], ()
            phi_t, dphi_t = _read(dt, phi_t, dphi_t)
            trace(a_t, phi_t, dphi_t)
            s.aux, s.aux_alpha = aux_t, a_t
            steps[s.mode](phi_t, dphi_t)

    vals = torch.tensor([float(v) for v in (s.res_alpha, s.res_phi, s.res_dphi, s.aux_alpha)],
                        dtype=tdt, device=dev)
    ints = torch.tensor([s.code, s.n_iters], dtype=torch.int32, device=dev)
    return LineSearchResult(alpha=vals[0], phi=vals[1], dphi=vals[2], code=ints[0],
                            n_iters=ints[1], aux=s.aux, aux_alpha=vals[3])


# ---------------------------------------------------------------------------
# Lane tensors: the cubic spline and the strong-Wolfe machine, per lane
# ---------------------------------------------------------------------------


class _Fills(dict):
    """int32 [B] fills by value, each made at its first use."""

    def __init__(self, Bsz: int, device):
        super().__init__()
        self._shape, self._device = (Bsz,), device

    def __missing__(self, v):
        t = self[v] = torch.full(self._shape, v, dtype=torch.int32, device=self._device)
        return t


class LaneConstants(NamedTuple):
    """The lane machine's constants, made once a search: the options'
    numbers and the spline's as 0-dim tensors of the merit's dtype, zero
    and alpha0 per lane [B], and the int32 fills [B] of modes and codes
    (`ints[v]`). On the card each 0-dim tensor is a host-to-device copy,
    so a pass makes none."""

    c1: torch.Tensor
    c2: torch.Tensor
    slack: torch.Tensor
    beta_inc: torch.Tensor
    beta_dec: torch.Tensor
    alpha_max: torch.Tensor
    min_interval: torch.Tensor
    z: torch.Tensor
    half: torch.Tensor
    one: torch.Tensor
    two: torch.Tensor
    three: torch.Tensor
    four: torch.Tensor
    six: torch.Tensor
    tol: torch.Tensor
    zero: torch.Tensor
    alpha0: torch.Tensor
    ints: dict


def lane_constants(phi0: torch.Tensor, alpha0=1.0,
                   opts: LineSearchOptions = LineSearchOptions()) -> LaneConstants:
    """The machine's constants for lanes like phi0 [B] (its dtype, device
    and B)."""
    dt, dev = phi0.dtype, phi0.device
    Bsz = phi0.shape[0]

    def T(v):
        return torch.tensor(v, dtype=dt, device=dev)

    return LaneConstants(
        c1=T(opts.c1), c2=T(opts.c2), slack=T(opts.armijo_slack), beta_inc=T(opts.beta_increase),
        beta_dec=T(opts.beta_decrease), alpha_max=T(opts.alpha_max),
        min_interval=T(opts.min_interval_size), z=T(0.0), half=T(0.5), one=T(1.0), two=T(2.0),
        three=T(3.0), four=T(4.0), six=T(6.0), tol=T(_TOL),
        zero=torch.zeros(Bsz, dtype=dt, device=dev),
        alpha0=torch.as_tensor(alpha0, dtype=dt, device=dev).expand(Bsz),
        ints=_Fills(Bsz, dev))


def cubic_fit_lanes(x1, y1, d1, x2, y2, d2, k: Optional[LaneConstants] = None):
    """`cubic_fit` on [B] tensors of one float dtype, lane by lane, in
    JAX's order with every constant a tensor of that dtype (k's, or made
    here)."""
    k = k or lane_constants(y1)
    one, two, three = k.one, k.two, k.three
    delta = x2 - x1
    same = torch.abs(delta) < k.tol
    ds = torch.where(same, one, delta)
    c = three * (y2 - y1) / (ds * ds) - (d2 + two * d1) / ds
    d = (d2 + d1) / (ds * ds) - two * (y2 - y1) / (ds * ds * ds)
    return (x1, y1, d1, c, d), ~same


def cubic_argmin_lanes(spline, k: Optional[LaneConstants] = None):
    """`cubic_argmin` on [B] tensors, lane by lane; a lane without a
    minimum may hold any value (NaN included) in x_min, selected away
    by `found`. k: the constants (made here without)."""
    x0, _, b, c, d = spline
    k = k or lane_constants(b)
    zero, one, two, three, four, six, tol = k.z, k.one, k.two, k.three, k.four, k.six, k.tol
    is_quadratic = torch.abs(d) < tol
    is_linear = is_quadratic & (torch.abs(c) < tol)

    # quadratic path
    c_safe = torch.where(torch.abs(c) < tol, one, c)
    quad_min = -b / (two * c_safe) + x0
    quad_found = is_quadratic & ~is_linear & (c > 0)

    # cubic path: roots of 3d t^2 + 2c t + b = 0
    qa, qb, qc = three * d, two * c, b
    qa_safe = torch.where(torch.abs(qa) < tol, one, qa)
    s2 = qb * qb - four * qa * qc
    s2_zero = torch.abs(s2) < tol
    s = torch.where(s2_zero, zero, torch.sqrt(torch.maximum(s2, zero)))
    roots_ok = s2_zero | (s2 >= 0)
    t1 = (-qb + s) / (two * qa_safe)
    t2 = (-qb - s) / (two * qa_safe)
    curv1 = two * c + six * d * t1
    curv2 = two * c + six * d * t2
    pick1 = (curv1 > 0) & (curv2 < 0)
    pick2 = (curv1 < 0) & (curv2 > 0)
    cubic_min = torch.where(pick1, t1, t2) + x0
    cubic_found = ~is_quadratic & roots_ok & (pick1 | pick2)
    return torch.where(is_quadratic, quad_min, cubic_min), quad_found | cubic_found


_STATE = ("mode", "alpha_next", "aux", "aux_alpha", "small_window", "n_iters", "iter",
          "zoom_iter", "btr_iter", "alpha", "phi", "dphi", "fnd", "alpha_prev", "phi_prev",
          "dphi_prev", "alo", "ahi", "phi_lo", "phi_hi", "dphi_lo", "dphi_hi",
          "hit_max_alpha", "code", "res_alpha", "res_phi", "res_dphi")


def _pick(cond, a: dict, b: dict) -> dict:
    """Per-lane select of two machine states (fields both share are kept
    as they are): where-only, so a discarded NaN never reaches a lane."""
    return {k: a[k] if a[k] is b[k] else _where(cond, a[k], b[k]) for k in _STATE}


def lane_modes(opts: LineSearchOptions) -> tuple:
    """The modes a lane of the machine can be in before it finishes: the
    bracket, the one-shot cubic with `try_cubic_first`, then the
    sequential backtracking with `use_backtracking`, else the zoom."""
    return ((_BRACKET,) + ((_CUBIC,) if opts.try_cubic_first else ())
            + ((_BACKTRACK,) if opts.use_backtracking else (_ZOOM,)))


def lanes_start(phi0: torch.Tensor, dphi0: torch.Tensor, k: LaneConstants, aux0=None,
                active: Optional[torch.Tensor] = None) -> dict:
    """The machine's state before its first pass, per lane [B]: every lane
    in the bracket at k.alpha0, a lane whose dphi0 >= 0 (not a descent
    direction: alpha = 0, linesearch.cpp:49-52) or that `active` leaves
    out finished. aux0: the payload a lane holds until it evaluates one."""
    dt, dev = phi0.dtype, phi0.device
    Bsz = phi0.shape[0]

    def I(v):
        return k.ints[int(v)]

    zero, alpha0 = k.zero, k.alpha0
    false = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    s = dict(
        mode=I(_BRACKET), alpha_next=alpha0, aux=() if aux0 is None else aux0,
        aux_alpha=torch.full((Bsz,), math.nan, dtype=dt, device=dev), small_window=false,
        n_iters=I(0), iter=I(0), zoom_iter=I(0), btr_iter=I(0), alpha=alpha0, phi=phi0,
        dphi=dphi0, fnd=false, alpha_prev=zero, phi_prev=phi0, dphi_prev=dphi0, alo=zero,
        ahi=zero, phi_lo=phi0, phi_hi=phi0, dphi_lo=dphi0, dphi_hi=dphi0,
        hit_max_alpha=false, code=I(LineSearchCode.NO_ERROR), res_alpha=zero, res_phi=phi0,
        res_dphi=dphi0)

    def done(s, code):
        return {**s, "mode": I(_DONE), "code": I(code), "res_alpha": zero, "res_phi": phi0,
                "res_dphi": dphi0}

    s = _pick(dphi0 >= 0, done(s, LineSearchCode.NOT_DESCENT_DIRECTION), s)
    if active is not None:
        s = _pick(active, s, done(s, LineSearchCode.NO_ERROR))
    return s


def lanes_pass(s: dict, phi_t, dphi_t, aux_t, phi0, dphi0, k: LaneConstants,
               opts: LineSearchOptions = LineSearchOptions(), modes=None,
               any_done: bool = True) -> dict:
    """One pass of the machine: every lane evaluated at its `alpha_next`
    (phi_t, dphi_t [B], aux_t its payload, () without one), each lane's
    transition selected by its mode (torch.where only), a finished lane
    keeping every field, its payload too: the body of JAX's vmapped
    `lax.while_loop` over `lax.switch`, in the merit's dtype and JAX's
    order. The one copy of the transitions: the live machine
    (`wolfe_line_search_lanes`) and the exported graph (graph_solve.py)
    both run it. k: the search's constants (`lane_constants`).

    modes: the modes whose transitions to compute (default `lane_modes`;
    the live machine passes those some running lane is in); any_done:
    False when no lane has finished (the finished lanes' select is
    skipped)."""
    dt = phi0.dtype

    def I(v):
        return k.ints[int(v)]

    c1, c2, slack, beta_inc, beta_dec = k.c1, k.c2, k.slack, k.beta_inc, k.beta_dec
    alpha_max, min_interval, half, zero, alpha0 = (k.alpha_max, k.min_interval, k.half, k.zero,
                                                   k.alpha0)

    def done(s, code, alpha, phi, dphi):
        return {**s, "mode": I(_DONE), "code": I(code) if isinstance(code, int) else code,
                "res_alpha": alpha, "res_phi": phi, "res_dphi": dphi}

    def armijo(alpha, phi):
        return phi <= phi0 + c1 * alpha * dphi0 + slack * torch.abs(phi0)

    def wolfe(dphi):
        return torch.abs(dphi) <= -c2 * dphi0

    def zoom_trial(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi):
        """Next zoom trial: cubic argmin, else midpoint; tiny window -> midpoint."""
        small = torch.abs(alo - ahi) < min_interval
        spline, fit_ok = cubic_fit_lanes(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi, k)
        amin, found = cubic_argmin_lanes(spline, k)
        use_cubic = fit_ok & found & torch.isfinite(amin)
        mid = half * (alo + ahi)
        return torch.where(small, mid, torch.where(use_cubic, amin, mid)), small

    def enter_zoom(s, alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi):
        """Transition into the zoom stage (linesearch.cpp:233-303)."""
        nonfinite = ~(torch.isfinite(alo) & torch.isfinite(ahi))
        zoom_iter = s["n_iters"] + 1
        trial, small = zoom_trial(alo, phi_lo, dphi_lo, ahi, phi_hi, dphi_hi)
        s = {**s, "mode": I(_ZOOM), "alo": alo, "ahi": ahi, "phi_lo": phi_lo,
             "phi_hi": phi_hi, "dphi_lo": dphi_lo, "dphi_hi": dphi_hi, "zoom_iter": zoom_iter,
             "alpha_next": trial, "small_window": small}
        s = _pick(zoom_iter >= opts.max_iters,
                  done(s, int(LineSearchCode.MAX_ITERATIONS), alo, phi_lo, dphi_lo), s)
        return _pick(nonfinite, done(s, int(LineSearchCode.GOT_NONFINITE_STEP_SIZE), zero,
                                     s["phi"], s["dphi"]), s)

    def expand(s, alpha, phi, dphi):
        new_alpha = alpha * beta_inc
        over = new_alpha > alpha_max
        new_alpha = torch.minimum(new_alpha, alpha_max)
        stop = over & s["hit_max_alpha"]
        s = {**s, "alpha_prev": alpha, "phi_prev": phi, "dphi_prev": dphi,
             "alpha_next": new_alpha, "hit_max_alpha": s["hit_max_alpha"] | over,
             "iter": s["iter"] + 1}
        s = _pick(stop, done(s, int(LineSearchCode.HIT_MAX_STEPSIZE), new_alpha, phi, dphi), s)
        # bracket loop exhausted: the current alpha, the code as it stands
        return _pick(s["iter"] >= opts.max_iters, done(s, s["code"], new_alpha, phi, dphi), s)

    def post_check(s, alpha, phi, dphi, fnd):
        """Bracket-stage logic after the Wolfe test fails (linesearch.cpp:
        137-213): the backtracking fallback, the two zoom entries, or the
        interval expansion with its alpha_max handling."""
        if opts.use_backtracking:
            return {**s, "mode": I(_BACKTRACK), "alpha_next": alpha0 * beta_dec,
                    "btr_iter": I(1)}
        case_a = ~armijo(alpha, phi) | ((s["iter"] > 0) & fnd)
        case_c = dphi >= 0
        zoom_a = enter_zoom(s, s["alpha_prev"], s["phi_prev"], s["dphi_prev"], alpha, phi, dphi)
        zoom_c = enter_zoom(s, alpha, phi, dphi, s["alpha_prev"], s["phi_prev"], s["dphi_prev"])
        return _pick(case_a, zoom_a, _pick(case_c, zoom_c, expand(s, alpha, phi, dphi)))

    def bracket_step(s, phi_t, dphi_t):
        alpha = s["alpha_next"]
        fnd = phi_t >= s["phi_prev"]
        ok = armijo(alpha, phi_t) & wolfe(dphi_t)
        s = {**s, "n_iters": s["n_iters"] + 1, "alpha": alpha, "phi": phi_t, "dphi": dphi_t,
             "fnd": fnd}
        on_fail = post_check(s, alpha, phi_t, dphi_t, fnd)
        if opts.try_cubic_first:  # one-shot cubic interpolation on the first interval
            spline, fit_ok = cubic_fit_lanes(zero, phi0, dphi0, alpha, phi_t, dphi_t, k)
            amin, found = cubic_argmin_lanes(spline, k)
            try_cubic = (s["iter"] == 0) & fit_ok & found & torch.isfinite(amin)
            to_cubic = {**s, "mode": I(_CUBIC), "alpha_next": amin, "iter": s["iter"] + 1}
            on_fail = _pick(try_cubic, to_cubic, on_fail)
        return _pick(ok, done(s, int(LineSearchCode.MINIMUM_FOUND), alpha, phi_t, dphi_t),
                     on_fail)

    def cubic_step(s, phi_t, dphi_t):
        alpha_c = s["alpha_next"]
        s = {**s, "n_iters": s["n_iters"] + 1}
        ok = armijo(alpha_c, phi_t) & wolfe(dphi_t)
        # a failed cubic trial is discarded: on with the saved first trial
        return _pick(ok, done(s, int(LineSearchCode.MINIMUM_FOUND), alpha_c, phi_t, dphi_t),
                     post_check(s, s["alpha"], s["phi"], s["dphi"], s["fnd"]))

    def zoom_step(s, phi_t, dphi_t):
        alpha = s["alpha_next"]
        s = {**s, "n_iters": s["n_iters"] + 1}
        suff, curv = armijo(alpha, phi_t), wolfe(dphi_t)
        ok = suff & curv
        on_small = done(s, torch.where(ok, I(LineSearchCode.MINIMUM_FOUND),
                                       I(LineSearchCode.WINDOW_TOO_SMALL)), alpha, phi_t, dphi_t)
        on_ok = done(s, int(LineSearchCode.MINIMUM_FOUND), alpha, phi_t, dphi_t)
        shrink_hi = ~suff | (phi_t > s["phi_lo"])
        adj_hi = {**s, "ahi": alpha, "phi_hi": phi_t, "dphi_hi": dphi_t}
        reset_ahi = dphi_t * (s["ahi"] - s["alo"]) <= 0
        adj_lo = {**s, "ahi": torch.where(reset_ahi, s["alo"], s["ahi"]),
                  "phi_hi": torch.where(reset_ahi, s["phi_lo"], s["phi_hi"]),
                  "dphi_hi": torch.where(reset_ahi, s["dphi_lo"], s["dphi_hi"]),
                  "alo": alpha, "phi_lo": phi_t, "dphi_lo": dphi_t}
        up = _pick(shrink_hi, adj_hi, adj_lo)
        trial, small = zoom_trial(up["alo"], up["phi_lo"], up["dphi_lo"], up["ahi"],
                                  up["phi_hi"], up["dphi_hi"])
        up = {**up, "zoom_iter": up["zoom_iter"] + 1, "alpha_next": trial, "small_window": small}
        up = _pick(up["zoom_iter"] >= opts.max_iters,
                   done(up, int(LineSearchCode.MAX_ITERATIONS), alpha, phi_t, dphi_t), up)
        return _pick(s["small_window"], on_small, _pick(ok, on_ok, up))

    def backtrack_step(s, phi_t, dphi_t):
        alpha = s["alpha_next"]
        s = {**s, "n_iters": s["n_iters"] + 1}
        new_alpha = alpha * beta_dec
        shrink = {**s, "alpha_next": new_alpha, "btr_iter": s["btr_iter"] + 1}
        shrink = _pick(shrink["btr_iter"] >= opts.max_iters,
                       done(shrink, shrink["code"], new_alpha, phi_t, shrink["res_dphi"]), shrink)
        return _pick(armijo(alpha, phi_t),
                     done(s, int(LineSearchCode.MINIMUM_FOUND), alpha, phi_t, dphi_t), shrink)

    steps = (bracket_step, cubic_step, zoom_step, backtrack_step)
    s_t = {**s, "aux": aux_t, "aux_alpha": s["alpha_next"]}
    new = None
    for mode in lane_modes(opts) if modes is None else modes:
        stepped = steps[mode](s_t, phi_t.to(dt), dphi_t.to(dt))
        new = stepped if new is None else _pick(s["mode"] == mode, stepped, new)
    # finished lanes keep every field, the payload included
    return _pick(s["mode"] == _DONE, s, new) if any_done else new


def lanes_result(s: dict) -> LineSearchResult:
    """The machine's answer per lane from its finished state."""
    return LineSearchResult(alpha=s["res_alpha"], phi=s["res_phi"], dphi=s["res_dphi"],
                            code=s["code"], n_iters=s["n_iters"], aux=s["aux"],
                            aux_alpha=s["aux_alpha"])


def wolfe_line_search_lanes(
    merit_full: Callable,
    phi0: torch.Tensor,
    dphi0: torch.Tensor,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    aux0=None,
    active: Optional[torch.Tensor] = None,
    trace: Optional[Trace] = None,
) -> LineSearchResult:
    """`jax.vmap(wolfe_line_search)` on lane tensors: B searches in
    lockstep, each lane its own state machine (bracket, one-shot cubic,
    zoom with the small-window midpoint, or the sequential backtracking).

    phi0, dphi0 [B] (float); merit_full(alpha [B]) -> (phi [B], dphi [B])
    or (phi, dphi, aux), each lane evaluated at its own alpha; with aux0
    (a pytree of [..., B] tensors) the payload of each lane's last
    evaluation is carried (`aux`, valid at `aux_alpha`). active [B] bool:
    lanes to search (default all); the others start finished (code
    NO_ERROR, alpha 0) and are never read. With `opts.verbose` it prints
    what `jax.vmap(wolfe_line_search)` prints: each lane's start banner,
    then every pass one trial line per lane in lane order (a finished
    lane's at its held n_iters and alpha_next, as JAX's batched while
    loop runs its body for every lane); one host read a pass.

    The loop over `lanes_pass`: one merit evaluation for every lane a
    pass, the transitions computed only for the modes some running lane
    is in. Each pass ends in one host read (the lanes' mode counts),
    which is the loop condition and picks the next pass's transitions.
    Every decision is a tensor operation in the merit's dtype, in JAX's
    order, so an f64 search takes JAX's path lane for lane. trace: a
    `Trace` whose "passes" and "syncs" count this search's loop passes
    and host reads.
    """
    trace = trace or Trace()
    has_aux = aux0 is not None
    k = lane_constants(phi0, alpha0, opts)
    s = lanes_start(phi0, dphi0, k, aux0, active)

    def mode_counts(s):
        return trace.read(torch.bincount(s["mode"].long(), minlength=5))

    if opts.verbose:  # each lane's start banner (altro_tpu/linesearch.py:521-525)
        for p0, d0 in torch.stack([phi0, dphi0]).T.tolist():
            print(f"  Starting Cubic Line Search with phi0 = {p0:.8}, dphi0 = {d0:.6}")
    counts = mode_counts(s)
    while any(counts[:_DONE]):
        out = merit_full(s["alpha_next"])
        if has_aux:
            phi_t, dphi_t, aux_t = out
        else:
            (phi_t, dphi_t), aux_t = out[:2], ()
        if opts.verbose:  # every lane's trial line, a finished lane's at its held trial
            rows = torch.stack([s["n_iters"].to(phi0.dtype), s["alpha_next"],
                                phi_t.to(phi0.dtype), dphi_t.to(phi0.dtype)]).T.tolist()
            for i, a, p, d in rows:
                print(f"    ls trial {int(i)}: alpha = {a:.6}, phi = {p:.8}, dphi = {d:.6}")
        s = lanes_pass(s, phi_t, dphi_t, aux_t, phi0, dphi0, k, opts,
                       modes=[k for k in range(_DONE) if counts[k]], any_done=counts[_DONE] > 0)
        trace.add("passes")
        counts = mode_counts(s)
    return lanes_result(s)


# ---------------------------------------------------------------------------
# Grid searches
# ---------------------------------------------------------------------------


def parallel_backtracking_search(
    merit_full: Optional[Callable],
    phi0,
    dphi0,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    aux0=None,
    width: int = 8,
    *,
    merit_grid: Optional[Callable] = None,
    reconstruct: Optional[Callable] = None,
    complete: Optional[Callable] = None,
) -> LineSearchResult:
    """Backtracking with the trials alpha0 * beta^k evaluated a block of
    `width` at a time (the non-split grid): trial 0 passes on Armijo plus
    strong Wolfe, later trials on Armijo; the first passing trial wins; up
    to opts.max_iters trials. n_iters is the count the sequential search
    would make (1 + k). When no trial passes the code is NO_ERROR and
    alpha the first trial of the last block, as in JAX.

    The JAX search evaluates the full merit (payload and dphi) of every
    trial. Each trial's values are a function of its alpha alone, so here
    only the values the selection reads are formed: phi of every trial,
    dphi of trial 0 and the payload of the selected trial. Either
    merit_full(alpha) -> (phi, dphi[, aux]) (called again for trial 0
    and the selected trial), or the solve's hooks: merit_grid(alphas) ->
    (phis [W], carriers), reconstruct(carrier, alpha, phi) -> light
    payload, complete(light) -> (dphi, payload), as
    `parallel_backtracking_search_split` takes them.
    """
    merit_value = None
    if merit_grid is None:
        has_aux = aux0 is not None

        def merit_value(a):
            return merit_full(a)[0], a  # the carrier: the trial's alpha

        def complete(a, with_dphi=True):
            out = merit_full(a)
            return out[1], (out[2] if has_aux else ())

        reconstruct = None
    res = parallel_backtracking_search_split(
        merit_value, complete, phi0, dphi0, alpha0, opts, width=width, armijo_only=False,
        reconstruct=reconstruct, merit_grid=merit_grid)
    scal = dict(dtype=res.alpha.dtype, device=res.alpha.device)
    n_blocks = max(1, -(-int(opts.max_iters) // width))
    k_last = torch.tensor((n_blocks - 1) * width, device=scal["device"]).to(scal["dtype"])
    alpha_last = torch.as_tensor(alpha0, **scal) * torch.as_tensor(opts.beta_decrease,
                                                                   **scal) ** k_last
    return res._replace(alpha=torch.where(res.code == int(LineSearchCode.NO_ERROR),
                                          alpha_last, res.alpha))


def parallel_backtracking_search_split(
    merit_value: Callable,
    complete: Callable,
    phi0,
    dphi0,
    alpha0=1.0,
    opts: LineSearchOptions = LineSearchOptions(),
    width: int = 8,
    armijo_only: bool = False,
    reconstruct: Optional[Callable] = None,
    merit_grid: Optional[Callable] = None,
    best_decrease_fallback: bool = False,
) -> LineSearchResult:
    """Grid of trials alpha0 * beta^k in blocks of `width`, first Armijo
    pass wins (trial 0 also needs strong Wolfe unless armijo_only), up to
    opts.max_iters trials; the accepted payload is completed once.

    merit_value(alpha) -> (phi, payload) per trial, or merit_grid(alphas)
    -> (phis [W], payloads stacked on a leading W axis) for a block;
    reconstruct(payload, alpha, phi) rebuilds the light payload from a
    minimal carrier; complete(light, with_dphi) -> (dphi, full payload).
    best_decrease_fallback: when no trial passes, take the lowest-merit
    trial if it decreases the merit (code BEST_DECREASE).
    """
    phi0 = torch.as_tensor(phi0)
    dtype, dev = phi0.dtype, phi0.device
    scal = dict(dtype=dtype, device=dev)
    dphi0 = torch.as_tensor(dphi0, **scal)
    alpha0 = torch.as_tensor(alpha0, **scal)
    beta = torch.as_tensor(opts.beta_decrease, **scal)
    c1 = torch.as_tensor(opts.c1, **scal)
    c2 = torch.as_tensor(opts.c2, **scal)
    slack = torch.as_tensor(opts.armijo_slack, **scal)
    n_blocks = max(1, -(-int(opts.max_iters) // width))
    ar = torch.arange(width, device=dev)

    if merit_grid is None:
        def eval_grid(alphas):
            outs = [merit_value(a) for a in alphas]
            return (torch.stack([torch.as_tensor(p, **scal) for p, _ in outs]),
                    _stack([light for _, light in outs]))
    else:
        def eval_grid(alphas):
            phis, lights = merit_grid(alphas)
            return phis.to(dtype), lights

    def armijo_mask(alphas, phis):
        return phis <= phi0 + c1 * alphas * dphi0 + slack * torch.abs(phi0)

    def pick(lights, i):
        return tree_map(lambda a: a[i], lights)

    # block 0: needs trial 0's dphi for the strong-Wolfe test (unless armijo_only)
    ks0 = ar
    alphas0 = alpha0 * beta ** ks0.to(dtype)
    phis0, lights0 = eval_grid(alphas0)
    armijo0 = armijo_mask(alphas0, phis0)
    if opts.verbose:  # the grid's analog of the per-trial trace
        print(f"    ls grid block 0: alphas = {alphas0.cpu().numpy()}, "
              f"phis = {phis0.cpu().numpy()} (phi0 = {float(phi0):.8})")
    if armijo_only:
        passes0 = armijo0
    else:
        light_first = pick(lights0, 0)
        if reconstruct is not None:
            light_first = reconstruct(light_first, alphas0[0], phis0[0])
        dphi_first, _ = complete(light_first)
        wolfe_first = torch.abs(dphi_first) <= -c2 * dphi0
        passes0 = torch.where(ks0 == 0, armijo0 & wolfe_first, armijo0)
    found = torch.any(passes0)
    idx = torch.argmax(passes0.to(torch.int32))
    k_acc, alpha_acc, phi_acc, light_acc = ks0[idx], alphas0[idx], phis0[idx], pick(lights0, idx)
    if best_decrease_fallback:
        bi = torch.argmin(phis0)
        bk, balpha, bphi, blight = ks0[bi], alphas0[bi], phis0[bi], pick(lights0, bi)

    # deeper blocks: Armijo only, one host sync per block on `found`
    block = 1
    while block < n_blocks and not bool(found):
        ks = block * width + ar
        alphas = alpha0 * beta ** ks.to(dtype)
        phis, lights = eval_grid(alphas)
        passes = armijo_mask(alphas, phis)
        if opts.verbose:
            print(f"    ls grid block {block}: alphas = {alphas.cpu().numpy()}, "
                  f"phis = {phis.cpu().numpy()}")
        found = torch.any(passes)
        idx = torch.argmax(passes.to(torch.int32))
        k_acc, alpha_acc, phi_acc, light_acc = ks[idx], alphas[idx], phis[idx], pick(lights, idx)
        if best_decrease_fallback:
            bi = torch.argmin(phis)
            take_best = phis[bi] < bphi
            bk = torch.where(take_best, ks[bi], bk)
            balpha = torch.where(take_best, alphas[bi], balpha)
            bphi = torch.where(take_best, phis[bi], bphi)
            blight = _where(take_best, pick(lights, bi), blight)
        block += 1

    not_descent = dphi0 >= 0
    ok = found & ~not_descent
    if best_decrease_fallback:
        fb = ~ok & (bphi < phi0)
        k_acc = torch.where(fb, bk, k_acc)
        alpha_acc = torch.where(fb, balpha, alpha_acc)
        phi_acc = torch.where(fb, bphi, phi_acc)
        light_acc = _where(fb, blight, light_acc)
    else:
        fb = torch.zeros_like(ok)

    # complete the accepted step's payload (once)
    if reconstruct is not None:
        light_acc = reconstruct(light_acc, alpha_acc, phi_acc)
    dphi_acc, aux_acc = complete(light_acc, with_dphi=not armijo_only)

    def code_of(c):
        return torch.tensor(int(c), dtype=torch.int32, device=dev)

    code = torch.where(ok, code_of(LineSearchCode.MINIMUM_FOUND),
                       torch.where(fb, code_of(LineSearchCode.BEST_DECREASE),
                                   torch.where(not_descent,
                                               code_of(LineSearchCode.NOT_DESCENT_DIRECTION),
                                               code_of(LineSearchCode.NO_ERROR))))
    take = ok | fb
    zero = torch.zeros((), **scal)
    nan = torch.full((), float("nan"), **scal)
    return LineSearchResult(
        alpha=torch.where(take, alpha_acc, zero),
        phi=phi_acc,
        dphi=dphi_acc,
        code=code,
        n_iters=torch.where(ok, k_acc + 1,
                            torch.full_like(k_acc, opts.max_iters)).to(torch.int32),
        aux=aux_acc,
        aux_alpha=torch.where(take, alpha_acc, nan),
    )
