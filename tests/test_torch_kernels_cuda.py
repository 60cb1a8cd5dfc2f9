"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips unless torch.cuda.is_available() (decided
inside the fixture, never at import). On a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -p no:randomly -n 0

Small shapes with a ragged batch (B not a multiple of the block size)
for the batched kernels, and horizons at the 64-knot chunk edges (up to
the solve's 500) for the single-lane ones, every template instantiation
of each: the same comparisons as chip_smoke.py's parity phases.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

BR, NK = 300, 8  # ragged lane count, knots


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _backward_inputs(dev, n=4, m=2, Bsz=BR, Nk=NK, diag=True, with_lux=False, seed=0):
    """Lane-minor operands of the batched backward: positive diagonal or
    SPD dense cost blocks, lux when asked, a per-lane reg; lane min(5, B-1)
    broken at knots 2 and 5 (knot 0 when N < 3) and lane B-1 at the last
    knot."""
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None, :, :, None] + 0.05 * rng.standard_normal((Nk, n, n, Bsz))
    Bm = 0.3 * rng.standard_normal((Nk, n, m, Bsz))
    if diag:
        lxx = np.abs(rng.standard_normal((Nk + 1, n, Bsz))) + 0.1
        luu = np.abs(rng.standard_normal((Nk, m, Bsz))) + 0.1
        bad = -10.0
    else:
        Wx = rng.standard_normal((Nk + 1, n, n, Bsz))
        lxx = np.einsum("kijb,kljb->kilb", Wx, Wx) / n + np.eye(n)[None, :, :, None]
        Wu = rng.standard_normal((Nk, m, m, Bsz))
        luu = np.einsum("kijb,kljb->kilb", Wu, Wu) / m + np.eye(m)[None, :, :, None]
        bad = -10.0 * np.eye(m)
    lx = rng.standard_normal((Nk + 1, n, Bsz))
    lu = rng.standard_normal((Nk, m, Bsz))
    reg = 0.01 * rng.random(Bsz)
    for k in [k for k in (2, 5) if k < Nk] or [0]:
        luu[k, ..., min(5, Bsz - 1)] = bad
    luu[Nk - 1, ..., Bsz - 1] = bad
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    lux = t(0.02 * rng.standard_normal((Nk, m, n, Bsz))) if with_lux else None
    return [t(a) for a in (A, Bm, lxx, luu, lx, lu, reg)], lux


@pytest.mark.parametrize("n, m", [(4, 2), (12, 4), (2, 1), (6, 3)])
@pytest.mark.parametrize("diag, with_lux", [(True, False), (True, True), (False, False),
                                            (False, True)])
@pytest.mark.parametrize("Bsz", [1, 33, BR, 2048])
@pytest.mark.parametrize("Nk", [1, NK, 30])
def test_riccati_kernel_matches_plain(dev, n, m, diag, with_lux, Bsz, Nk):
    """Every form the batched solve launches (diagonal or dense cost, with
    and without lux) at every (n, m), ragged lane tiles (B = 1, 33, 300
    against blocks of 8, 16 and 32 lanes; B = 1 and 33 take the one-float
    copies), one knot up to the main path's 30, with failing lanes."""
    from altro_tpu_torch.ops import riccati_backward as rb

    args, lux = _backward_inputs(dev, n, m, Bsz, Nk, diag, with_lux)
    before = rb.LAUNCHES
    gk = rb.riccati_backward(*args, lux=lux, diag_cost=diag)
    gr = rb.riccati_backward_ref(*args, lux=lux)
    torch.cuda.synchronize()
    assert rb.LAUNCHES == before + 1
    assert float((gk.K - gr.K).abs().max()) < 1e-4
    assert float((gk.d - gr.d).abs().max()) < 1e-4
    assert float(((gk.P - gr.P).abs() / (1 + gr.P.abs())).max()) < 1e-5
    assert float(((gk.p - gr.p).abs() / (1 + gr.p.abs())).max()) < 1e-5
    assert float(((gk.delta_V - gr.delta_V).abs() / (1 + gr.delta_V.abs())).max()) < 1e-5
    assert torch.equal(gk.ok, gr.ok) and torch.equal(gk.fail_index, gr.fail_index)
    first = 2 if Nk > 2 else 0
    assert int(gk.fail_index[min(5, Bsz - 1)]) == first
    if Bsz > 6:
        assert int(gk.fail_index[Bsz - 1]) == Nk - 1
    assert int((~gk.ok).sum()) == (2 if Bsz > 6 else 1)
    failed = ~gk.ok
    assert float(gk.K[gk.fail_index[failed].long(), :, :, failed.nonzero()[:, 0]].abs().max()) == 0


def test_riccati_kernel_refuses_what_it_does_not_implement(dev):
    from altro_tpu_torch.ops import riccati_backward as rb

    (A, Bm, lxx, luu, lx, lu, reg), _ = _backward_inputs(dev)
    with pytest.raises(NotImplementedError, match="n=4, m=1"):
        rb.riccati_backward(A, Bm[:, :, :1], lxx, luu[:, :1], lx, lu[:, :1], reg, diag_cost=True)
    with pytest.raises(ValueError, match="lxx has shape"):
        rb.riccati_backward(A, Bm, lxx, luu, lx, lu, reg, diag_cost=False)
    with pytest.raises(TypeError, match="float32"):
        rb.riccati_backward(A.double(), Bm, lxx, luu, lx, lu, reg, diag_cost=True)
    with pytest.raises(ValueError, match="contiguous"):
        rb.riccati_backward(A.transpose(1, 2), Bm, lxx, luu, lx, lu, reg, diag_cost=True)


def _rollout_inputs(dev, seed=1, Bsz=BR, Nk=NK, W=4, P=2, frame="cog"):
    """Scotty problem (steering bound for P=2, none for P=0; the bicycle in
    `frame`) and rollout operands of Bsz lanes, Nk knots and W trials."""
    import dataclasses

    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.models.bicycle import BicycleFrame, bicycle_continuous
    from altro_tpu_torch.models.integrators import midpoint
    from altro_tpu_torch.models.tile_steps import bicycle_cols, midpoint_cols

    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=Nk, dtype=torch.float32, device=dev)
    if P == 0:
        prob = dataclasses.replace(prob, constraints=())
    if frame != "cog":
        prob = dataclasses.replace(
            prob, dynamics=midpoint(bicycle_continuous(BicycleFrame(frame))),
            dynamics_cols=midpoint_cols(bicycle_cols(frame)))
    rng = np.random.default_rng(seed)
    xr = ref.x[: Nk + 1, :, None] + 0.2 * rng.standard_normal((Nk + 1, 4, Bsz))
    xr[:, 3] = np.sign(rng.standard_normal(Bsz)) * (1.07 + 0.02 * rng.standard_normal((Nk + 1, Bsz)))
    ur = ref.u[:Nk, :, None] + 0.02 * rng.standard_normal((Nk, 2, Bsz))
    K = 0.002 * rng.standard_normal((Nk, 2, 4, Bsz))
    d = 0.05 * rng.standard_normal((Nk, 2, Bsz))
    z = np.abs(rng.standard_normal((Nk + 1, 2, Bsz)))
    rho = 1.0 + 9.0 * rng.random(Bsz)
    x0 = xr[0] + 0.01 * rng.standard_normal((4, Bsz))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    zs = (t(z),) if P else ()
    return prob, (t(xr), t(ur), t(K), t(d), zs, t(rho), t(0.5 ** np.arange(W)), t(x0))


@pytest.mark.parametrize("frame", ["cog", "rear", "front"])
@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("Bsz, W", [(1, 4), (33, 12), (2000, 8)])
def test_rollout_kernel_matches_plain(dev, Bsz, W, P, frame):
    """Every (frame, P) instantiation: ragged lane tiles (B = 1, 33, 2000
    against 16-lane blocks), a trial count past one block's 8 (W=12) and
    20 knots (three staged chunks of 8, the first buffer reused)."""
    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _rollout_inputs(dev, Bsz=Bsz, Nk=20, W=W, P=P, frame=frame)
    before = rg.LAUNCHES
    pk, xk = rg.rollout_grid(prob, *args)
    pr, xr = rg.rollout_grid_ref(prob, *args)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + 1
    assert pk.shape == (W, Bsz) and xk.shape == (W, 21, 4, Bsz)
    # chip_smoke.py's gates: phi to 1e-4 relative, states to 1e-4
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xr).abs().max()) < 1e-4


def test_rollout_kernel_refuses_ineligible_problems(dev):
    import dataclasses

    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _rollout_inputs(dev)
    with pytest.raises(NotImplementedError, match="column-form"):
        rg.rollout_grid(dataclasses.replace(prob, dynamics_cols=None), *args)


@pytest.mark.parametrize("rti", [False, True])
def test_solve_on_card_tracks_plain_path(dev, rti):
    """Three closed-loop ticks through both kernels agree with the plain
    CPU path (f64) on every lane's status, and the plant states to 1e-2
    (each solve stops at stationarity 1e-3, so f32 and f64 iterates part
    at that order). rti=True takes the real-time-iteration branch, whose
    rollout is the kernel with W=1."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.ops import rollout_grid as rg

    ref = load_scotty()
    opts, opts_r = mpc.bench_options(rti=rti)
    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        prob = mpc.scotty_problem(ref, N=12, dtype=dtype, device=device)
        x0 = mpc.perturbed_initial_states(ref, 16, seed=5, dtype=dtype, device=device)
        before = (rb.LAUNCHES, rg.LAUNCHES)
        out.append(mpc.run_closed_loop(prob, ref, x0, ticks=3, opts=opts,
                                       opts_rescue=opts_r))
        launched = (rb.LAUNCHES > before[0], rg.LAUNCHES > before[1])
        assert launched == ((True, True) if device == dev else (False, False))
    a, b = out
    assert torch.equal(a.status.cpu(), b.status)
    assert float((a.x_true.double().cpu() - b.x_true).abs().max()) < 1e-2


# single-lane horizons at the 64-knot chunk edges (one knot, one chunk
# short, full and one over, three chunks with the last ragged, the solve's)
LATENCY_N = [1, 63, 64, 65, 150, 500]
LATENCY_VARIANTS = list(itertools.product([True, False], repeat=4))  # diag_x, diag_u, lux, f


def _latency_inputs(dev, Nk, diag_x, diag_u, with_lux, with_f, fail_at=None, seed=2, n=4,
                    m=2):
    """Single-lane backward operands at (n, m): SPD dense or positive
    diagonal cost blocks, lux and f when asked, knot fail_at made
    indefinite."""
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None] + 0.05 * rng.standard_normal((Nk, n, n))
    Bm = 0.3 * rng.standard_normal((Nk, n, m))
    if diag_x:
        lxx = np.abs(rng.standard_normal((Nk + 1, n))) + 0.1
    else:
        Wm = rng.standard_normal((Nk + 1, n, n))
        lxx = np.einsum("kij,klj->kil", Wm, Wm) / n + np.eye(n)
    if diag_u:
        luu = np.abs(rng.standard_normal((Nk, m))) + 0.1
    else:
        Vm = rng.standard_normal((Nk, m, m))
        luu = np.einsum("kij,klj->kil", Vm, Vm) / m + np.eye(m)
    if fail_at is not None:
        luu[fail_at] = -10.0 if diag_u else -1e3 * np.eye(m)
    extra = {}
    if with_lux:
        extra["lux"] = 0.05 * rng.standard_normal((Nk, m, n))
    if with_f:
        extra["f"] = 0.02 * rng.standard_normal((Nk, n))
    lx = rng.standard_normal((Nk + 1, n))
    lu = rng.standard_normal((Nk, m))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return [t(a) for a in (A, Bm, lxx, luu, lx, lu)], {k: t(v) for k, v in extra.items()}


@pytest.mark.parametrize("diag_x, diag_u, with_lux, with_f", LATENCY_VARIANTS)
@pytest.mark.parametrize("Nk", LATENCY_N)
def test_riccati_latency_kernel_matches_plain(dev, diag_x, diag_u, with_lux, with_f, Nk):
    """Every (diag_x, diag_u, lux, f) instantiation at every chunk edge:
    no failing knot, and one at the first, a middle and the last knot,
    with reg 0 and > 0 (a Python number and a CUDA tensor)."""
    _check_latency(dev, Nk, diag_x, diag_u, with_lux, with_f, 4, 2)


def _check_latency(dev, Nk, diag_x, diag_u, with_lux, with_f, n, m):
    """The kernel against its plain version at (n, m): no failing knot, and
    one at the first, a middle and the last knot, with reg 0 and > 0 (a
    Python number and a CUDA tensor)."""
    from altro_tpu_torch.ops import riccati_latency as rl

    for fail_at, reg in ((None, 0.0), (0, 0.01), (Nk // 2, 0.0),
                         (Nk - 1, torch.tensor(0.01, device=dev))):
        args, extra = _latency_inputs(dev, Nk, diag_x, diag_u, with_lux, with_f, fail_at,
                                      n=n, m=m)
        before = rl.LAUNCHES
        gk = rl.riccati_latency(*args, reg, **extra)
        gr = rl.riccati_latency_ref(*args, reg, **extra)
        torch.cuda.synchronize()
        assert rl.LAUNCHES == before + 1
        assert float((gk.K - gr.K).abs().max()) < 1e-4
        assert float((gk.d - gr.d).abs().max()) < 1e-4
        assert float(((gk.P - gr.P).abs() / (1 + gr.P.abs())).max()) < 1e-5
        assert float(((gk.p - gr.p).abs() / (1 + gr.p.abs())).max()) < 1e-5
        assert float(((gk.delta_V - gr.delta_V).abs() / (1 + gr.delta_V.abs())).max()) < 1e-5
        assert bool(gk.ok) == bool(gr.ok) == (fail_at is None)
        assert int(gk.fail_index) == int(gr.fail_index)
        if fail_at is not None:
            assert int(gk.fail_index) <= fail_at
            assert float(gk.K[fail_at].abs().max()) == 0.0 == float(gk.d[fail_at].abs().max())


@pytest.mark.parametrize("diag_x, diag_u, with_lux, with_f", LATENCY_VARIANTS)
@pytest.mark.parametrize("Nk", [1, 10, 30, 500])
@pytest.mark.parametrize("n, m", [(2, 1), (4, 2)])
def test_riccati_latency_kernel_shapes_match_plain(dev, n, m, diag_x, diag_u, with_lux, with_f,
                                                   Nk):
    """Both instantiated shapes, the pendulum's (2, 1) and the bicycle's
    (4, 2), at the horizons the default-options solves run (the double
    integrator's N=10 below one 64-knot chunk, the Scotty window's 30)
    and the long horizon, every (diag_x, diag_u, lux, f) variant, with a
    planted failing knot."""
    _check_latency(dev, Nk, diag_x, diag_u, with_lux, with_f, n, m)


def test_default_options_solves_launch_the_latency_kernel(dev):
    """`solver.solve` with default SolverOptions() (the strong-Wolfe
    search) on the card: the Scotty single solve (4, 2), dense
    expansions, and the unconstrained pendulum swing-up (2, 1), both f32:
    SUCCESS, and the backward ran as the kernel."""
    import dataclasses

    from altro_tpu_torch import mpc, solver
    from altro_tpu_torch import reference_problems as rp
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.options import SolverOptions

    prob, st = mpc.scotty_reference_problem(load_scotty(), N=30, device=dev)
    before = rl.LAUNCHES
    state, stats = solver.solve(prob, st, SolverOptions(iterations_max=80))
    assert rl.LAUNCHES > before
    assert int(stats.status) == 0 and bool(torch.isfinite(state.x).all())

    prob = rp.pendulum_problem(50, 3.0, device=dev)
    st = solver.init_state(prob)
    st = dataclasses.replace(st, u=torch.full_like(st.u, 0.1))
    before = rl.LAUNCHES
    state, stats = solver.solve(prob, st, SolverOptions(iterations_max=20))
    assert rl.LAUNCHES > before and int(stats.status) == 0
    xN = state.x[-1].double().cpu().numpy()
    assert np.linalg.norm(xN - [3.12099917161669, 0.0011966258762942175]) < 1e-3


def test_refused_default_solve_launches_nothing(dev):
    """A float64 problem under default options (pallas_latency_backward)
    is refused before anything launches, naming the kernel and the way to
    the plain backward; that way solves."""
    from altro_tpu_torch import mpc, solver
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.options import SolverOptions

    prob, st = mpc.scotty_reference_problem(load_scotty(), N=30, dtype=torch.float64,
                                            device=dev)
    before = rl.LAUNCHES
    with pytest.raises(NotImplementedError,
                       match=r"riccati_latency.*float64.*pallas_latency_backward=False"):
        solver.solve(prob, st, SolverOptions(iterations_max=80))
    assert rl.LAUNCHES == before
    _, stats = solver.solve(prob, st, SolverOptions(iterations_max=80,
                                                    pallas_latency_backward=False))
    assert rl.LAUNCHES == before and int(stats.status) == 0


def test_riccati_latency_kernel_refuses_what_it_does_not_implement(dev):
    from altro_tpu_torch.ops import riccati_latency as rl

    args, _ = _latency_inputs(dev, 20, True, True, False, False)
    with pytest.raises(TypeError, match="float32"):
        rl.riccati_latency(*(a.double() for a in args), 0.01)
    with pytest.raises(ValueError, match="contiguous"):
        rl.riccati_latency(args[0].transpose(1, 2), *args[1:], 0.01)
    with pytest.raises(ValueError, match=r"reg has shape \(2,\), expected \(1,\)"):
        rl.riccati_latency(*args, torch.zeros(2, device=dev))
    c = lambda t: t.contiguous()  # noqa: E731
    with pytest.raises(NotImplementedError, match="n=3, m=1"):
        rl.riccati_latency(c(args[0][:, :3, :3]), c(args[1][:, :3, :1]), c(args[2][:, :3]),
                           c(args[3][:, :1]), c(args[4][:, :3]), c(args[5][:, :1]), 0.01)


def _trial_inputs(dev, Nk, W, P, frame, seed=3):
    """Trial-rollout operands of one lane around the Scotty path (steering
    angle near the bound), the block step in `frame`, and (P=2) the rows
    the solve builds from positive duals."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.models.tile_steps import bicycle_tile, midpoint_tile
    from altro_tpu_torch.ops.rollout_grid import affine_constraint_stacks

    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=Nk, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    xr = ref.x[: Nk + 1] + 0.1 * rng.standard_normal((Nk + 1, 4))
    xr[:, 3] = 1.0 + 0.05 * rng.standard_normal(Nk + 1)
    ur = ref.u[:Nk] + 0.02 * rng.standard_normal((Nk, 2))
    ur[:, 1] *= 0.1
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    c = prob.cost
    args = (t(0.5 ** np.arange(W)), t(xr[0]), t(xr), t(ur),
            t(0.002 * rng.standard_normal((Nk, 2, 4))), t(0.05 * rng.standard_normal((Nk, 2))),
            c.Q, c.q, c.R, c.r, c.c, prob.h)
    con = None
    if P:
        ax, au, g, act = affine_constraint_stacks(prob)
        rho = torch.tensor(3.0, device=dev)
        z = t(np.abs(rng.standard_normal((Nk + 1, 2))))
        con = (rho * ax * act[..., None], rho * au * act[..., None], (z - rho * g) * act,
               1.0 / (2.0 * rho))
    step = midpoint_tile(bicycle_tile(("cog", "rear", "front")[frame]))
    return step, args, con


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("W", [1, 8, 12, 32])
@pytest.mark.parametrize("Nk", [1, 63, 64, 65, 150])
def test_trial_rollout_kernel_matches_plain(dev, frame, P, W, Nk):
    """Every (frame, P) instantiation, W up to a full warp, N at the
    64-knot chunk edges (the merit warp trails the chain warp by one
    chunk, so the ragged last chunk and the terminal knot both count)."""
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args, con = _trial_inputs(dev, Nk, W, P, frame)
    before = tr.LAUNCHES
    pk, xk = tr.trial_rollout(step, *args, con=con)
    pr, xs = tr.trial_rollout_ref(step, *args, con=con)
    torch.cuda.synchronize()
    assert tr.LAUNCHES == before + 1
    assert pk.shape == (W,) and xk.shape == (W, Nk + 1, 4)
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xs).abs().max()) < 1e-4 * max(1.0, float(xs.abs().max()))


def test_trial_rollout_kernel_refuses_what_it_does_not_implement(dev):
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args, con = _trial_inputs(dev, 20, 8, 2, 0)
    with pytest.raises(NotImplementedError, match="P=1"):
        tr.trial_rollout(step, *args, con=(con[0][:, :1], con[1][:, :1], con[2][:, :1], con[3]))
    with pytest.raises(NotImplementedError, match="W=33"):
        tr.trial_rollout(step, torch.ones(33, device=dev), *args[1:], con=con)
    with pytest.raises(TypeError, match="float32"):
        tr.trial_rollout(step, *(a.double() for a in args), con=con)


def _dense_inputs(dev, n, m, seed=4, Bsz=BR):
    """Lane-minor dense backward operands: SPD lxx/luu, f and lux nonzero,
    a per-lane reg; lane min(5, B-1) broken at knots 2 and 5, lane B-1 at
    the last."""
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None, :, :, None] + 0.05 * rng.standard_normal((NK, n, n, Bsz))
    Bm = 0.3 * rng.standard_normal((NK, n, m, Bsz))
    f = 0.01 * rng.standard_normal((NK, n, Bsz))
    Wx = rng.standard_normal((NK + 1, n, n, Bsz))
    lxx = np.einsum("kijb,kljb->kilb", Wx, Wx) / n + np.eye(n)[None, :, :, None]
    Wu = rng.standard_normal((NK, m, m, Bsz))
    luu = np.einsum("kijb,kljb->kilb", Wu, Wu) / m + np.eye(m)[None, :, :, None]
    luu[[2, 5], :, :, min(5, Bsz - 1)] = -10.0 * np.eye(m)
    luu[NK - 1, :, :, Bsz - 1] = -10.0 * np.eye(m)
    lux = 0.02 * rng.standard_normal((NK, m, n, Bsz))
    lx = rng.standard_normal((NK + 1, n, Bsz))
    lu = rng.standard_normal((NK, m, Bsz))
    reg = 0.01 * rng.random(Bsz)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return [t(a) for a in (A, Bm, f, lxx, luu, lux, lx, lu, reg)]


@pytest.mark.parametrize("n, m", [(4, 2), (12, 4), (2, 1), (6, 3)])
@pytest.mark.parametrize("with_f, with_lux", [(True, True), (True, False), (False, True),
                                               (False, False)])
@pytest.mark.parametrize("Bsz", [1, 33, 1000, BR])
def test_riccati_dense_kernel_matches_plain(dev, n, m, with_f, with_lux, Bsz):
    """Every f/lux instantiation at every (n, m), with ragged lane tiles
    (B = 1, 33, 1000, 300 against blocks of 8, 16 and 32 lanes); B = 1 and
    33 take the one-float copies, the others the 16-byte ones."""
    from altro_tpu_torch.ops import riccati_dense as rd
    from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref

    A, Bm, f, lxx, luu, lux, lx, lu, reg = _dense_inputs(dev, n, m, Bsz=Bsz)
    f = f if with_f else None
    lux = lux if with_lux else None
    before = rd.LAUNCHES
    gk = rd.riccati_backward_dense(A, Bm, f, lxx, luu, lux, lx, lu, reg)
    gr = riccati_backward_ref(A, Bm, lxx, luu, lx, lu, reg, lux=lux, f=f)
    torch.cuda.synchronize()
    assert rd.LAUNCHES == before + 1
    assert float((gk.K - gr.K).abs().max()) < 1e-4
    assert float((gk.d - gr.d).abs().max()) < 1e-4
    assert float(((gk.P - gr.P).abs() / (1 + gr.P.abs())).max()) < 1e-5
    assert float(((gk.p - gr.p).abs() / (1 + gr.p.abs())).max()) < 1e-5
    assert float(((gk.delta_V - gr.delta_V).abs() / (1 + gr.delta_V.abs())).max()) < 1e-5
    assert torch.equal(gk.ok, gr.ok) and torch.equal(gk.fail_index, gr.fail_index)
    assert int(gk.fail_index[min(5, Bsz - 1)]) == 2
    if Bsz > 5:
        assert int(gk.fail_index[Bsz - 1]) == NK - 1
    assert int((~gk.ok).sum()) == min(2, Bsz)


def test_riccati_dense_kernel_refuses_what_it_does_not_implement(dev):
    from altro_tpu_torch.ops import riccati_dense as rd

    A, Bm, f, lxx, luu, lux, lx, lu, reg = _dense_inputs(dev, 4, 2)
    with pytest.raises(TypeError, match="float32"):
        rd.riccati_backward_dense(A.double(), Bm, f, lxx, luu, lux, lx, lu, reg)
    with pytest.raises(ValueError, match="contiguous"):
        rd.riccati_backward_dense(A.transpose(1, 2), Bm, f, lxx, luu, lux, lx, lu, reg)
    with pytest.raises(NotImplementedError, match="n=4, m=1"):
        rd.riccati_backward_dense(A, Bm[:, :, :1], f, lxx, luu[:, :1, :1], lux[:, :1], lx,
                                  lu[:, :1], reg)


def _kernel_launches():
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.ops import riccati_dense as rd
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.ops import rollout_grid as rg
    from altro_tpu_torch.ops import trial_rollout as tr

    return {m.__name__: m.LAUNCHES for m in (rb, rd, rl, rg, tr)}


def test_solve_tiled_plain_grid_on_card_tracks_plain_path(dev):
    """solve_tiled of a small quadrotor batch with pallas_rollout_tiled=False:
    the backward kernel (diagonal (12, 4)) launches and the trial-grid
    kernel does not; the f32 solve agrees with the plain CPU path (f64) on
    every lane's status, and its inputs to 1e-2 (each solve stops at
    stationarity 1e-3)."""
    import dataclasses

    from altro_tpu_torch import mpc
    from altro_tpu_torch import tile_solver as tsv
    from altro_tpu_torch.parallel.batch import batch_init_state

    opts = mpc.quadrotor_options().replace(ls_armijo_only=True, pallas_backward=False,
                                           pallas_rollout_tiled=False)
    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        prob = mpc.quadrotor_waypoint_problem(N=12, dtype=dtype, device=device)
        x0 = mpc.quadrotor_initial_states(16, seed=2, dtype=dtype, device=device)
        st = dataclasses.replace(batch_init_state(prob, 16),
                                 u=torch.full((16, 12, 4), mpc.QUAD_HOVER, dtype=dtype,
                                              device=device))
        prob = dataclasses.replace(prob, x0=tsv.batch_to_lanes(x0))
        before = _kernel_launches()
        out.append(tsv.solve_tiled(prob, tsv.state_to_lanes(st), opts))
        after = _kernel_launches()
        launched = {k for k in after if after[k] > before[k]}
        assert launched == ({"altro_tpu_torch.ops.riccati_backward"} if device == dev else set())
    (sa, a), (sb, b) = out
    assert torch.equal(a.status.cpu(), b.status)
    assert float((sa.u.double().cpu() - sb.u).abs().max()) < 1e-2


def test_refused_problem_launches_nothing(dev):
    """A (4, 1) problem (a shape the kernels lack) on the card is refused
    by solve_tiled before the open-loop rollout, with every kernel's
    reason, and launches nothing."""
    import dataclasses

    from altro_tpu_torch import mpc
    from altro_tpu_torch import tile_solver as tsv
    from altro_tpu_torch.parallel.batch import batch_init_state
    from altro_tpu_torch.problem import Problem, lqr_cost_from_reference

    N, Bsz, n = 6, 4, 4
    kw = dict(dtype=torch.float32, device=dev)

    def step(x, u, h, k):
        return torch.stack([x[i] + h * x[i + 1] for i in range(n - 1)] + [x[n - 1] + h * u[0]])

    cost = lqr_cost_from_reference(torch.ones((N + 1, n), **kw), torch.ones((N + 1, 1), **kw),
                                   torch.zeros((N + 1, n), **kw), torch.zeros((N + 1, 1), **kw))
    prob = Problem(N=N, n=n, m=1, dynamics=step, dynamics_jac=None, constraints=(), cost=cost,
                   h=torch.full((N,), 0.1, **kw), x0=torch.zeros(n, **kw))
    st = tsv.state_to_lanes(batch_init_state(prob, Bsz))
    prob = dataclasses.replace(prob, x0=torch.zeros((n, Bsz), **kw))
    before = _kernel_launches()
    with pytest.raises(NotImplementedError, match="riccati_backward.*n=4, m=1.*rollout_grid"):
        tsv.solve_tiled(prob, st, mpc.bench_options()[0])
    torch.cuda.synchronize()
    assert _kernel_launches() == before


def test_vmap_solve_on_card_tracks_plain_path(dev):
    """Two quadrotor waypoint ticks through the dense kernel (f32) against
    the plain path on the CPU (f64): every lane's status, and plant states
    to 1e-2."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.ops import riccati_dense as rd

    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        prob = mpc.quadrotor_waypoint_problem(N=12, dtype=dtype, device=device)
        x0 = mpc.quadrotor_initial_states(16, seed=2, dtype=dtype, device=device)
        before = rd.LAUNCHES
        out.append(mpc.run_quadrotor_waypoints(prob, x0, ticks=2))
        assert (rd.LAUNCHES > before) == (device == dev)
    a, b = out
    assert torch.equal(a.status.cpu(), b.status)
    assert float((a.x_true.double().cpu() - b.x_true).abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# The quadrotor (n=12, m=4, rk4): its column step in rollout_grid.cu's
# three-threads-a-(lane, trial) kernel, its block step in trial_rollout.cu's
# three-lanes-a-trial kernel, and the (12, 4) instantiations of
# riccati_latency.cu
# ---------------------------------------------------------------------------

def _quad_rollout_inputs(dev, Bsz, Nk, W, seed=7):
    """The waypoint problem and grid operands of Bsz lanes around hover:
    small rotor imbalances and gains, as the solve gives them."""
    from altro_tpu_torch import mpc

    prob = mpc.quadrotor_waypoint_problem(N=Nk, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    xr = 0.02 * rng.standard_normal((Nk + 1, 12, Bsz))
    # a rotor imbalance of 0.01 N tips the body over within the 1.5 s horizon
    ur = mpc.QUAD_HOVER + 0.001 * rng.standard_normal((Nk, 4, Bsz))
    K = 0.005 * rng.standard_normal((Nk, 4, 12, Bsz))
    d = 0.002 * rng.standard_normal((Nk, 4, Bsz))
    rho = 1.0 + rng.random(Bsz)
    x0 = xr[0] + 0.01 * rng.standard_normal((12, Bsz))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return prob, (t(xr), t(ur), t(K), t(d), (), t(rho), t(0.5 ** np.arange(W)), t(x0))


def _check_quad_grid(dev, Bsz, Nk, W):
    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _quad_rollout_inputs(dev, Bsz, Nk, W)
    before = rg.LAUNCHES
    pk, xk = rg.rollout_grid(prob, *args)
    pr, xr = rg.rollout_grid_ref(prob, *args)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + 1
    assert pk.shape == (W, Bsz) and xk.shape == (W, Nk + 1, 12, Bsz)
    assert bool(torch.isfinite(pk).all())
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xr).abs().max()) < 1e-4 * max(1.0, float(xr.abs().max()))


@pytest.mark.parametrize("W", [1, 8, 9, 16])
@pytest.mark.parametrize("Bsz", [1, 7, 33, 1024, 2048])
def test_rollout_kernel_quadrotor_matches_plain(dev, Bsz, W):
    """The quadrotor's kernel (ten lanes of three threads a warp, four
    trial warps a block, 8-knot chunks opted in above 48 KB): ragged lane
    groups and blocks (B not a multiple of ten), trials past one block
    (W = 9, 16), the row's B=1024 and the main path's 2048, 30 knots (four
    staged chunks, the last one ragged)."""
    _check_quad_grid(dev, Bsz, 30, W)


@pytest.mark.parametrize("Nk", [1, 7, 8, 9, 15, 16, 17])
def test_rollout_kernel_quadrotor_chunk_edges(dev, Nk):
    """The same kernel with N + 1 knots at its 8-knot chunk edges (N=8:
    the last chunk holds only the terminal knot)."""
    _check_quad_grid(dev, 33, Nk, 8)


def _quad_trial_inputs(dev, Nk, W, seed=8):
    from altro_tpu_torch import mpc

    prob = mpc.quadrotor_waypoint_problem(N=Nk, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    xr = 0.05 * rng.standard_normal((Nk + 1, 12))
    xr[:, 2] += np.linspace(0.0, 0.5, Nk + 1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    c = prob.cost
    args = (t(0.5 ** np.arange(W)), t(xr[0] + 0.02 * rng.standard_normal(12)), t(xr),
            t(mpc.QUAD_HOVER + 0.001 * rng.standard_normal((Nk, 4))),
            t(0.005 * rng.standard_normal((Nk, 4, 12))), t(0.002 * rng.standard_normal((Nk, 4))),
            c.Q, c.q, c.R, c.r, c.c, prob.h)
    return prob.dynamics_tile, args


@pytest.mark.parametrize("W", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("Nk", [1, 7, 8, 9, 16, 17, 30, 31, 32, 33, 64, 65])
def test_trial_rollout_kernel_quadrotor_matches_plain(dev, W, Nk):
    """The three-lanes-a-trial kernel on the quadrotor's block step: W from
    one group to four chain warps (ten groups a warp), N at its 8-knot chunk
    edges and the row's N=30 (an open-loop quadrotor leaves hover within a
    few seconds, so the horizons stay short)."""
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args = _quad_trial_inputs(dev, Nk, W)
    before = tr.LAUNCHES
    pk, xk = tr.trial_rollout(step, *args)
    pr, xs = tr.trial_rollout_ref(step, *args)
    torch.cuda.synchronize()
    assert tr.LAUNCHES == before + 1
    assert pk.shape == (W,) and xk.shape == (W, Nk + 1, 12)
    assert bool(torch.isfinite(pk).all())
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xs).abs().max()) < 1e-4 * max(1.0, float(xs.abs().max()))


def test_trial_rollout_kernel_quadrotor_refuses_rows(dev):
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args = _quad_trial_inputs(dev, 30, 8)
    Nk = 30
    con = (torch.zeros((Nk + 1, 2, 12), device=dev), torch.zeros((Nk + 1, 2, 4), device=dev),
           torch.zeros((Nk + 1, 2), device=dev), 0.5)
    with pytest.raises(NotImplementedError, match=r"P=2.*quadrotor_rk4"):
        tr.trial_rollout(step, *args, con=con)


@pytest.mark.parametrize("diag_x, diag_u, with_lux, with_f", LATENCY_VARIANTS)
@pytest.mark.parametrize("Nk", [1, 30, 31, 32, 33, 63, 64, 65, 500])
def test_riccati_latency_kernel_12x4_matches_plain(dev, diag_x, diag_u, with_lux, with_f, Nk):
    """The (12, 4) instantiations (five compute warps, 32-knot chunks):
    every (diag_x, diag_u, lux, f) variant at the chunk edges, the row's
    N=30 and the long horizon, with planted failing knots."""
    _check_latency(dev, Nk, diag_x, diag_u, with_lux, with_f, 12, 4)


def test_quadrotor_rows_launch_their_kernels(dev):
    """Two ticks of each quadrotor row on the card (f32) against the same
    ticks on the plain path on the CPU (f64): the tiled row (B=64) launches
    the batched backward and the trial-grid kernels, the latency row the
    single-lane backward and trial-rollout kernels; statuses equal, plant
    states to 1e-2 (each solve stops at stationarity 1e-3)."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.ops import rollout_grid as rg
    from altro_tpu_torch.ops import trial_rollout as tr

    rows = {"tiled": (mpc.run_quadrotor_waypoints_tiled, 64, (rb, rg)),
            "latency": (mpc.run_quadrotor_latency, None, (rl, tr))}
    for name, (run, Bsz, kernels) in rows.items():
        out = []
        for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
            prob = mpc.quadrotor_waypoint_problem(N=30, dtype=dtype, device=device)
            x0 = mpc.quadrotor_initial_states(64, seed=1, dtype=dtype, device=device)
            before = [k.LAUNCHES for k in kernels]
            out.append(run(prob, x0 if Bsz else x0[0], ticks=2))
            launched = [k.LAUNCHES > b for k, b in zip(kernels, before)]
            assert all(launched) if device == dev else not any(launched), (name, launched)
        a, b = out
        assert torch.equal(a.status.cpu(), b.status), name
        assert float((a.x_true.double().cpu() - b.x_true).abs().max()) < 1e-2, name


# ---------------------------------------------------------------------------
# The other models' batched rows: the pendulum's midpoint column step in
# rollout_grid.cu (its two rows on u), riccati_dense.cu at (2, 1) and
# (6, 3) (above, in the backward tests), and both rows on the card
# ---------------------------------------------------------------------------

def _pendulum_rollout_inputs(dev, Bsz, W, P, Nk=30, seed=13):
    """The swing-up problem (its torque bound for P=2, none for P=0) and
    grid operands of Bsz lanes around a swing-up, reference torques on
    either side of the bound, nonzero duals."""
    import dataclasses

    from altro_tpu_torch import mpc

    prob = mpc.pendulum_swingup_problem(N=Nk, dtype=torch.float32, device=dev)
    if P == 0:
        prob = dataclasses.replace(prob, constraints=())
    rng = np.random.default_rng(seed)
    xr = np.stack([np.linspace(0.0, np.pi, Nk + 1)[:, None] + 0.3 * rng.standard_normal(
        (Nk + 1, Bsz)), rng.standard_normal((Nk + 1, Bsz))], axis=1)
    ur = 5.5 * np.sign(rng.standard_normal((Nk, 1, Bsz))) + rng.standard_normal((Nk, 1, Bsz))
    K = 0.5 * rng.standard_normal((Nk, 1, 2, Bsz))
    d = rng.standard_normal((Nk, 1, Bsz))
    z = np.abs(rng.standard_normal((Nk + 1, 2, Bsz)))
    rho = 1.0 + 9.0 * rng.random(Bsz)
    x0 = xr[0] + 0.05 * rng.standard_normal((2, Bsz))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    zs = (t(z),) if P else ()
    return prob, (t(xr), t(ur), t(K), t(d), zs, t(rho), t(0.5 ** np.arange(W)), t(x0))


@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("Bsz, W", [(1, 4), (33, 12), (1024, 8)])
def test_rollout_kernel_pendulum_matches_plain(dev, Bsz, W, P):
    """The <PendulumMidpoint, P> instantiations: ragged lane tiles, a trial
    count past one block's 8, and the row's B=1024, W=8, N=30 (four staged
    chunks, the last one ragged); at P=2 the rows lie on u."""
    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _pendulum_rollout_inputs(dev, Bsz, W, P)
    before = rg.LAUNCHES
    pk, xk = rg.rollout_grid(prob, *args)
    pr, xr = rg.rollout_grid_ref(prob, *args)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + 1
    assert pk.shape == (W, Bsz) and xk.shape == (W, 31, 2, Bsz)
    assert bool(torch.isfinite(pk).all())
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xr).abs().max()) < 1e-4 * max(1.0, float(xr.abs().max()))


def test_other_models_rows_launch_their_kernels(dev):
    """Two swing-up ticks (B=64) and one rocket solve (B=16) on the card
    (f32) against the same runs on the plain paths on the CPU (f64): the
    pendulum row launches the batched backward and the trial-grid kernels,
    the rocket row the batched backward alone; statuses equal (each rocket
    lane lands), plant states to 1e-2 and touchdowns within 1e-3 m. The
    rocket with `pallas_rollout_tiled` is refused on the card and launches
    nothing."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.ops import rollout_grid as rg
    from altro_tpu_torch.reference_problems import rocket_landing_problem

    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        prob = mpc.pendulum_swingup_problem(dtype=dtype, device=device)
        x0 = mpc.pendulum_initial_states(64, dtype=dtype, device=device)
        before = (rb.LAUNCHES, rg.LAUNCHES)
        out.append(mpc.run_pendulum_swingup_tiled(prob, x0, ticks=2))
        launched = [rb.LAUNCHES > before[0], rg.LAUNCHES > before[1]]
        assert all(launched) if device == dev else not any(launched), launched
    a, b = out
    assert torch.equal(a.status.cpu(), b.status)
    assert float((a.x_true.double().cpu() - b.x_true).abs().max()) < 1e-2

    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        prob, hover = rocket_landing_problem(dtype=dtype, device=device)
        x0s = mpc.rocket_initial_states(prob, 16)
        before = _kernel_launches()
        out.append(mpc.run_rocket_soc_tiled(prob, hover, x0s))
        after = _kernel_launches()
        launched = {k for k in after if after[k] > before[k]}
        assert launched == ({"altro_tpu_torch.ops.riccati_backward"} if device == dev else set())
    a, b = out
    assert torch.equal(a.status.cpu(), b.status) and int(b.status.abs().max()) == 0
    assert float((a.touchdown() - b.touchdown()).abs().max()) < 1e-3

    prob, hover = rocket_landing_problem(device=dev)
    before = _kernel_launches()
    with pytest.raises(NotImplementedError, match="trial-grid kernel"):
        mpc.run_rocket_soc_tiled(prob, hover, mpc.rocket_initial_states(prob, 4),
                                 opts=mpc.rocket_soc_options().replace(pallas_rollout_tiled=True))
    torch.cuda.synchronize()
    assert _kernel_launches() == before


# ---------------------------------------------------------------------------
# The batched solve under the reference's line searches: the per-lane
# machine on the card, and examples/batched_mpc.py's tick on riccati_dense.cu
# ---------------------------------------------------------------------------

def _merit_lanes(Bsz=96, seed=4):
    """Per-lane 1-D merits phi(a) = k0 + k1 a + k2 a^2 + k3 a^3: quadratics
    (either curvature, min at 0.05-2.5), cubics and an ascent lane, away
    from the ties where f32 and f64 part ways."""
    rng = np.random.default_rng(seed)
    k = np.zeros((4, Bsz))
    for b in range(Bsz):
        c = rng.uniform(0.05, 2.5)
        if b % 3 == 0:
            a = rng.choice([-1.0, 1.0]) * rng.uniform(0.5, 2.0)
            k[:3, b] = [a * c * c, -2 * a * c, a]
        elif b % 3 == 1:
            k[:, b] = [c * c + c ** 3, -2 * c - 3 * c * c, 1 + 3 * c, -1]
        else:
            k[:, b] = [1.0, 2.0, 1.0, 0.0]  # (a + 1)^2: not a descent direction
    return k


def _lane_machine(k, opts, device, dtype):
    from altro_tpu_torch import linesearch as tls

    kt = torch.as_tensor(k, dtype=dtype, device=device)

    def merit(a):
        return ((kt[3] * a + kt[2]) * a + kt[1]) * a + kt[0], (3 * kt[3] * a + 2 * kt[2]) * a + kt[1]

    zero = torch.zeros(k.shape[1], dtype=dtype, device=device)
    phi0, dphi0 = merit(zero)
    return tls.wolfe_line_search_lanes(lambda a: (*merit(a), torch.stack([a, merit(a)[0]])),
                                       phi0, dphi0, 1.0, opts,
                                       aux0=torch.stack([zero, phi0]))


@pytest.mark.parametrize("use_backtracking", [False, True], ids=["wolfe", "backtracking"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_lane_machine_on_card_matches_cpu(dev, dtype, use_backtracking):
    """`wolfe_line_search_lanes` on CUDA tensors against its CPU f64 run:
    codes and trial counts equal, alpha, phi, dphi and the payload to
    1e-12 in f64 and 1e-4 relative in f32."""
    from altro_tpu_torch import linesearch as tls

    k = _merit_lanes()
    opts = tls.LineSearchOptions(use_backtracking=use_backtracking)
    ref = _lane_machine(k, opts, "cpu", torch.float64)
    got = _lane_machine(k, opts, dev, dtype)
    assert torch.equal(got.code.cpu(), ref.code)
    assert torch.equal(got.n_iters.cpu(), ref.n_iters)
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-5)
    for name in ("alpha", "phi", "dphi"):
        np.testing.assert_allclose(getattr(got, name).double().cpu().numpy(),
                                   getattr(ref, name).numpy(), err_msg=name, **tol)
    np.testing.assert_allclose(got.aux.double().cpu().numpy(), ref.aux.numpy(), **tol)
    assert len(set(ref.n_iters.tolist())) >= 2


def test_batched_tracking_tick_launches_riccati_dense(dev):
    """One tick of examples/batched_mpc.py's loop through
    `batched_tracking_solver` (per-lane q and c, the sequential
    backtracking, f32): the dense backward kernel runs, and every lane
    matches the same tick on the plain backward on the card."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.ops import riccati_dense as rd

    prob = mpc.batched_tracking_problem(dtype=torch.float32, device=dev)
    x0 = mpc.batched_tracking_initial_states(64, dtype=torch.float32, device=dev)
    out = []
    for pallas in (True, False):
        before = rd.LAUNCHES
        out.append(mpc.run_batched_tracking(prob, x0, ticks=1,
                                            opts=mpc.batched_tracking_options(pallas)))
        assert (rd.LAUNCHES > before) == pallas
    a, b = out
    assert torch.equal(a.status, b.status) and torch.equal(a.iterations, b.iterations)
    assert bool(torch.isfinite(a.x_true).all())
    assert float((a.x_true - b.x_true).abs().max()) < 1e-4
    assert float((a.state.u - b.state.u).abs().max()) < 1e-3


def test_refused_batched_tracking_launches_nothing(dev):
    """On the card, `batched_tracking_solver` at a shape the dense kernel
    lacks and `solve_tiled` under `pallas_rollout_tiled` with what the
    grid kernel refuses as JAX's does (a per-lane constraint mask; the
    per-lane cost rows that it refused on the quadrotor until its
    LANE_COST instantiation came are taken now) are refused before
    anything launches."""
    import dataclasses

    from altro_tpu_torch import mpc
    from altro_tpu_torch import tile_solver as tsv
    from altro_tpu_torch.options import SolverOptions
    from altro_tpu_torch.parallel.batch import batch_init_state, batched_tracking_solver
    from altro_tpu_torch.problem import Problem, lqr_cost_from_reference

    N, Bsz, n = 6, 4, 4
    kw = dict(dtype=torch.float32, device=dev)

    def step(x, u, h, k):
        return torch.stack([x[i] + h * x[i + 1] for i in range(n - 1)] + [x[n - 1] + h * u[0]])

    cost = lqr_cost_from_reference(torch.ones((N + 1, n), **kw), torch.ones((N + 1, 1), **kw),
                                   torch.zeros((N + 1, n), **kw), torch.zeros((N + 1, 1), **kw))
    prob = Problem(N=N, n=n, m=1, dynamics=step, dynamics_jac=None, constraints=(), cost=cost,
                   h=torch.full((N,), 0.1, **kw), x0=torch.zeros(n, **kw))
    before = _kernel_launches()
    with pytest.raises(NotImplementedError, match="riccati_dense.*n=4, m=1"):
        batched_tracking_solver(prob, SolverOptions(pallas_backward=True))(
            torch.zeros((Bsz, n), **kw), torch.zeros((Bsz, N + 1, n), **kw),
            torch.zeros((Bsz, N + 1), **kw), batch_init_state(prob, Bsz))
    from altro_tpu_torch.io.scotty import load_scotty

    bike = mpc.scotty_problem(load_scotty(), N=N, dtype=torch.float32, device=dev)
    spec = bike.constraints[0]
    tiled = dataclasses.replace(
        bike, x0=bike.x0[:, None].expand(-1, Bsz).contiguous(),
        constraints=(dataclasses.replace(
            spec, active=spec.active[:, None].expand(-1, Bsz).contiguous()),))
    with pytest.raises(NotImplementedError, match="per-lane active mask"):
        tsv.solve_tiled(tiled, tsv.state_to_lanes(batch_init_state(bike, Bsz)),
                        mpc.bench_options()[0])
    torch.cuda.synchronize()
    assert _kernel_launches() == before


# ---------------------------------------------------------------------------
# The single-lane models: riccati_latency.cu at the rocket's (6, 3) (two
# compute warps) and the cart-pole's (4, 1), both paths on the card, and
# `solve_tiled` with symmetrize_ctg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diag_x, diag_u, with_lux, with_f", LATENCY_VARIANTS)
@pytest.mark.parametrize("Nk", [1, 31, 32, 33, 60, 64, 65, 100])
@pytest.mark.parametrize("n, m", [(6, 3), (4, 1)])
def test_riccati_latency_kernel_6x3_4x1_matches_plain(dev, n, m, diag_x, diag_u, with_lux,
                                                      with_f, Nk):
    """The (6, 3) instantiations (two compute warps meeting at the named
    barrier, 32-knot chunks, shared memory opted in above 48 KB) and the
    (4, 1) ones (one warp, 64-knot chunks): every (diag_x, diag_u, lux, f)
    variant at the chunk edges and the paths' N (60, 100), with planted
    failing knots."""
    _check_latency(dev, Nk, diag_x, diag_u, with_lux, with_f, n, m)


def test_single_lane_models_launch_the_latency_kernel(dev):
    """The rocket landing (N=60) and 30 iterations of the cart-pole
    swing-up on the card in f32: neither is refused, each launches the
    latency kernel (the rocket's dense with lux, the cart-pole's
    diagonal), and the rocket touches down."""
    from altro_tpu_torch import mpc, solver
    from altro_tpu_torch import reference_problems as rp
    from altro_tpu_torch.ops import riccati_latency as rl

    prob, hover = rp.rocket_landing_problem(N=60, device=dev)
    assert solver.single_lane_refusal(prob, mpc.rocket_landing_options()) is None
    before = rl.LAUNCHES
    res = mpc.run_rocket_landing(prob, hover)
    assert rl.LAUNCHES > before
    m = mpc.rocket_metrics(res)
    assert m["finite"] and m["r_N"] < 1e-4 and m["v_N"] < 1e-4, m

    prob, st = rp.cartpole_swingup_problem(device=dev)
    opts = mpc.cartpole_swingup_options(30)
    assert solver.single_lane_refusal(prob, opts) is None
    before = rl.LAUNCHES
    res = mpc.run_cartpole_swingup(prob, st, opts)
    assert rl.LAUNCHES >= before + 30 and res.metrics()["finite"]


def test_solve_tiled_symmetrize_on_card_equals_plain_option(dev):
    """`solve_tiled` with symmetrize_ctg=True on the card (the main path's
    problem, 64 lanes, f32) launches the backward kernel and gives the
    symmetrize_ctg=False run bit for bit."""
    import dataclasses

    from altro_tpu_torch import mpc
    from altro_tpu_torch import tile_solver as tsv
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.parallel.batch import batch_init_state

    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=12, device=dev)
    x0 = mpc.perturbed_initial_states(ref, 64, seed=1, device=dev)
    state = tsv.state_to_lanes(batch_init_state(prob, 64))
    prob = dataclasses.replace(prob, x0=tsv.batch_to_lanes(x0))
    opts = mpc.bench_options(iterations_max=4)[0]
    out = []
    for sym in (True, False):
        before = rb.LAUNCHES
        out.append(tsv.solve_tiled(prob, state, opts.replace(symmetrize_ctg=sym)))
        assert rb.LAUNCHES > before
    (sa, ta), (sb, tb) = out
    assert torch.equal(ta.status, tb.status) and torch.equal(ta.iterations, tb.iterations)
    assert torch.equal(sa.x, sb.x) and torch.equal(sa.u, sb.u)


def _check_pend_trial(dev, Nk, W, P, rows):
    """The one-lane-a-trial kernel on the pendulum's midpoint block step
    against its plain version on `mpc.trial_operands("pendulum", ...)`: phi to
    1e-4 relative, states to 1e-4 of their scale."""
    from altro_tpu_torch.mpc import trial_operands
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args, con = trial_operands("pendulum", Nk, W, P, rows=rows, device=dev)
    before = tr.LAUNCHES
    pk, xk = tr.trial_rollout(step, *args, con=con)
    pr, xs = tr.trial_rollout_ref(step, *args, con=con)
    torch.cuda.synchronize()
    assert tr.LAUNCHES == before + 1
    assert pk.shape == (W,) and xk.shape == (W, Nk + 1, 2)
    assert bool(torch.isfinite(pk).all())
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xs).abs().max()) < 1e-4 * max(1.0, float(xs.abs().max()))


@pytest.mark.parametrize("P, rows", [(0, "bounds"), (2, "bounds"), (2, "state")],
                         ids=["0", "2", "2-state"])
@pytest.mark.parametrize("W", [1, 8, 32])
@pytest.mark.parametrize("Nk", [1, 7, 8, 9, 30, 31, 32, 33, 64, 65])
def test_trial_rollout_kernel_pendulum_matches_plain(dev, P, rows, W, Nk):
    """W from one lane to the warp, N at its 32-knot chunk edges and the
    facade's N=30; at P = 2 the bound rows the facade's solve forms, and
    random rows in x and u active at every knot (their state terms and
    the terminal knot's rows)."""
    _check_pend_trial(dev, Nk, W, P, rows)


def test_trial_rollout_kernel_pendulum_refuses_other_rows(dev):
    from altro_tpu_torch.mpc import trial_operands
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args, _ = trial_operands("pendulum", 30, 8, 0, device=dev)
    con = (torch.zeros((31, 1, 2), device=dev), torch.zeros((31, 1, 1), device=dev),
           torch.zeros((31, 1), device=dev), 0.5)
    before = tr.LAUNCHES
    with pytest.raises(NotImplementedError, match=r"P=1.*pendulum_midpoint"):
        tr.trial_rollout(step, *args, con=con)
    assert tr.LAUNCHES == before


def test_facade_block_step_launches_both_kernels(dev):
    """tests/test_api.py:250-293's configuration through the facade on the
    card in f32: with the block step the solve launches the pendulum trial
    kernel and the (2, 1) latency kernel, and agrees with the plain grid;
    a (3, 2) facade problem launches the latency kernel's (3, 2)
    instantiation (refused before it had one)."""
    from altro_tpu_torch import ALTROSolver
    from altro_tpu_torch.mpc import pendulum_block_step_solver as build
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.ops import trial_rollout as tr

    tile, plain = build(True, device=dev), build(False, device=dev, pallas_rollout=False)
    before = (rl.LAUNCHES, tr.LAUNCHES)
    st = tile.solve()
    assert rl.LAUNCHES > before[0] and tr.LAUNCHES > before[1]
    assert plain.solve() == st
    assert plain.get_iterations() == tile.get_iterations()
    assert float((tile.state.u - plain.state.u).abs().max()) < 1e-3

    s = ALTROSolver(10, device=dev)
    s.set_dimension(3, 2)
    s.set_time_step(0.1)
    s.set_explicit_dynamics(lambda x, u, h, k: torch.stack(
        [x[0] + x[1] * h, x[1] + (u[0] - u[1] * x[1]) * h, x[2] + x[0] * h]))
    s.set_lqr_cost([1.0, 1.0, 0.5], [0.1, 0.1], [1.0, 0.0, 0.0], [0.0, 0.0])
    s.initialize()
    before = rl.LAUNCHES
    s.solve()  # (3, 2) runs on its instantiation since the obstacle row's slice
    assert rl.LAUNCHES > before
    assert bool(torch.isfinite(s.state.x).all())


# ---------------------------------------------------------------------------
# The instantiations of the obstacle row's slice: the bicycle at P=4 and the
# double integrator's exact step in the trial rollout, the double
# integrator's column step in the grid, (3, 2) in the latency backward
# ---------------------------------------------------------------------------

def _check_trial(dev, model, Nk, W, P, rows):
    """The trial-rollout kernel against its plain version on
    `mpc.trial_operands`: phi to 1e-4 relative, states to 1e-4 of scale."""
    from altro_tpu_torch.mpc import trial_operands
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args, con = trial_operands(model, Nk, W, P, rows=rows, device=dev)
    before = tr.LAUNCHES
    pk, xk = tr.trial_rollout(step, *args, con=con)
    pr, xs = tr.trial_rollout_ref(step, *args, con=con)
    torch.cuda.synchronize()
    assert tr.LAUNCHES == before + 1
    assert pk.shape == (W,) and xk.shape == (W, Nk + 1, 4)
    assert bool(torch.isfinite(pk).all())
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xs).abs().max()) < 1e-4 * max(1.0, float(xs.abs().max()))


@pytest.mark.parametrize("rows", ["groups", "state"])
@pytest.mark.parametrize("W", [1, 8, 32])
@pytest.mark.parametrize("Nk", [1, 30, 60, 63, 64, 65, 128, 500])
def test_trial_rollout_kernel_bicycle_p4_matches_plain(dev, rows, W, Nk):
    """The two-lanes-a-trial kernel at P=4: two groups, one off on the
    second half of the horizon (its rows zero there), or random rows in x
    and u active at every knot, the terminal knot's included; N at the
    64-knot chunk edges and the solve's 500."""
    _check_trial(dev, "bicycle", Nk, W, 4, rows)


@pytest.mark.parametrize("P", [0, 2, 4])
@pytest.mark.parametrize("W", [1, 8, 32])
@pytest.mark.parametrize("Nk", [1, 10, 30, 31, 32, 33, 64, 65])
def test_trial_rollout_kernel_double_integrator_matches_plain(dev, P, W, Nk):
    """The one-lane-a-trial kernel on the double integrator's exact step
    (`trial_rollout_lane_kernel<DoubleIntegrator, P>`), N at its 32-knot
    chunk edges and the facade's N=10."""
    _check_trial(dev, "double_integrator", Nk, W, P, "state")


@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("Bsz, W", [(1, 4), (33, 12), (1024, 8)])
def test_rollout_kernel_double_integrator_matches_plain(dev, Bsz, W, P):
    """The <DoubleIntegrator, P> instantiations of the grid: ragged lane
    tiles, a trial count past one block's 8, B=1024, W=8, N=30; at P=2
    random rows in x and u active at every knot."""
    from altro_tpu_torch.mpc import double_integrator_grid_operands
    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = double_integrator_grid_operands(Bsz, 30, W, P, device=dev)
    before = rg.LAUNCHES
    pk, xk = rg.rollout_grid(prob, *args)
    pr, xr = rg.rollout_grid_ref(prob, *args)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + 1
    assert pk.shape == (W, Bsz) and xk.shape == (W, 31, 4, Bsz)
    assert bool(torch.isfinite(pk).all())
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xr).abs().max()) < 1e-4 * max(1.0, float(xr.abs().max()))


@pytest.mark.parametrize("diag_x, diag_u, with_lux, with_f", LATENCY_VARIANTS)
@pytest.mark.parametrize("Nk", [1, 10, 63, 64, 65, 129])
def test_riccati_latency_kernel_3x2_matches_plain(dev, diag_x, diag_u, with_lux, with_f, Nk):
    """The (3, 2) instantiations (the first odd n: 3-, 9- and 6-float
    per-knot arrays), every variant at the hetero problem's N=10 and the
    64-knot chunk edges, with planted failing knots."""
    _check_latency(dev, Nk, diag_x, diag_u, with_lux, with_f, 3, 2)


def test_double_integrator_facade_launches_both_kernels(dev):
    """tests/test_api.py:54's problem with the block step (the goal a
    terminal cost) in f32 on the card at the bench's 1e-3 (at 1e-4 the
    f32 floor decides the status, in JAX too): the solve launches the
    trial kernel at P=4 and the (4, 2) latency kernel and agrees with the
    plain grid."""
    from altro_tpu_torch.mpc import double_integrator_block_step_solver as build
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.ops import trial_rollout as tr

    tile = build(True, device=dev, tol_stationarity=1e-3)
    plain = build(False, device=dev, pallas_rollout=False, tol_stationarity=1e-3)
    before = (rl.LAUNCHES, tr.LAUNCHES)
    st = tile.solve()
    assert rl.LAUNCHES > before[0] and tr.LAUNCHES > before[1]
    assert plain.solve() == st == 0
    assert float((tile.state.u - plain.state.u).abs().max()) < 1e-5


def test_obstacle_paths_on_card(dev):
    """The obstacle row's solve (3 ticks of 64 lanes) launches the dense
    backward kernel under both Hessians; the single-lane loop (2 ticks)
    launches the (4, 2) latency kernel."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_dense as rd
    from altro_tpu_torch.ops import riccati_latency as rl

    ref = load_scotty()
    prob = mpc.obstacle_problem(ref, device=dev)
    x0 = mpc.obstacle_initial_states(ref, 64, device=dev)
    for exact in (False, True):
        before = rd.LAUNCHES
        res = mpc.run_obstacle_mpc(prob, ref, x0, ticks=3, opts=mpc.obstacle_options(exact=exact))
        assert rd.LAUNCHES > before
        assert bool(torch.isfinite(res.x_true).all())
    before = rl.LAUNCHES
    loop = mpc.run_obstacle_loop(ref, True, ticks=2, opts=mpc.obstacle_loop_options(1e-3),
                                 device=dev)
    assert rl.LAUNCHES > before and len(loop.status) == 2


# The per-lane slice: rollout_grid.cu's LANE_COST instantiations (every cost
# row and h one row per lane), the tracking row on both batched kernels, the
# single-lane options and the vmapped verbosity on the card.


def _f32_floor(prob, args):
    """The plain grid's own float32 rounding of phi on these inputs: its
    largest relative distance (to max(|phi|, 1)) from the same rollout in
    float64 on the CPU."""
    import dataclasses

    from altro_tpu_torch.ops import rollout_grid as rg

    def f64(t):
        return tuple(f64(a) for a in t) if isinstance(t, tuple) else t.double().cpu()

    c = prob.cost
    prob64 = dataclasses.replace(
        prob, cost=type(c)(*(f64(getattr(c, f)) for f in ("Q", "R", "q", "r", "c"))),
        h=f64(prob.h), x0=f64(prob.x0),
        constraints=tuple(dataclasses.replace(g, active=g.active.cpu(), jac=None)
                          for g in prob.constraints))
    p32 = rg.rollout_grid_ref(prob, *args)[0].double().cpu()
    p64 = rg.rollout_grid_ref(prob64, *f64(tuple(args)))[0]
    return float(((p32 - p64).abs() / p64.abs().clamp(min=1.0)).max())


def _check_lane_cost(prob, args, Bsz, W, Nk, n):
    """The LANE_COST kernel against the plain grid on the same per-lane
    rows (`mpc.per_lane_rows`): phi to 1e-4 relative (chip_smoke.py's gate),
    or, where the plain grid's own float32 rounding of these inputs is
    larger (`_f32_floor`: the pendulum at P=0 reaches 1.4e-4 with per-lane
    steps), to twice that; states to 1e-4 of their scale."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.ops import rollout_grid as rg

    prob = mpc.per_lane_rows(prob, Bsz, seed=Bsz)
    before = (rg.LAUNCHES, rg.LANE_COST_LAUNCHES)
    pk, xk = rg.rollout_grid(prob, *args)
    pr, xr = rg.rollout_grid_ref(prob, *args)
    torch.cuda.synchronize()
    assert (rg.LAUNCHES, rg.LANE_COST_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert pk.shape == (W, Bsz) and xk.shape == (W, Nk + 1, n, Bsz)
    assert bool(torch.isfinite(pk).all())
    dphi = float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max())
    assert dphi < 1e-4 or dphi < 2 * _f32_floor(prob, args), dphi
    assert float((xk - xr).abs().max()) < 1e-4 * max(1.0, float(xr.abs().max()))


@pytest.mark.parametrize("frame", ["cog", "rear", "front"])
@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("Bsz, W", [(1, 4), (33, 12), (2000, 8)])
def test_rollout_kernel_lane_cost_matches_plain(dev, Bsz, W, P, frame):
    """Every bicycle (frame, P) LANE_COST instantiation: per-lane Q, q, R,
    r, c and h (the steering rows active at the terminal knot), ragged
    lane tiles, a trial count past one block's 8, 20 knots."""
    prob, args = _rollout_inputs(dev, Bsz=Bsz, Nk=20, W=W, P=P, frame=frame)
    _check_lane_cost(prob, args, Bsz, W, 20, 4)


@pytest.mark.parametrize("model", ["pendulum", "double_integrator"])
@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("Bsz, W", [(33, 12), (1024, 8)])
def test_rollout_kernel_lane_cost_other_models_match_plain(dev, model, Bsz, W, P):
    """The pendulum's and the double integrator's LANE_COST instantiations
    (P 0 and 2; the double integrator's rows active at every knot)."""
    import dataclasses

    from altro_tpu_torch import mpc

    if model == "pendulum":
        prob, args = _pendulum_rollout_inputs(dev, Bsz, W, P)
        n = 2
    else:
        prob, args = mpc.double_integrator_grid_operands(Bsz, 30, W, P, device=dev)
        if P == 0:
            prob = dataclasses.replace(prob, constraints=())
        n = 4
    _check_lane_cost(prob, args, Bsz, W, 30, n)


def test_rollout_kernel_shared_rows_launch_the_shared_instantiation(dev):
    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _rollout_inputs(dev, Bsz=64, Nk=8, W=4)
    before = (rg.LAUNCHES, rg.LANE_COST_LAUNCHES)
    rg.rollout_grid(prob, *args)
    assert (rg.LAUNCHES, rg.LANE_COST_LAUNCHES) == (before[0] + 1, before[1])


@pytest.mark.parametrize("Bsz, W, Nk", [(1, 4, 8), (7, 9, 17), (33, 8, 30), (1024, 8, 30),
                                         (2048, 16, 30)])
def test_rollout_kernel_quadrotor_lane_cost_matches_plain(dev, Bsz, W, Nk):
    """The quadrotor's LANE_COST instantiation (one cost row and h a lane
    b in shared memory, ten lanes a warp): ragged lane groups, trials past
    one block, chunk edges, the row's B=1024 and the main path's 2048."""
    prob, args = _quad_rollout_inputs(dev, Bsz, Nk, W)
    _check_lane_cost(prob, args, Bsz, W, Nk, 12)


def test_grid_refuses_a_per_lane_mask(dev):
    """A constraint group with one mask column per lane: the kernel's
    affine rows are shared by all lanes (as JAX's kernel takes an
    unbatched constraint spec); refused before anything launches."""
    import dataclasses

    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _rollout_inputs(dev, Bsz=64, Nk=8, W=4)
    spec = prob.constraints[0]
    lanes = spec.active[:, None].expand(-1, 64).contiguous()
    prob = dataclasses.replace(prob, constraints=(dataclasses.replace(spec, active=lanes),))
    before = rg.LAUNCHES
    with pytest.raises(NotImplementedError, match="per-lane active mask"):
        rg.rollout_grid(prob, *args)
    assert rg.LAUNCHES == before


def test_tracking_tiled_on_card_tracks_plain_path(dev):
    """Two ticks of the tracking row at 16 lanes on both batched kernels
    (the grid's LANE_COST instantiation) agree with the plain CPU path in
    f64: statuses equal, plant states within 1e-2."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.ops import rollout_grid as rg

    ref = load_scotty()
    starts = mpc.tracking_tiled_starts(16)
    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        prob = mpc.scotty_problem(ref, N=30, dtype=dtype, device=device)
        x0 = mpc.tracking_tiled_initial_states(ref, starts, dtype=dtype, device=device)
        before = (rb.LAUNCHES, rg.LANE_COST_LAUNCHES)
        out.append(mpc.run_tracking_tiled(prob, ref, starts, x0, ticks=2))
        launched = (rb.LAUNCHES > before[0], rg.LANE_COST_LAUNCHES > before[1])
        assert launched == ((True, True) if device == dev else (False, False))
    a, b = out
    assert float((a.status.cpu() == b.status).double().mean()) >= 0.9
    assert float((a.x_true.double().cpu() - b.x_true).abs().max()) < 1e-2


@pytest.mark.parametrize("variant", ["rti_mode", "light_grid", "pallas_backward"])
def test_single_lane_options_on_card(dev, variant):
    """The Scotty window under rti_mode, the light-payload grid and
    pallas_backward in f32 on the card: SUCCESS; the latency kernel
    launches unless pallas_backward (JAX's unbatched fused backward is its
    scan: no kernel), and the trial-rollout kernel never (JAX's light grid
    and RTI step take no merit_grid)."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.ops import trial_rollout as tr

    kw = {"rti_mode": dict(rti_mode=True, ls_phase_split=True),
          "light_grid": dict(parallel_linesearch=True, ls_phase_split=True,
                             ls_grid_x_only=False, ls_armijo_only=True, ls_max_iters=24),
          "pallas_backward": dict(pallas_backward=True)}[variant]
    prob, st = mpc.scotty_reference_problem(load_scotty(), N=30, device=dev)
    before = (rl.LAUNCHES, tr.LAUNCHES)
    res = mpc.run_bicycle_window(prob, st, mpc.bicycle_window_options().replace(**kw))
    assert res.metrics()["status"] == 0
    assert (rl.LAUNCHES > before[0]) == (variant != "pallas_backward")
    assert tr.LAUNCHES == before[1]


def test_vmapped_verbosity_on_card(dev, capsys):
    """One vmapped tick at 3 lanes with Verbosity.INNER and a callback: a
    first and a last line per lane, one line and one call per lane and
    trip."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.options import Verbosity

    calls = []
    prob = mpc.batched_tracking_problem(device=dev)
    x0 = mpc.batched_tracking_initial_states(3, device=dev)
    opts = mpc.batched_tracking_options().replace(verbose=Verbosity.INNER,
                                                  iteration_callback=lambda *a: calls.append(a))
    res = mpc.run_batched_tracking(prob, x0, ticks=1, opts=opts)
    out = capsys.readouterr().out
    trips = int(res.iterations.max())
    assert out.count("STARTING ALTRO") == 3 and out.count("ALTRO SOLVE FINISHED") == 3
    assert out.count("  iter = ") == 3 * trips and len(calls) == 3 * trips


# diff.implicit_solve's Gauss-Newton backward (ops/gn_backward.py): one lane on
# riccati_latency.cu, a vmapped batch on riccati_dense.cu through the operator's
# vmap rule; learned.py's loop on both.


def _gn_operands(dev, Bsz, Nk=20, seed=31):
    """Batch-major one-lane operands of the Gauss-Newton backward at (4, 2):
    A = I + 0.05 randn, B = 0.3 randn, SPD dense lxx and luu, a small lux,
    lx = 0 and lu = -w random (the implicit solve's LQR problem)."""
    rng = np.random.default_rng(seed)
    n, m = 4, 2

    def spd(count, d):
        Wm = rng.standard_normal((Bsz, count, d, d))
        return np.einsum("bkij,bklj->bkil", Wm, Wm) / d + np.eye(d)

    arrays = (np.eye(n) + 0.05 * rng.standard_normal((Bsz, Nk, n, n)),
              0.3 * rng.standard_normal((Bsz, Nk, n, m)), spd(Nk + 1, n), spd(Nk, m),
              0.02 * rng.standard_normal((Bsz, Nk, m, n)), np.zeros((Bsz, Nk + 1, n)),
              rng.standard_normal((Bsz, Nk, m)))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in arrays]


def _close_gains(a, b):
    K, d, P, p = a
    K2, d2, P2, p2 = b
    assert float((K - K2).abs().max()) < 1e-4
    assert float((d - d2).abs().max()) < 1e-4
    assert float(((P - P2).abs() / (1 + P2.abs())).max()) < 1e-5
    assert float(((p - p2).abs() / (1 + p2.abs())).max()) < 1e-5


@pytest.mark.parametrize("Bsz", [1, 33, 300, 1024])
def test_gn_backward_vmap_rule_matches_latency_kernel_and_plain(dev, Bsz):
    """The operator's vmap rule (the batched dense <4, 2, f=0, lux=1, diag=0>,
    one launch) against the one-lane latency kernel lane by lane and
    against the plain recursion."""
    from altro_tpu_torch.ops import riccati_dense as rd
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.ops.gn_backward import gn_backward

    ops = _gn_operands(dev, Bsz)
    reg = torch.zeros((), device=dev)
    before_d = rd.LAUNCHES
    batched = torch.func.vmap(lambda *a: gn_backward(*a, reg, True))(*ops)
    torch.cuda.synchronize()
    assert rd.LAUNCHES == before_d + 1
    plain = torch.func.vmap(lambda *a: gn_backward(*a, reg, False))(*ops)
    assert rd.LAUNCHES == before_d + 1
    _close_gains(batched, plain)
    lanes = sorted({0, Bsz // 2, Bsz - 1})
    before_l = rl.LAUNCHES
    for b in lanes:
        one = gn_backward(*(t[b] for t in ops), reg, True)
        _close_gains([g[b] for g in batched], one)
        _close_gains(one, [g[b] for g in plain])
    assert rl.LAUNCHES == before_l + len(lanes)


def test_implicit_solve_on_card(dev):
    """learned.py's task-loss gradient in float32 on the kernels (the solve's
    backward and the Gauss-Newton backward on riccati_latency.cu) against
    the float64 plain one on the card; its vmapped gradient over 4 lanes of
    x0 launches riccati_dense.cu; float64 on the kernels is refused."""
    import dataclasses

    from altro_tpu_torch import diff, learned
    from altro_tpu_torch.ops import riccati_dense as rd
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.options import SolverOptions

    plain = SolverOptions(pallas_latency_backward=False)
    grads = {}
    for dtype, opts in ((torch.float32, SolverOptions()), (torch.float64, plain)):
        theta = torch.zeros(3, dtype=dtype, device=dev, requires_grad=True)
        before = rl.LAUNCHES
        learned.task_loss(theta, opts).backward()
        grads[dtype] = theta.grad.double()
        assert (rl.LAUNCHES > before) == (dtype == torch.float32)
    rel = float(((grads[torch.float32] - grads[torch.float64]).abs()
                 / grads[torch.float64].abs().max()).max())
    assert rel < 1e-4, rel

    prob = learned.build_problem(torch.zeros(3, device=dev))

    def loss(x0):
        x, u = diff.implicit_solve(dataclasses.replace(prob, x0=x0))
        return torch.sum(x[-1] ** 2)

    x0s = prob.x0 + 0.1 * torch.arange(4, device=dev, dtype=torch.float32)[:, None]
    before = rd.LAUNCHES
    g = torch.func.vmap(torch.func.grad(loss))(x0s)
    assert rd.LAUNCHES == before + 1 and bool(torch.isfinite(g).all())
    with pytest.raises(NotImplementedError, match="riccati_latency.*float64"):
        learned.task_loss(torch.zeros(3, dtype=torch.float64, device=dev))


def test_implicit_solve_with_pallas_backward_runs_the_gauss_newton_kernels(dev):
    """`pallas_backward=True` leaves the Gauss-Newton backward on its kernels:
    one lane's gradient launches riccati_latency.cu's dense (4, 2) with lux,
    and vmap(grad) over 4 lanes of x0 riccati_dense.cu once more than its
    batched forward does (which launches it under `pallas_backward`); both
    match the plain backward."""
    import dataclasses

    from altro_tpu_torch import diff, learned
    from altro_tpu_torch.ops import riccati_dense as rd
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.options import SolverOptions

    prob = learned.build_problem(torch.zeros(3, device=dev))
    x0s = prob.x0 + 0.1 * torch.arange(4, device=dev, dtype=torch.float32)[:, None]

    def grad_of(opts):
        def loss(x0):
            x, u = diff.implicit_solve(dataclasses.replace(prob, x0=x0), opts=opts)
            return torch.sum(x[-1] ** 2) + 0.05 * torch.sum(u ** 2)

        return torch.func.grad(loss)

    fused = SolverOptions(pallas_backward=True)
    plain = fused.replace(pallas_latency_backward=False)
    gn_lane = (4, 2, False, False, True, False)
    before = rl.VARIANT_LAUNCHES[gn_lane]
    g1 = grad_of(fused)(x0s[0])
    assert rl.VARIANT_LAUNCHES[gn_lane] == before + 1

    def dense_launches(fn):
        before, before_l = rd.LAUNCHES, rl.LAUNCHES
        out = fn()
        assert rl.LAUNCHES == before_l
        return out, rd.LAUNCHES - before

    _, forward = dense_launches(lambda: torch.func.vmap(
        lambda x0: diff.implicit_solve(dataclasses.replace(prob, x0=x0), opts=fused)[0])(x0s))
    g, both = dense_launches(lambda: torch.func.vmap(grad_of(fused))(x0s))
    g_plain, forward_only = dense_launches(lambda: torch.func.vmap(grad_of(plain))(x0s))
    assert forward > 0 and both == forward + 1 and forward_only == forward
    scale = float(g_plain.abs().max())
    assert float((g - g_plain).abs().max()) < 1e-4 * scale
    assert float((g1 - g_plain[0]).abs().max()) < 1e-4 * scale
