"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips unless torch.cuda.is_available() (decided
inside the fixture, never at import). On a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -p no:randomly -n 0

Small shapes with a ragged batch (B not a multiple of the block size)
for the batched kernels, and a 150-knot horizon (three staged chunks,
the last ragged) for the single-lane ones: the same comparisons as
chip_smoke.py's parity phases.
"""

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


def _backward_inputs(dev, seed=0):
    rng = np.random.default_rng(seed)
    n, m = 4, 2
    A = np.eye(n)[None, :, :, None] + 0.05 * rng.standard_normal((NK, n, n, BR))
    Bm = 0.3 * rng.standard_normal((NK, n, m, BR))
    lxx = np.abs(rng.standard_normal((NK + 1, n, BR))) + 0.1
    luu = np.abs(rng.standard_normal((NK, m, BR))) + 0.1
    lx = rng.standard_normal((NK + 1, n, BR))
    lu = rng.standard_normal((NK, m, BR))
    reg = 0.01 * rng.random(BR)
    luu[2, :, 5] = -10.0
    luu[5, :, 5] = -10.0
    luu[NK - 1, 1, 299] = -10.0
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
            for a in (A, Bm, lxx, luu, lx, lu, reg)]


def test_riccati_kernel_matches_plain(dev):
    from altro_tpu_torch.ops import riccati_backward as rb

    args = _backward_inputs(dev)
    before = rb.LAUNCHES
    gk = rb.riccati_backward(*args, diag_cost=True)
    gr = rb.riccati_backward_ref(*args)
    torch.cuda.synchronize()
    assert rb.LAUNCHES == before + 1
    assert float((gk.K - gr.K).abs().max()) < 1e-4
    assert float((gk.d - gr.d).abs().max()) < 1e-4
    assert float(((gk.P - gr.P).abs() / (1 + gr.P.abs())).max()) < 1e-5
    assert torch.equal(gk.ok, gr.ok) and torch.equal(gk.fail_index, gr.fail_index)
    assert int(gk.fail_index[5]) == 2 and int(gk.fail_index[299]) == NK - 1
    assert int((~gk.ok).sum()) == 2


def test_riccati_kernel_refuses_what_it_does_not_implement(dev):
    from altro_tpu_torch.ops import riccati_backward as rb

    A, Bm, lxx, luu, lx, lu, reg = _backward_inputs(dev)
    with pytest.raises(NotImplementedError):
        rb.riccati_backward(A, Bm, lxx, luu, lx, lu, reg, diag_cost=False)
    with pytest.raises(TypeError):
        rb.riccati_backward(A.double(), Bm, lxx, luu, lx, lu, reg, diag_cost=True)
    with pytest.raises(ValueError):
        rb.riccati_backward(A.transpose(1, 2), Bm, lxx, luu, lx, lu, reg, diag_cost=True)


def _rollout_inputs(dev, seed=1, Bsz=BR, Nk=NK, W=4, P=2):
    """Scotty problem (steering bound for P=2, none for P=0) and rollout
    operands of Bsz lanes, Nk knots and W trials."""
    import dataclasses

    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty

    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=Nk, dtype=torch.float32, device=dev)
    if P == 0:
        prob = dataclasses.replace(prob, constraints=())
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


@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("Bsz, W", [(1, 4), (33, 12), (2000, 8)])
def test_rollout_kernel_matches_plain(dev, Bsz, W, P):
    """Ragged lane tiles (B = 1, 33, 2000 against 16-lane blocks), a trial
    count past one block's 8 (W=12) and 20 knots (three staged chunks of
    8, the first buffer reused)."""
    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _rollout_inputs(dev, Bsz=Bsz, Nk=20, W=W, P=P)
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


NL = 150  # single-lane horizon: three staged chunks of 64 knots, the last ragged


def _latency_inputs(dev, dense, seed=2):
    rng = np.random.default_rng(seed)
    n, m = 4, 2
    A = np.eye(n)[None] + 0.05 * rng.standard_normal((NL, n, n))
    Bm = 0.3 * rng.standard_normal((NL, n, m))
    if dense:
        Wm = rng.standard_normal((NL + 1, n, n))
        lxx = np.einsum("kij,klj->kil", Wm, Wm) / n + np.eye(n)
        Vm = rng.standard_normal((NL, m, m))
        luu = np.einsum("kij,klj->kil", Vm, Vm) / m + np.eye(m)
        luu[NL - 30] = -1e3 * np.eye(m)
        extra = dict(lux=0.05 * rng.standard_normal((NL, m, n)),
                     f=0.02 * rng.standard_normal((NL, n)))
    else:
        lxx = np.abs(rng.standard_normal((NL + 1, n))) + 0.1
        luu = np.abs(rng.standard_normal((NL, m))) + 0.1
        luu[70] = -10.0
        extra = {}
    lx = rng.standard_normal((NL + 1, n))
    lu = rng.standard_normal((NL, m))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return [t(a) for a in (A, Bm, lxx, luu, lx, lu)], {k: t(v) for k, v in extra.items()}


@pytest.mark.parametrize("dense", [False, True])
def test_riccati_latency_kernel_matches_plain(dev, dense):
    from altro_tpu_torch.ops import riccati_latency as rl

    args, extra = _latency_inputs(dev, dense)
    before = rl.LAUNCHES
    gk = rl.riccati_latency(*args, 0.01, **extra)
    gr = rl.riccati_latency_ref(*args, 0.01, **extra)
    torch.cuda.synchronize()
    assert rl.LAUNCHES == before + 1
    assert float((gk.K - gr.K).abs().max()) < 1e-4
    assert float((gk.d - gr.d).abs().max()) < 1e-4
    assert float(((gk.P - gr.P).abs() / (1 + gr.P.abs())).max()) < 1e-5
    assert bool(gk.ok) == bool(gr.ok) is False
    assert int(gk.fail_index) == int(gr.fail_index)
    with pytest.raises(TypeError):
        rl.riccati_latency(*(a.double() for a in args), 0.01)


@pytest.mark.parametrize("P", [0, 2])
def test_trial_rollout_kernel_matches_plain(dev, P):
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import trial_rollout as tr
    from altro_tpu_torch.ops.rollout_grid import affine_constraint_stacks

    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=NL, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(3)
    xr = ref.x[: NL + 1] + 0.1 * rng.standard_normal((NL + 1, 4))
    xr[:, 3] = 1.0 + 0.05 * rng.standard_normal(NL + 1)
    ur = ref.u[:NL] + 0.02 * rng.standard_normal((NL, 2))
    ur[:, 1] *= 0.1
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    c = prob.cost
    args = (t(0.5 ** np.arange(8)), t(xr[0]), t(xr), t(ur),
            t(0.002 * rng.standard_normal((NL, 2, 4))), t(0.05 * rng.standard_normal((NL, 2))),
            c.Q, c.q, c.R, c.r, c.c, prob.h)
    con = None
    if P:
        ax, au, g, act = affine_constraint_stacks(prob)
        rho = torch.tensor(3.0, device=dev)
        z = t(np.abs(rng.standard_normal((NL + 1, 2))))
        con = (rho * ax * act[..., None], rho * au * act[..., None], (z - rho * g) * act,
               1.0 / (2.0 * rho))
    before = tr.LAUNCHES
    pk, xk = tr.trial_rollout(prob.dynamics_tile, *args, con=con)
    pr, xs = tr.trial_rollout_ref(prob.dynamics_tile, *args, con=con)
    torch.cuda.synchronize()
    assert tr.LAUNCHES == before + 1
    assert float(((pk - pr).abs() / pr.abs().clamp(min=1.0)).max()) < 1e-4
    assert float((xk - xs).abs().max()) < 1e-4 * max(1.0, float(xs.abs().max()))


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


@pytest.mark.parametrize("n, m", [(4, 2), (12, 4)])
@pytest.mark.parametrize("with_f, with_lux", [(True, True), (True, False), (False, True),
                                               (False, False)])
@pytest.mark.parametrize("Bsz", [1, 33, 1000, BR])
def test_riccati_dense_kernel_matches_plain(dev, n, m, with_f, with_lux, Bsz):
    """Every f/lux instantiation at both (n, m), with ragged lane tiles
    (B = 1, 33, 1000, 300 against blocks of 8 and 16 lanes); B = 1 and 33
    take the one-float copies, the others the 16-byte ones."""
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
