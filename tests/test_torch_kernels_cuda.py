"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips unless torch.cuda.is_available() (decided
inside the fixture, never at import). On a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -p no:randomly -n 0

Small shapes with a ragged batch (B not a multiple of the block size),
the same comparisons as chip_smoke.py's parity phase.
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


def _rollout_inputs(dev, seed=1):
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty

    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=NK, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    xr = ref.x[: NK + 1, :, None] + 0.2 * rng.standard_normal((NK + 1, 4, BR))
    xr[:, 3] = np.sign(rng.standard_normal(BR)) * (1.07 + 0.02 * rng.standard_normal((NK + 1, BR)))
    ur = ref.u[:NK, :, None] + 0.02 * rng.standard_normal((NK, 2, BR))
    K = 0.002 * rng.standard_normal((NK, 2, 4, BR))
    d = 0.05 * rng.standard_normal((NK, 2, BR))
    z = np.abs(rng.standard_normal((NK + 1, 2, BR)))
    rho = 1.0 + 9.0 * rng.random(BR)
    x0 = xr[0] + 0.01 * rng.standard_normal((4, BR))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return prob, (t(xr), t(ur), t(K), t(d), (t(z),), t(rho), t(0.5 ** np.arange(4)), t(x0))


def test_rollout_kernel_matches_plain(dev):
    from altro_tpu_torch.ops import rollout_grid as rg

    prob, args = _rollout_inputs(dev)
    before = rg.LAUNCHES
    pk, xk = rg.rollout_grid(prob, *args)
    pr, xr = rg.rollout_grid_ref(prob, *args)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + 1
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
