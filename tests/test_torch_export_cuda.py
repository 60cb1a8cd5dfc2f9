"""The export slice on the card: the three operators
(altro_tpu_torch/ops/library.py) against their kernel wrappers bit for
bit, and CPU-traced f32 artifacts moved to the card (the row's options,
the default options with the strong-Wolfe search in the graph, and the
`_trial` form), which launch their kernels and match the live f32 tick
there.

Marked `cuda`: each test skips unless torch.cuda.is_available() (decided
inside the fixture, never at import). On a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_export_cuda.py -m cuda -p no:randomly --noconftest \
        -o addopts=""
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(dev, N=30, n=4, m=2, Bsz=None, bad=False, dense=False, seed=3):
    rng = np.random.default_rng(seed)
    lanes = () if Bsz is None else (Bsz,)

    def spd(count, d):
        Wm = rng.standard_normal((count, d, d) + lanes)
        sub = "kij,klj->kil" if Bsz is None else "kijb,kljb->kilb"
        eye = np.eye(d) if Bsz is None else np.eye(d)[:, :, None]
        return np.einsum(sub, Wm, Wm) / d + eye

    A = np.eye(n).reshape((1, n, n) + (1,) * len(lanes)) + 0.05 * rng.standard_normal(
        (N, n, n) + lanes)
    Bm = 0.2 * rng.standard_normal((N, n, m) + lanes)
    if dense:
        lxx, luu = spd(N + 1, n), spd(N, m)
    else:
        lxx = np.abs(rng.standard_normal((N + 1, n) + lanes)) + 0.1
        luu = np.abs(rng.standard_normal((N, m) + lanes)) + 0.1
    if bad:  # knot 4 indefinite: the retry raises reg until it factors
        luu[4] = -0.5 * (np.eye(m)[..., None] if (dense and Bsz) else
                         (np.eye(m) if dense else 1.0))
    lux = 0.02 * rng.standard_normal((N, m, n) + lanes) if dense else None
    lx = rng.standard_normal((N + 1, n) + lanes)
    lu = rng.standard_normal((N, m) + lanes)
    t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        a, dtype=torch.float32, device=dev).contiguous()
    return t(A), t(Bm), t(lxx), t(luu), t(lux), t(lx), t(lu)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("bad", [False, True])
def test_latency_operator_equals_wrapper(dev, dense, bad):
    from altro_tpu_torch.ops import library  # noqa: F401
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.options import SolverOptions
    from altro_tpu_torch.solver import _retry_loop

    A, Bm, lxx, luu, lux, lx, lu = _operands(dev, bad=bad, dense=dense)
    opts = SolverOptions()
    reg = torch.zeros((), device=dev)
    want, reg_w = _retry_loop(opts, lambda r: rl.riccati_latency(
        A, Bm, lxx, luu, lx, lu, r.reshape(1), lux=lux), reg)
    before = rl.LAUNCHES
    got = torch.ops.altro_tpu_torch.riccati_latency(
        A, Bm, lxx, luu, lux, None, lx, lu, reg, opts.reg_min, opts.reg_scaling,
        opts.reg_max_retries, True)
    assert rl.LAUNCHES > before
    for a, b in zip(got, (*want, reg_w)):
        assert torch.equal(a, b.reshape(a.shape))
    assert bool(got[5])
    assert (float(got[7]) > 0) == bad


@pytest.mark.parametrize("bad", [False, True])
def test_dense_operator_equals_wrapper(dev, bad):
    from altro_tpu_torch.ops import library  # noqa: F401
    from altro_tpu_torch.ops import riccati_dense as rd
    from altro_tpu_torch.ops import tile_iter as ti
    from altro_tpu_torch.options import SolverOptions

    A, Bm, lxx, luu, lux, lx, lu = _operands(dev, Bsz=37, bad=bad, dense=True)
    opts = SolverOptions()
    reg = torch.zeros(37, device=dev)
    want, reg_w = ti.retry_tiled(opts, lambda r: rd.riccati_backward_dense(
        A, Bm, None, lxx, luu, lux, lx, lu, r.contiguous()), reg)
    before = rd.LAUNCHES
    got = torch.ops.altro_tpu_torch.riccati_dense(
        A, Bm, lxx, luu, lux, lx, lu, reg, opts.reg_min, opts.reg_scaling,
        opts.reg_max_retries, True)
    assert rd.LAUNCHES > before
    for a, b in zip(got, (*want, reg_w)):
        assert torch.equal(a, b)
    assert bool(got[5].all())


def test_cpu_traced_artifact_on_card_launches_kernel(dev, tmp_path):
    """An f32 artifact traced on the CPU, saved, loaded and called with
    CUDA inputs: the program moves to the card, the latency operator
    launches the kernel, and the tick matches the live f32 tick on the
    card (the chip's export_aot gates)."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.export import (
        arrays_to_state,
        call_exported,
        export_mpc_server,
        load_exported,
        save_exported,
    )
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_latency as rl

    ref = load_scotty()
    cpu = mpc.aot_latency_problem(ref, N=12, device="cpu")
    opts = mpc.aot_latency_options().replace(iterations_max=3)
    art = export_mpc_server(cpu, opts, platforms=("cuda", "cpu"))
    save_exported(art, str(tmp_path / "a.pt2"))
    srv = load_exported(str(tmp_path / "a.pt2"))
    problem = mpc.aot_latency_problem(ref, N=12, device=dev)
    xm, xr, ur, st = mpc.aot_latency_inputs(problem, ref, None)
    before = rl.LAUNCHES
    u0, st_a, stats = call_exported(srv, xm, xr, ur, st)
    assert rl.LAUNCHES > before
    assert u0.is_cuda and torch.isfinite(u0).all()
    ul, sl, statl = mpc.mpc_step(problem, arrays_to_state(st), xm, xr, ur, opts)
    assert int(stats["iterations"]) == int(statl.iterations)
    assert float((u0 - ul).abs().max()) <= 1e-5
    assert float((st_a["x"] - sl.x).abs().max()) <= 1e-4
    assert float((st_a["u"] - sl.u).abs().max()) <= 1e-4
    # and the same program still serves on the CPU
    u_cpu, _, _ = call_exported(srv, *(t.cpu() for t in (xm, xr, ur)),
                                {k: v.cpu() for k, v in st.items()})
    assert float((u_cpu - u0.cpu()).abs().max()) <= 1e-5


def test_trial_operator_equals_wrapper(dev):
    """`altro_tpu_torch::trial_rollout` on CUDA tensors launches
    trial_rollout.cu and gives its wrapper's answer bit for bit (the
    bicycle at N=30, W=8, the steering bound's two rows)."""
    from altro_tpu_torch.mpc import trial_operands
    from altro_tpu_torch.ops import library  # noqa: F401
    from altro_tpu_torch.ops import trial_rollout as tr

    step, args, con = trial_operands("bicycle", 30, 8, 2, device=dev)
    ds = step.device_step
    want = tr.trial_rollout(step, *args, con=con)
    before = tr.LAUNCHES
    got = torch.ops.altro_tpu_torch.trial_rollout(
        *args, *con, ds.model, ds.integrator, [float(v) for v in ds.params])
    assert tr.LAUNCHES == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("form", ["default", "trial"])
def test_cpu_traced_forms_on_card_launch_their_kernels(dev, tmp_path, form):
    """The default-options artifact (the strong-Wolfe search in the graph,
    riccati_latency.cu) and the `_trial` one (trial_rollout.cu and
    riccati_latency.cu), traced on the CPU at N=12, saved, loaded and
    called with CUDA inputs: each launches its kernels and matches the
    live f32 tick on the card (the chip's export_aot gates)."""
    from altro_tpu_torch import mpc
    from altro_tpu_torch.export import (
        arrays_to_state,
        call_exported,
        export_mpc_server,
        load_exported,
        save_exported,
    )
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_latency as rl
    from altro_tpu_torch.ops import trial_rollout as tr

    ref = load_scotty()
    if form == "default":
        build, opts = mpc.aot_latency_problem, mpc.aot_default_options()
    else:
        build, opts = mpc.aot_trial_problem, mpc.aot_trial_options()
    opts = opts.replace(iterations_max=3)
    art = export_mpc_server(build(ref, N=12, device="cpu"), opts, platforms=("cuda",))
    save_exported(art, str(tmp_path / "a.pt2"))
    srv = load_exported(str(tmp_path / "a.pt2"))
    problem = build(ref, N=12, device=dev)
    xm, xr, ur, st = mpc.aot_latency_inputs(problem, ref, None)
    before = rl.LAUNCHES, tr.LAUNCHES
    u0, st_a, stats = call_exported(srv, xm, xr, ur, st)
    assert rl.LAUNCHES > before[0]
    assert (tr.LAUNCHES > before[1]) == (form == "trial")
    assert u0.is_cuda and torch.isfinite(u0).all()
    ul, sl, statl = mpc.mpc_step(problem, arrays_to_state(st), xm, xr, ur, opts)
    assert int(stats["iterations"]) == int(statl.iterations)
    assert float((u0 - ul).abs().max()) <= 1e-5
    assert float((st_a["x"] - sl.x).abs().max()) <= 1e-4
    assert float((st_a["u"] - sl.u).abs().max()) <= 1e-4
