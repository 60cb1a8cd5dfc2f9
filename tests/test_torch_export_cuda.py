"""The export slice on the card: the two backward operators
(altro_tpu_torch/ops/library.py) against their kernel wrappers bit for
bit, and a CPU-traced f32 artifact moved to the card, which launches the
latency kernel and matches the live f32 tick there.

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
