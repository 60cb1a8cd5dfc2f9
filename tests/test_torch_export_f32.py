"""The f32 artifact traced on the CPU, the two backward operators, and what
export refuses (altro_tpu_torch/export.py, ops/library.py), on the CPU.

* An f32 artifact of the `mpc_latency_aot` row's problem (N=12) that
  selects the latency kernel holds the `altro_tpu_torch::riccati_latency`
  operator whatever device traced it (the port's answer to
  tests/test_export.py:144's warning) and no forward-mode dual-level call,
  and equals the live f32 tick on the CPU to 1e-6; the B8 dense artifact
  holds `altro_tpu_torch::riccati_dense`.
* `torch.library.opcheck` on both operators, and each against the live
  retry it replaces (`solver._retry_loop`, `tile_iter.retry_tiled`).
* Every option export does not carry raises NotImplementedError naming
  it before tracing; so does a CUDA platform whose kernel cannot take the
  problem.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.export import call_exported, export_mpc_server, make_serving_fn  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.ops import library  # noqa: E402,F401
from altro_tpu_torch.ops import tile_iter as ti  # noqa: E402
from altro_tpu_torch.ops.riccati_backward import riccati_backward_ref  # noqa: E402
from altro_tpu_torch.ops.riccati_latency import riccati_latency_ref  # noqa: E402
from altro_tpu_torch.options import SolverOptions, Verbosity  # noqa: E402
from altro_tpu_torch.solver import _retry_loop  # noqa: E402

F32, F64 = torch.float32, torch.float64
NR = 12
OPS = torch.ops.altro_tpu_torch


def _row(dtype=F32, **over):
    ref = load_scotty()
    problem = mpc.aot_latency_problem(ref, N=NR, dtype=dtype, device="cpu")
    return problem, ref, mpc.aot_latency_options(**over).replace(iterations_max=3)


def _targets(art):
    """Every operator the program calls, its loop bodies' included."""
    return {node.target for gm in art.program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule) for node in gm.graph.nodes
            if node.op == "call_function"}


def test_f32_artifact_holds_latency_operator_and_matches_live():
    problem, ref, opts = _row()
    art = export_mpc_server(problem, opts, batch=None, platforms=("cuda", "cpu"))
    targets = _targets(art)
    assert OPS.riccati_latency.default in targets
    # the forward-mode Jacobians are primal and tangent operators, not
    # dual-level calls a loaded program could not replay
    assert not [t for t in targets if "dual" in str(t)]
    xm, xr, ur, st = mpc.aot_latency_inputs(problem, ref, None)
    st_live = st
    from altro_tpu_torch.export import arrays_to_state, state_to_arrays

    eager = make_serving_fn(problem, opts, None)  # the same tick, its trips a Python loop
    for _ in range(2):
        u_eager, _, _ = eager(xm, xr, ur, st)
        u0, st, stats = call_exported(art, xm, xr, ur, st)
        assert torch.equal(u0, u_eager)
        u_live, s_live, stats_live = mpc.mpc_step(problem, arrays_to_state(st_live), xm, xr,
                                                  ur, opts)
        st_live = state_to_arrays(s_live)
        assert u0.dtype == F32
        assert int(stats["iterations"]) == int(stats_live.iterations)
        for a, b in ((u0, u_live), (st["x"], s_live.x), (st["u"], s_live.u)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_dense_artifact_holds_dense_operator():
    problem, _, opts = _row(pallas_backward=True)
    art = export_mpc_server(problem, opts, batch=8, platforms=("cpu",))
    targets = _targets(art)
    assert OPS.riccati_dense.default in targets
    assert OPS.riccati_latency.default not in targets


def _latency_operands(dtype=F64, N=6, n=4, m=2, bad_knot=None, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    luu = np.abs(rng.standard_normal((N, m))) + 0.1
    if bad_knot is not None:
        luu[bad_knot] = -0.5  # indefinite until the retry adds reg
    return (t(np.eye(n)[None] + 0.05 * rng.standard_normal((N, n, n))),
            t(0.2 * rng.standard_normal((N, n, m))),
            t(np.abs(rng.standard_normal((N + 1, n))) + 0.1), t(luu),
            t(rng.standard_normal((N + 1, n))), t(rng.standard_normal((N, m))))


def _lanes(args, Bsz):
    return tuple(a[..., None].expand(*a.shape, Bsz).contiguous() for a in args)


@pytest.mark.parametrize("op", ["riccati_latency", "riccati_dense"])
def test_opcheck(op):
    args = _latency_operands()
    if op == "riccati_latency":
        A, B, lxx, luu, lx, lu = args
        full = (A, B, lxx, luu, None, None, lx, lu, torch.tensor(0.0, dtype=F64),
                1e-8, 10.0, 12, False)
    else:
        A, B, lxx, luu, lx, lu = _lanes(args, 3)
        full = (A, B, lxx, luu, None, lx, lu, torch.zeros(3, dtype=F64), 1e-8, 10.0, 12, False)
    torch.library.opcheck(getattr(OPS, op).default, full)


def test_latency_operator_retries_as_the_live_solve():
    A, B, lxx, luu, lx, lu = _latency_operands(bad_knot=2)
    opts = SolverOptions()
    reg0 = torch.tensor(0.0, dtype=F64)
    live, reg_live = _retry_loop(opts, lambda r: riccati_latency_ref(A, B, lxx, luu, lx, lu, r),
                                 reg0)
    out = OPS.riccati_latency(A, B, lxx, luu, None, None, lx, lu, reg0, opts.reg_min,
                              opts.reg_scaling, opts.reg_max_retries, True)
    assert float(reg_live) > 0 and bool(live.ok)
    for got, want in zip(out, (*live, reg_live)):
        assert torch.equal(got, want)


def test_dense_operator_retries_as_the_batched_solve():
    args = _lanes(_latency_operands(bad_knot=2), 3)
    A, B, lxx, luu, lx, lu = args
    luu[:, :, 0] = luu[:, :, 0].abs() + 0.1  # lane 0 needs no retry
    opts = SolverOptions()
    reg0 = torch.zeros(3, dtype=F64)
    live, reg_live = ti.retry_tiled(opts, lambda r: riccati_backward_ref(A, B, lxx, luu, lx, lu, r),
                                    reg0)
    out = OPS.riccati_dense(A, B, lxx, luu, None, lx, lu, reg0, opts.reg_min, opts.reg_scaling,
                            opts.reg_max_retries, False)
    assert float(reg_live[0]) == 0 and float(reg_live[1]) > 0
    for got, want in zip(out, (*live, reg_live)):
        assert torch.equal(got, want)


REFUSED = [
    ({"use_backtracking_linesearch": False, "parallel_linesearch": False,
      "ls_phase_split": False, "ls_armijo_only": False}, "strong-Wolfe"),
    ({"ls_phase_split": False, "ls_armijo_only": False}, "non-split grid"),
    ({"ls_grid_x_only": False}, "light-payload grid"),
    ({"ls_best_decrease_fallback": True}, "ls_best_decrease_fallback"),
    ({"rti_mode": True}, "rti_mode"),
    ({"exact_al_hessian": True}, "exact_al_hessian"),
    ({"verbose": Verbosity.OUTER}, "verbosity"),
    ({"iteration_callback": lambda *a: None}, "iteration_callback"),
    ({"parallel_riccati": True}, "parallel_riccati"),
    ({"pallas_rollout": True}, "pallas_rollout"),
]


@pytest.mark.parametrize("over, name", REFUSED, ids=[name for _, name in REFUSED])
def test_refused_options_raise_by_name(over, name):
    problem, _, opts = _row()
    batch = None if name == "pallas_rollout" else 8
    with pytest.raises(NotImplementedError, match=name):
        export_mpc_server(problem, opts.replace(**over), batch=batch, platforms=("cpu",))


@pytest.mark.parametrize("batch, over, kernel", [
    (None, {}, "riccati_latency"), (8, {"pallas_backward": True}, "riccati_dense")])
def test_cuda_platform_refuses_what_its_kernel_cannot_take(batch, over, kernel):
    problem, _, opts = _row(dtype=F64)
    with pytest.raises(NotImplementedError, match=kernel):
        export_mpc_server(problem, opts.replace(**over), batch=batch, platforms=("cuda",))
    # five states: no kernel instantiation for (5, 2)
    wide = dataclasses.replace(_row()[0], n=5)
    with pytest.raises(NotImplementedError, match="no instantiation"):
        export_mpc_server(wide, opts.replace(**over), batch=batch, platforms=("cuda",))
