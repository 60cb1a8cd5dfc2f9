"""A saved artifact loaded and called in a fresh Python process gives the
answers of the process that exported it (altro_tpu_torch/export.py's
load-and-call promise), and the default two-platform artifact
(tests/test_export.py:130: ("tpu", "cpu") there, ("cuda", "cpu") here)
declares both devices and runs on the CPU. f64, one lane, on the CPU; no
JAX."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch.export import (  # noqa: E402
    call_exported,
    export_mpc_server,
    save_exported,
    state_to_arrays,
)
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.solver import init_state  # noqa: E402
from test_torch_export import port_problem  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64

SERVE = """
import sys
import torch
from altro_tpu_torch.export import call_exported, load_exported
art_path, in_path, out_path = sys.argv[1:4]
srv = load_exported(art_path)
args = torch.load(in_path)
outs = []
for _ in range(2):
    u0, state, stats = call_exported(srv, *args[:3], args[3])
    outs.append((u0, state, stats))
    args = (*args[:3], state)
torch.save({"platforms": srv.platforms, "outs": outs}, out_path)
"""


def test_loaded_in_fresh_process_matches(tmp_path):
    problem, ref = port_problem(N=8)
    # f64: the plain backward (the latency kernel takes float32; a CUDA
    # platform with it is refused), as JAX's multi-platform export forces
    # its scan backward
    opts = SolverOptions(iterations_max=2, use_backtracking_linesearch=True,
                         throw_errors=False, penalty_warm_start=True,
                         pallas_latency_backward=False)
    art = export_mpc_server(problem, opts)  # default platforms ("cuda", "cpu")
    assert set(art.platforms) == {"cuda", "cpu"}
    art_path = str(tmp_path / "controller.pt2")
    save_exported(art, art_path)

    N = problem.N
    args = (torch.as_tensor(ref.x[0], dtype=F64) + 0.01,
            torch.as_tensor(ref.x[1: N + 2], dtype=F64),
            torch.zeros((N + 1, problem.m), dtype=F64), state_to_arrays(init_state(problem)))
    in_path, out_path = str(tmp_path / "in.pt"), str(tmp_path / "out.pt")
    torch.save(args, in_path)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    subprocess.run([sys.executable, "-c", SERVE, art_path, in_path, out_path], check=True,
                   env=env, cwd=str(tmp_path), timeout=300)
    got = torch.load(out_path)
    assert tuple(got["platforms"]) == ("cuda", "cpu")

    state = args[3]
    for u0_sub, state_sub, stats_sub in got["outs"]:  # the exporting process's own calls
        u0, state, stats = call_exported(art, *args[:3], state)
        assert torch.equal(u0_sub, u0)
        for k in state:
            assert torch.equal(state_sub[k], state[k]), k
        for k in stats:
            assert torch.equal(stats_sub[k], stats[k]), k
    assert torch.isfinite(u0).all()
