"""Time the port's live line searches on the card, one cell a JSON line.

    python tools/time_live_search.py [--lanes B] [--ticks T] [--calls C] [--tag NAME]
        [--cells all|single|batched]
    PYTHONPATH=<another checkout> python tools/time_live_search.py --tag parent

Cells (every number CUDA-synchronised wall time on one card, f32):

* `batched_backtracking`, `batched_wolfe`: examples/batched_mpc.py's
  closed loop (`mpc.run_batched_tracking`, B lanes, `riccati_dense.cu`)
  under the example's sequential backtracking and under the default
  strong-Wolfe search; both run the lane machine
  (`linesearch.wolfe_line_search_lanes`) once an iteration. One warm-up
  tick, then three runs of T ticks; ms per tick (median of the runs),
  the machine's passes and host reads per tick, mean iterations.
* `aot_tick_scalar`, `aot_tick_lanes`: the `mpc_latency_aot` row's
  one-lane live tick (`mpc.mpc_step`, bicycle (4, 2), N=30,
  `riccati_latency.cu`) under the default options (the strong-Wolfe
  search, the row's 10 iterations, penalty warm start, f32 tolerances
  1e-3), from the row's serving inputs.
* `pendulum_bounded_scalar`, `pendulum_bounded_lanes`: one
  `solver.solve` of `pendulum_swingup_bounded`
  (`reference_problems.pendulum_bounded_problem`, (2, 1), N=50,
  `riccati_latency.cu`) under its row's options (`mpc.baseline_f32_options`,
  the strong-Wolfe search), a solve whose searches go past trial 1.

  `*_scalar` runs the solve's own search (`linesearch.wolfe_line_search`,
  decisions on host scalars); `*_lanes` puts the lane machine at B=1 in
  its place, with the payload given a lane axis of 1. Two warm-up calls,
  then C calls: p50 and p90 ms, iterations, line-search trials (summed
  over the solve's searches) and how far the `*_lanes` result lies from
  the `*_scalar` one.

The script imports whichever `altro_tpu_torch` comes first on sys.path
(this checkout's unless PYTHONPATH names another), so the same script
times two trees in one machine: run parent, change, change, parent. It
imports no JAX, and needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not any(os.path.isdir(os.path.join(p or ".", "altro_tpu_torch")) for p in sys.path[1:]):
    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from altro_tpu_torch import linesearch, mpc, reference_problems, solver  # noqa: E402
from altro_tpu_torch.export import arrays_to_state  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402


DEV = "cuda"


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def default_options() -> SolverOptions:
    """The row's options under the reference's default search."""
    return SolverOptions(iterations_max=10, tol_stationarity=1e-3, tol_primal_feasibility=1e-3,
                         throw_errors=False, penalty_warm_start=True)


def lanes_at_one(merit_full, merit_value, phi0, dphi0, alpha0=1.0,
                 opts=linesearch.LineSearchOptions(), aux0=None, *, merit_light=None,
                 complete=None):
    """`wolfe_line_search`'s interface on the lane machine at B=1: alpha,
    phi and dphi as [1] lanes, the payload with a trailing lane axis.
    Without the lazy backtracking (merit_light, complete), which the
    strong-Wolfe search does not use."""
    del merit_value, merit_light, complete
    lane = lambda t: t[..., None]  # noqa: E731
    one = lambda t: t[..., 0]  # noqa: E731

    def full(alpha):
        phi, dphi, aux = merit_full(alpha[0])
        return phi.reshape(1), dphi.reshape(1), linesearch.tree_map(lane, aux)

    res = linesearch.wolfe_line_search_lanes(full, phi0.reshape(1), dphi0.reshape(1), alpha0,
                                             opts, aux0=linesearch.tree_map(lane, aux0))
    return linesearch.LineSearchResult(
        alpha=res.alpha[0], phi=res.phi[0], dphi=res.dphi[0], code=res.code[0],
        n_iters=res.n_iters[0], aux=linesearch.tree_map(one, res.aux),
        aux_alpha=res.aux_alpha[0])


def batched_cells(lanes: int, ticks: int) -> list:
    prob = mpc.batched_tracking_problem(dtype=torch.float32, device=DEV)
    x0 = mpc.batched_tracking_initial_states(lanes, dtype=torch.float32, device=DEV)
    rows = []
    for name, back in (("batched_backtracking", True), ("batched_wolfe", False)):
        opts = mpc.batched_tracking_options().replace(use_backtracking_linesearch=back)
        mpc.run_batched_tracking(prob, x0, ticks=1, opts=opts)  # warm-up
        runs = [mpc.run_batched_tracking(prob, x0, ticks=ticks, opts=opts) for _ in range(3)]
        ms = sorted(1e3 * r.seconds / ticks for r in runs)
        rows.append({"cell": name, "B": lanes, "ticks": ticks, "ms_per_tick": ms[1],
                     "ms_per_tick_runs": ms, "passes_per_tick": sum(runs[0].passes) / ticks,
                     "syncs_per_tick": sum(runs[0].syncs) / ticks,
                     "mean_iterations": float(runs[0].iterations.float().mean())})
    return rows


def _calls(fn, calls: int) -> np.ndarray:
    ms = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return np.asarray(ms), out


def single_cells(calls: int) -> list:
    """Both single-lane cells under both machines."""
    ref = load_scotty()
    prob = mpc.aot_latency_problem(ref, dtype=torch.float32, device=DEV)
    xm, xr, ur, st = mpc.aot_latency_inputs(prob, ref, None)
    opts = default_options()
    pend, pst = reference_problems.pendulum_bounded_problem(dtype=torch.float32, device=DEV)
    popts = mpc.baseline_f32_options()
    cells = (("aot_tick", prob.N, lambda: mpc.mpc_step(prob, arrays_to_state(st), xm, xr, ur,
                                                        opts)[1:]),
             ("pendulum_bounded", pend.N, lambda: solver.solve(pend, pst, popts)))
    scalar = solver.wolfe_line_search
    rows = []
    for cell, N, fn in cells:
        u_scalar = None
        for name, machine in (("scalar", scalar), ("lanes", lanes_at_one)):
            trials = []

            def counted(*a, **kw):
                res = machine(*a, **kw)
                trials.append(res.n_iters)
                return res

            solver.wolfe_line_search = counted
            try:
                _calls(fn, 2)  # warm-up
                trials.clear()
                ms, (state, stats) = _calls(fn, calls)
            finally:
                solver.wolfe_line_search = scalar
            u_scalar = state.u if u_scalar is None else u_scalar
            rows.append({"cell": f"{cell}_{name}", "B": 1, "N": N, "calls": calls,
                         "p50_ms": float(np.percentile(ms, 50)),
                         "p90_ms": float(np.percentile(ms, 90)),
                         "iterations": int(stats.iterations),
                         "ls_trials_per_call": int(sum(t.item() for t in trials)) / calls,
                         "max_abs_du_vs_scalar": float((state.u - u_scalar).abs().max())})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--tag", default="")
    ap.add_argument("--cells", choices=("all", "single", "batched"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_live_search: no card", file=sys.stderr)
        return 1
    head = {"tag": args.tag, "card": card(), "torch": torch.__version__,
            "package": os.path.dirname(os.path.abspath(mpc.__file__))}
    rows = [] if args.cells == "batched" else single_cells(args.calls)
    rows += [] if args.cells == "single" else batched_cells(args.lanes, args.ticks)
    for row in rows:
        print(json.dumps({**head, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
