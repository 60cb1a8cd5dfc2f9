"""The vmapped solve's Verbosity.LINE_SEARCH trace against `jax.vmap(solve)`
in float64 on the CPU.

At that tier JAX's vmapped solve prints, per trip of its batched while
loop and for every lane (the stopped ones included), each line search's
lines: the strong-Wolfe search's start banner and one `ls trial` line a
pass of its batched loop (a finished lane's at its held trial), or the
grid's `ls grid block` lines (a lane that found its trial holds the
block after it), then the INNER line. JAX's lines come unordered within
a trip, and now and then across a trip's end (its debug prints are
unordered effects); the port's come in the order of the print sites,
lanes in lane order. So the lines are compared per kind as sorted lists
of their numbers, to the printed digits, and the port's order is
checked on its own.

tests/test_verbosity.py's goal-constrained double integrator on 3 lanes
under the default strong-Wolfe search, the sequential backtracking and
the phase-split grid (the bicycle, where lanes find their trials in
different blocks: tests/test_torch_vmap_verbosity_line_search_bicycle.py).
"""

import dataclasses
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.options import Verbosity as JVerbosity  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch.options import SolverOptions, Verbosity  # noqa: E402
from altro_tpu_torch.parallel import batch  # noqa: E402

tv = pytest.importorskip("test_torch_verbosity")

X0S = np.asarray([[1.0, 1.0, 0.0, 0.0], [2.0, -1.0, 0.0, 0.0], [0.5, 0.2, 0.1, 0.0]])
KINDS = (("banner", "  Starting Cubic Line Search"), ("trial", "    ls trial "),
         ("grid", "    ls grid block "), ("iter", "  iter = "))
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf|True|False")
GRID = dict(use_backtracking_linesearch=True, parallel_linesearch=True, ls_try_cubic_first=False,
            ls_max_iters=8)


def trips(out):
    """Per trip, per kind, the tuples of each line's numbers in print
    order; a trip ends with its run of INNER lines."""
    found, trip = [], {}
    for line in out.splitlines():
        kind = next((k for k, mark in KINDS if line.startswith(mark)), None)
        if kind is None:
            continue
        if kind != "iter" and "iter" in trip:
            found.append(trip)
            trip = {}
        vals = tuple(float({"True": 1, "False": 0}.get(v, v)) for v in NUMBER.findall(line))
        trip.setdefault(kind, []).append(vals)
    if trip:
        found.append(trip)
    return found


def assert_same_trace(out, j_out, rtol=2e-6):
    """The port's trace holds JAX's lines, kind by kind, each matched to
    its printed digits (6 to 8 significant), and prints them in site
    order: per trip the search's lines, then the INNER lines. JAX's
    unordered prints can carry a line across a trip's end, so the match
    is over the run: per kind the sorted lists of the lines' numbers.
    Returns the port's trips."""
    got = trips(out)
    for t in got:
        assert list(t) in (["banner", "trial", "iter"], ["grid", "iter"], ["iter"]), list(t)
    want = trips(j_out)
    for kind, _ in KINDS:
        a = sorted(v for t in got for v in t.get(kind, []))
        b = sorted(v for t in want for v in t.get(kind, []))
        assert len(a) == len(b), kind
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-9, err_msg=kind)
    return got


def _di(kw, capsys):
    jopts = JOpts(verbose=JVerbosity.LINE_SEARCH, **kw)
    problem = tv._jax_problem(tv.X0)
    run = jax.jit(jax.vmap(lambda x0, s: jsolve(dataclasses.replace(problem, x0=x0), s, jopts)))
    out = run(jnp.asarray(X0S), jbatch_init(problem, 3))
    jax.block_until_ready(out)
    jax.effects_barrier()
    j_out = capsys.readouterr().out
    prob = tv._port_problem(tv.X0)
    _, stats = batch.vmap_solve(prob, SolverOptions(verbose=Verbosity.LINE_SEARCH, **kw))(
        torch.as_tensor(X0S), batch.batch_init_state(prob, 3))
    np.testing.assert_array_equal(stats.iterations.numpy(), np.asarray(out[1].iterations))
    return capsys.readouterr().out, j_out, int(stats.iterations.max())


@pytest.mark.parametrize("kw", [
    {},
    dict(use_backtracking_linesearch=True, ls_try_cubic_first=False, ls_c1=0.6),
    dict(GRID, ls_phase_split=True, ls_parallel_width=2, ls_c1=0.9),
], ids=["strong_wolfe", "sequential_backtracking", "split_grid"])
def test_double_integrator_line_search_trace_matches_jax(kw, capsys):
    out, j_out, trips_run = _di(kw, capsys)
    got = assert_same_trace(out, j_out)
    kinds = {k for t in got for k in t}
    assert kinds == ({"grid", "iter"} if "ls_phase_split" in kw else {"banner", "trial", "iter"})
    # every lane's lines, the stopped lanes' included: three a site a pass,
    # one trip a solver iteration of the slowest lane
    assert all(len(v) % 3 == 0 for t in got for v in t.values())
    assert len(got) == trips_run
