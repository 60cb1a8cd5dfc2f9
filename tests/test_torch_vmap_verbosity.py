"""The vmapped solve's verbosity, `iteration_callback` and light-payload
grid against `jax.vmap(solve)` in float64 on the CPU.

tests/test_verbosity.py's goal-constrained double integrator on 3 lanes
(three starts). JAX's vmapped solve prints through its debug callbacks
per lane: each lane's first line, every trip of the batched while loop
one line per lane (the lanes that already stopped included: the body
runs for every lane; OUTER's `lax.cond` becomes a select under vmap) and
each lane's last line; the callback is called per lane, trip by trip.
Its lines and calls come unordered within a trip, the port's in lane
order, so lines are compared per kind as sorted lists of their integer
fields, and the callbacks' arguments trip by trip (iter in order, the
rest sorted within a trip, within 1e-9). The light-payload grid:
tests/test_torch_vmap_light_grid.py.
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
KINDS = ("  iter = ", "  outer: iter = ", "STARTING ALTRO", "ALTRO SOLVE FINISHED")


def _jax_run(problem, x0s, opts):
    run = jax.jit(jax.vmap(lambda x0, s: jsolve(dataclasses.replace(problem, x0=x0), s, opts)))
    out = run(jnp.asarray(x0s), jbatch_init(problem, x0s.shape[0]))
    jax.block_until_ready(out)
    jax.effects_barrier()
    return out


def _lines(out):
    """Per kind, the sorted integer fields of its lines (iter, ls_iter;
    iterations, status), and the count of the Initial Cost lines."""
    got = {k: [] for k in KINDS}
    for line in out.splitlines():
        for k in KINDS:
            if line.startswith(k):
                got[k].append(tuple(int(v) for v in re.findall(r"(?:iter|iterations|status|"
                                                                  r"ls_iter) = (-?\d+)", line)))
    return {k: sorted(v) for k, v in got.items()}, out.count("  Initial Cost: ")


@pytest.mark.parametrize("verbose", ["INNER", "OUTER"])
def test_vmapped_verbosity_and_callback_match_jax(verbose, capsys):
    j_calls, calls = [], []
    jopts = JOpts(verbose=JVerbosity[verbose],
                  iteration_callback=lambda *a: j_calls.append([float(np.asarray(v)) for v in a]))
    j_state, j_stats = _jax_run(tv._jax_problem(tv.X0), X0S, jopts)
    j_out = capsys.readouterr().out

    opts = SolverOptions(verbose=Verbosity[verbose],
                         iteration_callback=lambda *a: calls.append([float(v) for v in a]))
    state, stats = batch.vmap_solve(tv._port_problem(tv.X0), opts)(
        torch.as_tensor(X0S), batch.batch_init_state(tv._port_problem(tv.X0), 3))
    out = capsys.readouterr().out

    np.testing.assert_array_equal(stats.iterations.numpy(), np.asarray(j_stats.iterations))
    assert _lines(out) == _lines(j_out)
    n_trips = int(np.max(np.asarray(j_stats.iterations)))
    assert len(calls) == len(j_calls) == 3 * n_trips
    # the port calls in lane order; JAX's calls come unordered within a trip
    assert [c[0] for c in calls] == [c[0] for c in j_calls]
    trips = lambda cs: np.asarray(sorted(map(tuple, cs), key=lambda c: (c[0], c[1])))  # noqa: E731
    np.testing.assert_allclose(trips(calls), trips(j_calls), rtol=1e-9, atol=1e-12)


def test_silent_vmapped_solve_prints_nothing(capsys):
    prob = tv._port_problem(tv.X0)
    batch.vmap_solve(prob, SolverOptions())(torch.as_tensor(X0S), batch.batch_init_state(prob, 3))
    assert capsys.readouterr().out == ""
