"""The vmapped solve's Verbosity.LINE_SEARCH trace on the Scotty bicycle
with its steering bound against `jax.vmap(solve)` in float64 on the CPU:
8 lanes, tests/test_torch_vmap_solve_bicycle.py's first tick, under the
phase-split and the non-split grids one trial wide, where the lanes find
their trials in different blocks and a lane that found its trial holds
the block after it while the others search on. Compared trip by trip as
tests/test_torch_vmap_verbosity_line_search.py does.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch.options import Verbosity  # noqa: E402
from altro_tpu_torch.parallel import batch  # noqa: E402

vb = pytest.importorskip("test_torch_vmap_solve_bicycle")
ls = pytest.importorskip("test_torch_vmap_verbosity_line_search")


@pytest.mark.parametrize("split", [True, False], ids=["split_grid", "non_split_grid"])
def test_bicycle_grid_trace_matches_jax(split, capsys):
    opts = vb.OPTS.replace(verbose=Verbosity.LINE_SEARCH, ls_phase_split=split,
                           ls_parallel_width=1, pallas_backward=False)
    j_run = vb._jax_run(opts, ticks=1)
    j_out = capsys.readouterr().out
    prob, st = vb._port_start()
    _, stats = batch.vmap_solve(vb._tick_problem(prob, 0, None), opts)(
        torch.as_tensor(vb._x_true0()), st)
    out = capsys.readouterr().out
    np.testing.assert_array_equal(stats.iterations.numpy(), j_run[0][2].iterations)
    # a rejected trial whose rollout diverges (merit 2.3 -> 7.0 at alpha 0.25)
    # amplifies roundoff: moving x0 by 1e-15 moves its phi by 3e-4 in the
    # port, and JAX's f64 value sits 2.8e-5 from the port's; the other
    # lines agree to their printed digits (6 to 8 significant)
    got = ls.assert_same_trace(out, j_out, rtol=1e-4)
    # deeper blocks, and lanes that hold the block after theirs while others
    # search on: more lines at block 1 than lanes in some trip
    assert any(max(int(v[0]) for v in t["grid"]) >= 2
               and sum(int(v[0]) == 1 for v in t["grid"]) > vb.B for t in got)
    # the non-split grid's deeper lines carry "(phi0 = ..)" as block 0's do
    # (block, alpha, phi, the 0 of "phi0", phi0); the split grid's do not
    widths = {len(v) for t in got for v in t["grid"] if v[0] > 0}
    assert widths == ({3} if split else {5})
