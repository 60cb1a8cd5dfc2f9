"""Solves with `parallel_riccati` (the associative backward pass) on the
port, in float64 on the CPU:

* tests/test_parallel_riccati.py:83 and :174: the goal-constrained double
  integrator reaches SUCCESS in exactly 3 iterations with |x_N| < 1e-4,
  under the pure scan and the two-level form (chunk 16), and equals the
  serial solve's iterates to roundoff;
* `jax.vmap(solve)` with `parallel_riccati` at B=4 (tests/test_parallel.py's
  starts) against the port's vmapped solve, lane for lane: statuses,
  iterations, x and u to 1e-9; chunk 16 against the port's serial
  backward;
* `pallas_backward` with `parallel_riccati` raises JAX's ValueError in
  both solves (the facade: tests/test_torch_parallel_riccati_facade.py).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch import solver  # noqa: E402
from altro_tpu_torch.parallel import batch  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402

dw = pytest.importorskip("test_torch_dist_workers")

OPTS = dw.OPTS


@pytest.mark.parametrize("chunk", [0, 16], ids=["pure", "chunk16"])
def test_solver_with_parallel_riccati_meets_the_oracle(chunk):
    problem = dw.di_problem()
    opts = OPTS.replace(parallel_riccati=True, parallel_riccati_chunk=chunk)
    state, stats = solver.solve(problem, solver.init_state(problem), opts)
    assert int(stats.status) == SolveStatus.SUCCESS
    assert int(stats.iterations) == 3
    assert float(torch.linalg.norm(state.x[-1])) < 1e-4
    # the serial backward on the dense expansions takes the same iterates
    s_state, s_stats = solver.solve(problem, solver.init_state(problem),
                                    OPTS.replace(diag_expansion=False))
    assert int(s_stats.iterations) == 3
    np.testing.assert_allclose(state.x.numpy(), s_state.x.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(state.u.numpy(), s_state.u.numpy(), rtol=0, atol=1e-12)


def test_vmapped_parallel_riccati_matches_jax_vmap_solve():
    from altro_tpu.parallel.batch import batch_init_state as jbatch_init
    from altro_tpu.solver import solve as jsolve
    from test_parallel import OPTS as JOPTS
    from test_parallel import di_problem as jdi_problem
    from test_parallel import x0_batch as jx0_batch

    Bsz = 4
    jopts = dataclasses.replace(JOPTS, parallel_riccati=True)
    jprob = jdi_problem()
    run = jax.jit(jax.vmap(lambda x0, s: jsolve(dataclasses.replace(jprob, x0=x0), s, jopts)))
    j_state, j_stats = run(jx0_batch(Bsz), jbatch_init(jprob, Bsz))

    problem = dw.di_problem()
    x0s = torch.as_tensor(np.asarray(jx0_batch(Bsz)))
    st, stats = batch.vmap_solve(problem, OPTS.replace(parallel_riccati=True))(
        x0s, batch.batch_init_state(problem, Bsz))
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(j_stats.status))
    np.testing.assert_array_equal(stats.iterations.numpy(), np.asarray(j_stats.iterations))
    assert (stats.status == SolveStatus.SUCCESS).all()
    np.testing.assert_allclose(st.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-9)

    # the two-level form and the serial backward take the same iterates
    for opts in (OPTS.replace(parallel_riccati=True, parallel_riccati_chunk=16),
                 OPTS.replace(diag_expansion=False)):
        st2, stats2 = batch.vmap_solve(problem, opts)(x0s, batch.batch_init_state(problem, Bsz))
        assert torch.equal(stats2.status, stats.status)
        assert torch.equal(stats2.iterations, stats.iterations)
        np.testing.assert_allclose(st2.x.numpy(), st.x.numpy(), rtol=0, atol=1e-12)


def test_pallas_backward_excludes_parallel_riccati():
    problem = dw.di_problem()
    opts = OPTS.replace(parallel_riccati=True, pallas_backward=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        solver.solve(problem, solver.init_state(problem), opts)
    with pytest.raises(ValueError, match="mutually exclusive"):
        batch.vmap_solve(problem, opts)
    # JAX's own check, the same words
    from altro_tpu.solver import init_state as jinit
    from altro_tpu.solver import solve as jsolve
    from test_parallel import OPTS as JOPTS
    from test_parallel import di_problem as jdi_problem

    jprob = jdi_problem()
    with pytest.raises(ValueError, match="mutually exclusive"):
        jsolve(jprob, jinit(jprob),
               dataclasses.replace(JOPTS, parallel_riccati=True, pallas_backward=True))

