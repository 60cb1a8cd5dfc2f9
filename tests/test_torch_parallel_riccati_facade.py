"""The facade `ALTROSolver` with `parallel_riccati`: tests/test_api.py's
goal-constrained double integrator through both packages' facades in
float64, the two-level form at chunk 4, compared as tests/test_torch_api.py
compares them (statuses, iterations, trajectories, gains and duals to
1e-8), in JAX's 3 iterations.
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch.status import SolveStatus  # noqa: E402


def test_facade_takes_parallel_riccati():
    """tests/test_api.py's goal-constrained facade with `parallel_riccati`
    on both packages: the port's `ALTROSolver` solves as JAX's does."""
    api = pytest.importorskip("test_torch_api")

    def build(lib):
        s = api.build_solver(lib, [1.0, 2.0, 0.0, 0.0])
        s.set_options(api.options(lib, penalty_scaling=100.0, parallel_riccati=True,
                                  parallel_riccati_chunk=4))
        s.set_constraint(api.goal_fn(lib), api.NX, api.cone(lib, "ZERO"), "goal", api.N)
        s.initialize()
        return s

    js, ts = api.both(build)
    assert js.solve() == ts.solve() == SolveStatus.SUCCESS
    api.assert_same_solve(js, ts)
    assert ts.get_iterations() == 3
