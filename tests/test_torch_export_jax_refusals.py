"""Why the port's export still refuses a verbosity above SILENT and an
`iteration_callback`: JAX's own `export_mpc_server` cannot serialize them
either. tests/test_export.py's problem (N=6, 2 iterations) exported by
altro_tpu.export with each option and serialized: JAX raises
NotImplementedError for its host callbacks (at export or at
serialization, by JAX's version), whose message the port's refusal
quotes (`graph_solve.JAX_EXPORT_REFUSAL`)."""

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from altro_tpu.export import export_mpc_server as jexport_mpc_server  # noqa: E402
from altro_tpu.options import SolverOptions as JSolverOptions  # noqa: E402
from altro_tpu.options import Verbosity as JVerbosity  # noqa: E402
from altro_tpu_torch.export import export_mpc_server  # noqa: E402
from altro_tpu_torch.graph_solve import JAX_EXPORT_REFUSAL  # noqa: E402
from altro_tpu_torch.options import SolverOptions, Verbosity  # noqa: E402
from test_export import _bicycle_problem as _jproblem  # noqa: E402
from test_torch_export import port_problem  # noqa: E402

CASES = {"verbosity": ({"verbose": JVerbosity.OUTER}, {"verbose": Verbosity.OUTER}),
         "iteration_callback": ({"iteration_callback": lambda *a: None},
                                {"iteration_callback": lambda *a: None})}


@pytest.mark.parametrize("name", list(CASES))
def test_jax_export_refuses_what_the_port_refuses(name):
    jover, over = CASES[name]
    jproblem, _ = _jproblem(N=6)
    with pytest.raises(NotImplementedError, match=JAX_EXPORT_REFUSAL):
        jexport_mpc_server(jproblem, JSolverOptions(iterations_max=2, **jover),
                           platforms=("cpu",)).serialize()
    problem, _ = port_problem(N=6)
    with pytest.raises(NotImplementedError, match=name) as err:
        export_mpc_server(problem, SolverOptions(iterations_max=2, **over), platforms=("cpu",))
    assert JAX_EXPORT_REFUSAL in str(err.value)
