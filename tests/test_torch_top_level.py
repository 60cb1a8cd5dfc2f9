"""The port's top-level names against altro_tpu's (altro_tpu/__init__.py):
every public name but `ensure_backend` (the TPU platform probe), the same
submodules (but `platform`), and the README's functional core
(README.md:53) importing from the port."""

import types

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import altro_tpu  # noqa: E402
import altro_tpu_torch  # noqa: E402

NOT_PORTED = {"ensure_backend"}
# the submodules altro_tpu/__init__.py imports by name
SUBMODULES = ("al", "checkpoint", "export", "io", "linesearch", "models", "mpc", "ops",
              "parallel", "profiling")


def _names(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_public_names_are_jax_less_the_unported():
    assert _names(altro_tpu_torch) == _names(altro_tpu) - NOT_PORTED
    assert altro_tpu_torch.__version__ == altro_tpu.__version__
    for name in SUBMODULES:
        assert isinstance(getattr(altro_tpu_torch, name), types.ModuleType), name


@pytest.mark.parametrize("name", sorted(_names(altro_tpu) - NOT_PORTED))
def test_each_name_is_the_ported_kind(name):
    """A class stays a class, a function a function, a constant a constant."""
    jv, tv = getattr(altro_tpu, name), getattr(altro_tpu_torch, name)
    assert isinstance(tv, type) == isinstance(jv, type)
    assert callable(tv) == callable(jv)
    if not callable(jv):
        assert type(tv) is type(jv)


def test_readme_functional_core_runs_on_the_port():
    """README.md:53's import line, then a cold solve of a small problem
    through the names it imports."""
    from altro_tpu_torch import ConstraintSpec, DiagonalCost, Problem, init_state, solve  # noqa
    from altro_tpu_torch import Cost, SolverOptions, SolveStatus

    N, n, m = 10, 2, 1
    kw = dict(dtype=torch.float64)
    cost = DiagonalCost(Q=torch.ones((N + 1, n), **kw), R=torch.full((N + 1, m), 0.1, **kw),
                        q=torch.zeros((N + 1, n), **kw), r=torch.zeros((N + 1, m), **kw),
                        c=torch.zeros(N + 1, **kw))
    assert isinstance(cost, Cost)
    prob = Problem(N=N, n=n, m=m, dynamics=lambda x, u, h, k: torch.stack(
        [x[0] + h * x[1], x[1] + h * u[0]]), dynamics_jac=None, constraints=(), cost=cost,
        h=torch.full((N,), 0.1, **kw), x0=torch.tensor([1.0, 0.0], **kw))
    state, stats = solve(prob, init_state(prob), SolverOptions())
    assert int(stats.status) == int(SolveStatus.SUCCESS)
