"""`rescue.vmap_solve_with_rescue` on the port against altro_tpu/rescue.py:
tests/test_rescue.py's two tests (the pendulum swing-up with a torque
bound, 8 lanes, half easy and half hard) in f64 on the CPU. Per lane the
statuses and iterations equal JAX's and the states agree to roundoff;
the port's own contract holds too: healthy lanes keep the primary run's
state bit for bit, failed lanes are rescued, and with no failure the
rescue does not run."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu.rescue import rescue_options as jrescue_options  # noqa: E402
from altro_tpu.rescue import vmap_solve_with_rescue as jvmap_solve_with_rescue  # noqa: E402
from altro_tpu_torch.parallel.batch import vmap_solve  # noqa: E402
from altro_tpu_torch.reference_problems import (  # noqa: E402
    rescue_pendulum_batch,
    rescue_pendulum_options,
    rescue_pendulum_problem,
)
from altro_tpu_torch.rescue import rescue_options, vmap_solve_with_rescue  # noqa: E402
from altro_tpu_torch.status import SolveStatus  # noqa: E402
from test_rescue import OPTS as JOPTS  # noqa: E402
from test_rescue import B  # noqa: E402
from test_rescue import _batch as _jbatch  # noqa: E402
from test_rescue import _problem as _jproblem  # noqa: E402
from test_torch_diff_lqr import assert_same_leaves  # noqa: E402

OPTS = rescue_pendulum_options()
FIELDS = ("x", "u", "y", "K", "d", "P", "p", "rho", "reg")


def _port_run_inputs():
    """The port's problem and batch, held to test_rescue.py's leaf for leaf."""
    problem = rescue_pendulum_problem(device="cpu")
    assert_same_leaves(problem, _jproblem())
    x0b, states = rescue_pendulum_batch(problem, B)
    jx0b, jstates = _jbatch(_jproblem())
    np.testing.assert_array_equal(x0b.numpy(), np.asarray(jx0b))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(states, name).numpy(),
                                      np.asarray(getattr(jstates, name)), err_msg=name)
    return problem, x0b, states


def _jax_run(opts_fn):
    problem = _jproblem()
    x0b, states = _jbatch(problem)
    opts = opts_fn(JOPTS)
    return jax.jit(lambda x0, st: jvmap_solve_with_rescue(
        problem, x0, st, opts, jrescue_options(opts, iterations_max=40)))(x0b, states)


def _assert_as_jax(st, stats, jst, jstats):
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(jstats.status))
    np.testing.assert_array_equal(stats.iterations.numpy(), np.asarray(jstats.iterations))
    for name in FIELDS:
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                   rtol=1e-10, atol=1e-11, err_msg=name)


def test_rescue_fixes_hard_lanes_keeps_easy_bitwise():
    problem, x0b, states = _port_run_inputs()
    st_p, stats_p = vmap_solve(problem, OPTS)(x0b, states)
    failed_p = stats_p.status.numpy() != 0
    assert failed_p[B // 2:].all(), "hard lanes must fail at budget 3"
    assert not failed_p[: B // 2].any(), "easy lanes must converge"

    info = {}
    st_r, stats_r = vmap_solve_with_rescue(problem, x0b, states, OPTS,
                                           rescue_options(OPTS, iterations_max=40), info=info)
    assert info["rescued"]
    assert (stats_r.status.numpy()[B // 2:] == int(SolveStatus.SUCCESS)).all()
    assert (stats_r.iterations.numpy()[B // 2:] > 3).all()
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(st_r, name).numpy()[: B // 2],
                                      getattr(st_p, name).numpy()[: B // 2], err_msg=name)
    np.testing.assert_array_equal(stats_r.iterations.numpy()[: B // 2],
                                  stats_p.iterations.numpy()[: B // 2])
    _assert_as_jax(st_r, stats_r, *_jax_run(lambda o: o))


def test_rescue_noop_when_all_converge():
    problem, x0b, states = _port_run_inputs()

    def big(o):
        return o.replace(iterations_max=40, ls_failure_recovery=True, ls_recovery_max_fails=0,
                         ls_best_decrease_fallback=True)

    opts = big(OPTS)
    st_p, stats_p = vmap_solve(problem, opts)(x0b, states)
    assert (stats_p.status.numpy() == 0).all()
    info = {}
    st_r, stats_r = vmap_solve_with_rescue(problem, x0b, states, opts,
                                           rescue_options(opts, iterations_max=40), info=info)
    assert not info["rescued"]
    np.testing.assert_array_equal(st_r.u.numpy(), st_p.u.numpy())
    np.testing.assert_array_equal(stats_r.iterations.numpy(), stats_p.iterations.numpy())
    _assert_as_jax(st_r, stats_r, *_jax_run(big))
