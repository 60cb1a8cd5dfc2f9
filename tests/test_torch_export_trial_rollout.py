"""The trial rollout as a torch operator (`altro_tpu_torch::trial_rollout`,
ops/library.py) and the exported tick that runs it, on the CPU.

* `torch.library.opcheck` on the operator, without constraint rows and
  with the steering bound's two;
* its CPU implementation equals `trial_rollout_ref` on the problem's own
  block step bit for bit, and the registry's block steps
  (`trial_rollout.block_step`) equal the steps that name them;
* the `_trial` form of tests/test_export.py's problem (the steering
  bound an affine NEGATIVE_ORTHANT group, the bicycle's block step) with
  the phase-split x-only grid and `pallas_rollout`: the artifact holds
  the operator and, over 3 closed-loop ticks in f64, gives JAX's live
  `mpc_step` (whose CPU grid is its plain scan, as JAX's CPU tests run
  it) and the port's to 1e-8, counts equal.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu.models.tile_steps import bicycle_tile as jbicycle_tile  # noqa: E402
from altro_tpu.models.tile_steps import midpoint_tile as jmidpoint_tile  # noqa: E402
from altro_tpu_torch.models import tile_steps as ts  # noqa: E402
from altro_tpu_torch.ops import library  # noqa: E402,F401
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402
from test_export import _bicycle_problem as _jproblem  # noqa: E402
from test_torch_export import port_problem  # noqa: E402
from test_torch_export_f32 import _targets  # noqa: E402
from test_torch_export_wolfe import closed_loop  # noqa: E402
from test_torch_trial_rollout import _inputs, _torch_args  # noqa: E402

F64 = torch.float64
OP = torch.ops.altro_tpu_torch.trial_rollout
STEP = ts.midpoint_tile(ts.bicycle_tile())


def _operator_args(P, dtype=F64, seed=0):
    ops, con = _inputs(P, seed=seed)
    args, con = _torch_args(ops, con, dtype)
    if con is None:
        con = (None,) * 4
    else:
        con = (*con[:3], con[3].reshape(1))
    ds = STEP.device_step
    return (*args, *con, ds.model, ds.integrator, [float(v) for v in ds.params])


@pytest.mark.parametrize("P", [0, 2])
def test_opcheck(P):
    torch.library.opcheck(OP.default, _operator_args(P))


@pytest.mark.parametrize("P", [0, 2])
def test_cpu_operator_equals_plain_bit_for_bit(P):
    args = _operator_args(P, seed=2)
    con = None if args[12] is None else args[12:16]
    before = tr.LAUNCHES
    phi, xs = OP(*args)
    want_phi, want_xs = tr.trial_rollout_ref(STEP, *args[:12], con=con)
    assert tr.LAUNCHES == before  # the CPU launches nothing
    assert torch.equal(phi, want_phi) and torch.equal(xs, want_xs)


@pytest.mark.parametrize("step", [
    ts.midpoint_tile(ts.bicycle_tile()), ts.midpoint_tile(ts.bicycle_tile("rear", 2.5, 1.2)),
    ts.midpoint_tile(ts.bicycle_tile("front")), ts.rk4_tile(ts.quadrotor_tile()),
    ts.midpoint_tile(ts.pendulum_tile()), ts.double_integrator_tile(2)],
    ids=["bicycle", "bicycle_rear", "bicycle_front", "quadrotor", "pendulum",
         "double_integrator"])
def test_registry_rebuilds_each_device_step(step):
    ds = step.device_step
    rebuilt = tr.block_step(ds.model, ds.integrator, [float(v) for v in ds.params])
    assert rebuilt.device_step == ds
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((3, ds.n)), dtype=F64)
    u = torch.as_tensor(rng.standard_normal((3, ds.m)), dtype=F64)
    h = torch.full((3, 1), 0.05, dtype=F64)
    assert torch.equal(rebuilt(x, u, h), step(x, u, h))


def _trial_problems(N):
    """tests/test_export.py's problem with the steering bound an affine
    NEGATIVE_ORTHANT group and the bicycle's block step, the port's and
    JAX's."""
    problem, ref = port_problem(N=N)
    jproblem, _ = _jproblem(N=N)
    problem = dataclasses.replace(
        problem, dynamics_tile=ts.midpoint_tile(ts.bicycle_tile()),
        constraints=(dataclasses.replace(problem.constraints[0], affine=True,
                                         diag_hessian=True),))
    jproblem = dataclasses.replace(
        jproblem, dynamics_tile=jmidpoint_tile(jbicycle_tile()),
        constraints=(dataclasses.replace(jproblem.constraints[0], affine=True,
                                         diag_hessian=True),))
    return problem, jproblem, ref


TRIAL = dict(use_backtracking_linesearch=True, parallel_linesearch=True, ls_phase_split=True,
             ls_armijo_only=True, ls_grid_x_only=True, ls_max_iters=8, pallas_rollout=True)


def test_trial_artifact_holds_operator_and_matches_jax():
    problem, jproblem, ref = _trial_problems(8)
    _, art = closed_loop(problem, jproblem, ref, TRIAL, 3)
    targets = _targets(art)
    assert OP.default in targets
    assert torch.ops.altro_tpu_torch.riccati_latency.default in targets
