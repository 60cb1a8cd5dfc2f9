"""`solve_tiled` with `symmetrize_ctg=True` against altro_tpu's `solve_tiled`.

JAX's `solve_tiled` takes the option (altro_tpu/tile_solver.py:133-147)
and hands it to its tiled backward kernel, which accepts and ignores it
(ops/pallas_riccati.py:294): P is symmetric by construction. The port's
`solve_tiled` runs it the same way (the lane loop passes no
`symmetrize` to its backward). Both solves on the same numpy inputs:
the main path's problem (the bicycle, midpoint, the steering bound, N=8)
from the path's start plus 0.05 N(0, 1) (numpy seed 0), the bench's
options with `symmetrize_ctg=True` and 4 iterations, the port's plain
versions on the CPU. JAX's tiled kernels take float32 only, so the f64
run (16 lanes) is held against jax.vmap(solve) with the option (the
per-lane iterates JAX's `solve_tiled` promises, tests/test_tile_solver
.py), and an f32 run on one lane tile (1024 lanes) against JAX's
`solve_tiled` itself, its kernels in interpret mode. And the f64 run
equals the `symmetrize_ctg=False` run exactly.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu import tile_solver as jts  # noqa: E402
from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.io.scotty import load_scotty as jload  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.parallel.batch import batch_init_state  # noqa: E402

N, B, n, m = 8, 1024, 4, 2
DM = 60 * np.pi / 180.0
OPTS = mpc.bench_options(iterations_max=4)[0].replace(symmetrize_ctg=True)
JOPTS = JOpts(**{f.name: getattr(OPTS, f.name) for f in dataclasses.fields(OPTS)})


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(jts, "_FORCE_INTERPRET", True)


def _starts(ref):
    rng = np.random.default_rng(0)
    return ref.x[0][None] + 0.05 * rng.standard_normal((B, n))


def _jax_problem(dt):
    ref = jload()
    return JProblem(
        N=N, n=n, m=m, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
        constraints=(JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                           cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                           diag_hessian=True, affine=True),),
        cost=jlqr(jnp.full((N + 1, n), 1e-2, dt), jnp.full((N + 1, m), 1e-3, dt),
                  jnp.asarray(ref.x[: N + 1], dt), jnp.asarray(ref.u[: N + 1], dt)),
        h=jnp.full(N, float(np.float32(ref.tf / ref.N)), dt), x0=jnp.asarray(ref.x[0], dt))


def _jax_states(prob, lanes):
    ref = jload()
    dt = prob.x0.dtype
    return dataclasses.replace(
        jbatch_init(prob, lanes), u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], dt), (lanes, N, 1)),
        x=jnp.tile(jnp.asarray(ref.x[: N + 1], dt), (lanes, 1, 1)))


def _jax_solve_tiled(x0s):
    """JAX's solve_tiled (its kernels take float32 only), one lane tile."""
    prob = _jax_problem(jnp.float32)
    states = _jax_states(prob, B)
    prob_t = dataclasses.replace(prob, x0=jts.batch_to_tiles(jnp.asarray(x0s, jnp.float32)))
    prob_axes = dataclasses.replace(
        prob, cost=dataclasses.replace(prob.cost, Q=False, R=False, q=False, r=False, c=False),
        h=False, x0=True,
        constraints=tuple(dataclasses.replace(s, active=False) for s in prob.constraints),
        A=False, B=False, f_aff=False)
    st_t, stats_t = jax.jit(lambda s: jts.solve_tiled(prob_t, prob_axes, s, JOPTS))(
        jts.state_to_tiles(states))
    return jts.state_from_tiles(st_t), jts.stats_from_tiles(stats_t)


def _jax_vmapped_solve(x0s):
    """jax.vmap(solve) in float64: the per-lane iterates JAX's solve_tiled
    promises (tests/test_tile_solver.py)."""
    prob = _jax_problem(jnp.float64)
    run = jax.vmap(lambda x0, s: jsolve(dataclasses.replace(prob, x0=x0), s, JOPTS))
    return jax.jit(run)(jnp.asarray(x0s), _jax_states(prob, x0s.shape[0]))


def _port_solve_tiled(x0s, opts, dtype=torch.float64):
    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=N, dtype=dtype, device="cpu")
    B = x0s.shape[0]
    kw = dict(dtype=dtype)
    state = dataclasses.replace(
        batch_init_state(prob, B),
        u=torch.tensor([ref.u[0][0], 0.0], **kw).expand(B, N, m).contiguous(),
        x=torch.as_tensor(ref.x[: N + 1], **kw).expand(B, N + 1, n).contiguous())
    prob = dataclasses.replace(prob, x0=tsv.batch_to_lanes(torch.as_tensor(x0s, **kw)))
    st, stats = tsv.solve_tiled(prob, tsv.state_to_lanes(state), opts)
    return tsv.state_from_lanes(st), stats


def test_solve_tiled_symmetrize_matches_jax_f64():
    """f64 on 16 lanes against jax.vmap(solve) with symmetrize_ctg: status
    and iterations equal, x and u to 1e-8; the same run as without the
    option, exactly."""
    assert tsv.supported_options(OPTS)
    x0s = _starts(jload())[:16]
    j_state, j_stats = _jax_vmapped_solve(x0s)
    st, stats = _port_solve_tiled(x0s, OPTS)
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(j_stats.status))
    np.testing.assert_array_equal(stats.iterations.numpy(), np.asarray(j_stats.iterations))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
    st0, stats0 = _port_solve_tiled(x0s, OPTS.replace(symmetrize_ctg=False))
    assert torch.equal(stats.status, stats0.status)
    assert torch.equal(stats.iterations, stats0.iterations)
    assert torch.equal(st.x, st0.x) and torch.equal(st.u, st0.u)


def test_solve_tiled_symmetrize_matches_jax_solve_tiled_f32(_interpret):
    """f32 on one lane tile against JAX's solve_tiled itself (its Pallas
    kernels in interpret mode; they take float32 only), with
    tests/test_tile_solver.py's f32 tolerances: statuses and iterations
    equal on >= 99.9% of lanes, x and u within 3e-4 on >= 99.9% of lanes
    (a lane at an f32 Armijo tie may accept another trial: here one lane
    in 1024 ends 0.014 apart, with its status and iterations equal)."""
    x0s = _starts(jload())
    j_state, j_stats = _jax_solve_tiled(x0s)
    st, stats = _port_solve_tiled(x0s, OPTS, dtype=torch.float32)
    for got, want in ((stats.status, j_stats.status), (stats.iterations, j_stats.iterations)):
        assert float(np.mean(got.numpy() == np.asarray(want))) >= 0.999
    for got, want in ((st.x, j_state.x), (st.u, j_state.u)):
        err = np.abs(got.numpy() - np.asarray(want)).reshape(B, -1).max(axis=1)
        assert float(np.mean(err < 3e-4)) >= 0.999, np.sort(err)[-4:]
