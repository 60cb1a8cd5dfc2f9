"""The pendulum swing-up row through `solve_tiled` against altro_tpu.

Counterpart: scripts/bench_all.py:845-980 (`pendulum_swingup_mpc_B1024`)
and its f64 oracle twin tests/test_pendulum_mpc_trace.py. All f64 on
numpy inputs from a seed:

* `midpoint_cols(pendulum_cols())` against JAX's column step and the lane
  dynamics `midpoint(pendulum_continuous())`, to 1e-13; it names the
  pendulum's device step.
* `rollout_grid_ref` on the row's problem (the torque bound's two affine
  rows lie on u) against JAX's scan grid `ops/tile_iter.rollout_grid_tiled`
  (whose lanes the Pallas kernel matches), W=8, N=30: phi to 1e-10
  relative, the state stacks to 1e-10. JAX's tiles hold 1024 lanes; the
  port runs the first 64 (each lane's grid depends on that lane alone).
* The plain (2, 1) backward against JAX's Pallas kernel
  `riccati_backward_pallas_tiled` in interpret mode, float32 (the kernel
  takes no other type), diagonal costs, B=1024, N=30, with failing lanes,
  to the tolerance of tests/test_torch_riccati.py (K, d 2e-5; P, p 2e-4).
* 4 closed-loop ticks of `run_pendulum_swingup_tiled` at 8 lanes against
  JAX's `vmap(solve)` with the row's options (`pallas_backward=False`:
  diagonal expansions and the scan grid, the per-lane iterates JAX's
  `solve_tiled` promises, tests/test_tile_solver.py): statuses and
  iterations exact, plant states, x and u to 1e-9.
csrc/rollout_grid.cu's pendulum instantiations and riccati_dense.cu at
(2, 1) are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.pendulum import pendulum_continuous as jpendulum  # noqa: E402
from altro_tpu.models.tile_steps import midpoint_cols as jmidpoint_cols  # noqa: E402
from altro_tpu.models.tile_steps import pendulum_cols as jpendulum_cols  # noqa: E402
from altro_tpu.mpc import shift_trajectory  # noqa: E402
from altro_tpu.ops import tile_iter as jti  # noqa: E402
from altro_tpu.ops.pallas_riccati import (  # noqa: E402
    batch_to_tiles,
    riccati_backward_pallas_tiled,
    tiles_to_batch,
)
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import solve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.pendulum import pendulum_continuous  # noqa: E402
from altro_tpu_torch.models.tile_steps import (  # noqa: E402
    INTEGRATOR_MIDPOINT,
    MODEL_PENDULUM,
    midpoint_cols,
    pendulum_cols,
)
from altro_tpu_torch.ops import riccati_backward as rb  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402

N, n, m, W, H = 30, 2, 1, 8, 0.06


def _jax_problem(Nk=N):
    Qd = np.tile(np.full(n, 1e-1), (Nk + 1, 1))
    Qd[Nk] *= 100.0
    torque = JSpec(fn=lambda x, u, k: jnp.concatenate([u - 6.0, -6.0 - u]),
                   cone=JCone.NEGATIVE_ORTHANT, dim=2,
                   active=jnp.ones(Nk + 1, bool).at[Nk].set(False), label="torque bound",
                   diag_hessian=True, affine=True)
    return JProblem(
        N=Nk, n=n, m=m, dynamics=jmidpoint(jpendulum()), dynamics_jac=None,
        constraints=(torque,),
        cost=jlqr(jnp.asarray(Qd), jnp.full((Nk + 1, m), 1e-3),
                  jnp.asarray(np.tile([np.pi, 0.0], (Nk + 1, 1))), jnp.zeros((Nk + 1, m))),
        h=jnp.full(Nk, H), x0=jnp.zeros(n), dynamics_cols=jmidpoint_cols(jpendulum_cols()))


def _lanes(a):
    return torch.as_tensor(np.moveaxis(a, 0, -1)).contiguous()


def test_column_step_matches_jax_and_lane_dynamics():
    rng = np.random.default_rng(0)
    x = np.stack([np.pi * rng.uniform(-1.5, 1.5, 16), 3.0 * rng.standard_normal(16)])
    u = 4.0 * rng.standard_normal((1, 16))
    cols = midpoint_cols(pendulum_cols())
    got = torch.stack(cols(tuple(torch.as_tensor(x)), tuple(torch.as_tensor(u)), H))
    jgot = np.stack(jmidpoint_cols(jpendulum_cols())(tuple(jnp.asarray(x)),
                                                     tuple(jnp.asarray(u)), H))
    lane = midpoint(pendulum_continuous())(torch.as_tensor(x), torch.as_tensor(u), H, 0)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got.numpy(), lane.numpy(), rtol=1e-13, atol=1e-13)
    ds = cols.device_step
    assert (ds.model, ds.integrator, ds.n, ds.m) == (MODEL_PENDULUM, INTEGRATOR_MIDPOINT, n, m)
    assert ds.params == (1.0, 0.5, 0.1, 9.81)


def test_row_problem_matches_jax_and_the_grid_kernel_takes_it():
    jprob = _jax_problem()
    prob = mpc.pendulum_swingup_problem(dtype=torch.float64, device="cpu")
    for name in ("Q", "R", "q", "r", "c"):
        np.testing.assert_allclose(getattr(prob.cost, name).numpy(),
                                   np.asarray(getattr(jprob.cost, name)), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(prob.h.numpy(), np.asarray(jprob.h))
    spec, jspec = prob.constraints[0], jprob.constraints[0]
    np.testing.assert_array_equal(spec.active.numpy(), np.asarray(jspec.active))
    assert (spec.dim, spec.affine, spec.diag_hessian) == (2, True, True)
    # the kernel's lane-shared rows: the bound lies on u alone
    cax, cau, cg, act = rg.affine_constraint_stacks(prob)
    assert float(cax.abs().max()) == 0.0
    np.testing.assert_array_equal(cau[0, :, 0].numpy(), [1.0, -1.0])
    np.testing.assert_array_equal(cg[0].numpy(), [-6.0, -6.0])
    np.testing.assert_array_equal(act[:, 0].numpy(), np.r_[np.ones(N), 0.0])
    f32 = mpc.pendulum_swingup_problem(device="cpu")
    assert rg.ineligibility(f32) is None
    assert tsv.kernel_refusal(f32, mpc.pendulum_swingup_options(), vmapped=False) is None


def test_rollout_grid_ref_matches_jax_scan_grid_f64():
    Bj, Bt = 1024, 64
    jprob = _jax_problem()
    tprob = mpc.pendulum_swingup_problem(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    x = np.stack([np.linspace(0.0, np.pi, N + 1)[None].repeat(Bj, 0)
                  + 0.3 * rng.standard_normal((Bj, N + 1)),
                  rng.standard_normal((Bj, N + 1))], axis=-1)
    # reference torques around the bound, on either side
    u = 5.5 * np.sign(rng.standard_normal((Bj, N, m))) + 1.0 * rng.standard_normal((Bj, N, m))
    K = 0.5 * rng.standard_normal((Bj, N, m, n))
    d = rng.standard_normal((Bj, N, m))
    z = -np.abs(rng.standard_normal((Bj, N + 1, 2)))
    rho = 1.0 + 9.0 * rng.random(Bj)
    x0 = x[:, 0] + 0.05 * rng.standard_normal((Bj, n))
    alphas = 0.5 ** np.arange(W)

    T = batch_to_tiles
    x0_t = T(jnp.asarray(x0))
    axes = dataclasses.replace(
        jprob, cost=dataclasses.replace(jprob.cost, Q=False, R=False, q=False, r=False, c=False),
        h=False, x0=True, A=False, B=False, f_aff=False,
        constraints=tuple(dataclasses.replace(s, active=False) for s in jprob.constraints))
    ta = jti.TileArgs(dataclasses.replace(jprob, x0=x0_t), axes, (True,))
    phi_j, xs_j = jti.rollout_grid_tiled(
        ta, T(jnp.asarray(x)), T(jnp.asarray(u)), T(jnp.asarray(K)), T(jnp.asarray(d)),
        (T(jnp.asarray(z)),), T(jnp.asarray(rho)[:, None])[:, 0], jnp.asarray(alphas), x0_t)
    phi_j = np.stack([np.asarray(tiles_to_batch(p[..., None, :, :]))[:Bt, 0] for p in phi_j])
    xs_j = np.stack([np.asarray(tiles_to_batch(xw))[:Bt] for xw in xs_j])  # [W, Bt, N+1, n]

    args = (_lanes(x[:Bt]), _lanes(u[:Bt]), _lanes(K[:Bt]), _lanes(d[:Bt]), (_lanes(z[:Bt]),),
            torch.as_tensor(rho[:Bt]), torch.as_tensor(alphas), _lanes(x0[:Bt]))
    before = rg.LAUNCHES
    phi, xs = rg.rollout_grid(tprob, *args)
    assert rg.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert phi.shape == (W, Bt) and xs.shape == (W, N + 1, n, Bt)
    # the bound is active on some trials' knots and idle on others
    us = torch.as_tensor(u[:Bt]).movedim(0, -1)
    assert 0.05 < float((us.abs() > 6.0).double().mean()) < 0.95
    np.testing.assert_allclose(phi.numpy(), phi_j, rtol=1e-10)
    np.testing.assert_allclose(np.moveaxis(xs.numpy(), -1, 1), xs_j, rtol=1e-10, atol=1e-10)


def test_plain_2x1_backward_matches_pallas_kernel_interpret():
    Bsz = 1024
    rng = np.random.default_rng(5)
    A = np.eye(n)[None, None] + 0.05 * rng.standard_normal((Bsz, N, n, n))
    Bm = 0.3 * rng.standard_normal((Bsz, N, n, m))
    lxx = np.abs(rng.standard_normal((Bsz, N + 1, n))) + 0.1
    luu = np.abs(rng.standard_normal((Bsz, N, m))) + 0.1
    lx = rng.standard_normal((Bsz, N + 1, n))
    lu = rng.standard_normal((Bsz, N, m))
    reg = 0.05 * rng.random(Bsz)
    luu[3, [2, 5]] = -10.0  # lane 3 fails at knots 2 and 5, lane 6 at the last knot
    luu[6, N - 1] = -10.0
    A, Bm, lxx, luu, lx, lu, reg = (np.asarray(a, np.float32)
                                    for a in (A, Bm, lxx, luu, lx, lu, reg))
    out = riccati_backward_pallas_tiled(
        *(batch_to_tiles(jnp.asarray(a)) for a in (A, Bm, lxx, luu, lx, lu)),
        batch_to_tiles(jnp.asarray(reg)[:, None])[:, 0], lux=None, diag_cost=True,
        interpret=True)
    lanes = [_lanes(a) for a in (A, Bm, lxx, luu, lx, lu)] + [torch.as_tensor(reg)]
    got = rb.riccati_backward(*lanes, diag_cost=True)
    assert rb.LAUNCHES == 0
    for name, atol in (("K", 2e-5), ("d", 2e-5), ("P", 2e-4), ("p", 2e-4)):
        ref = np.asarray(tiles_to_batch(getattr(out, name)))
        np.testing.assert_allclose(np.moveaxis(getattr(got, name).numpy(), -1, 0), ref,
                                   atol=atol, rtol=1e-4, err_msg=name)
    ok = np.asarray(tiles_to_batch(out.ok[:, None])[:, 0])
    fail = np.asarray(tiles_to_batch(out.fail_index[:, None])[:, 0])
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.fail_index.numpy(), fail)
    assert fail[3] == 2 and fail[6] == N - 1 and int((~ok).sum()) == 2


def test_swingup_ticks_match_jax_vmapped_solve():
    Bt, T = 8, 4
    jprob = _jax_problem()
    opts = mpc.pendulum_swingup_options()
    jopts = dataclasses.replace(
        JOpts(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}),
        pallas_backward=False)
    dyn = jmidpoint(jpendulum())

    @jax.jit
    def tick(x, st):
        st, stats = jax.vmap(lambda x0, s: solve(dataclasses.replace(jprob, x0=x0), s,
                                                 jopts))(x, st)
        x = jax.vmap(lambda xi, ui: dyn(xi, ui, jnp.asarray(H), 0))(x, st.u[:, 0])
        return x, jax.vmap(shift_trajectory)(st), stats

    # lanes from the row's starts, and two spun fast enough that the torque
    # bound binds (nonzero duals) and their solves end without SUCCESS
    x0 = mpc.pendulum_initial_states(Bt, dtype=torch.float64, device="cpu").numpy()
    x0[-2:] = [[0.0, -8.0], [-2.0, -5.0]]
    st = dataclasses.replace(jbatch_init(jprob, Bt), u=jnp.full((Bt, N, m), 0.1))
    xt = jnp.asarray(x0)
    iters, statuses = [], []
    for _ in range(T):
        xt, st, stats = tick(xt, st)
        iters.append(np.asarray(stats.iterations))
        statuses.append(np.asarray(stats.status))

    prob = mpc.pendulum_swingup_problem(dtype=torch.float64, device="cpu")
    before = (rb.LAUNCHES, rg.LAUNCHES)
    res = mpc.run_pendulum_swingup_tiled(prob, torch.as_tensor(x0), ticks=T)
    assert (rb.LAUNCHES, rg.LAUNCHES) == before  # CPU tensors: the plain versions
    np.testing.assert_array_equal(res.iterations.numpy(), np.stack(iters))
    np.testing.assert_array_equal(res.status.numpy(), np.stack(statuses))
    assert 0 in set(res.status.flatten().tolist())
    np.testing.assert_allclose(res.x_true.numpy(), np.asarray(xt), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(st.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(st.u), rtol=0, atol=1e-9)
    # the bound is active on the spun lanes, and the statuses vary
    np.testing.assert_allclose(res.state.z[0].numpy(), np.asarray(st.z[0]), rtol=0, atol=1e-9)
    assert float(res.state.z[0][-2:].abs().max()) > 1e-3
    assert len(set(res.status.flatten().tolist())) > 1
    # the vmapped loop (the row's f64 reference on the card) takes the same steps
    ref = mpc.run_pendulum_swingup(prob, torch.as_tensor(x0), ticks=T)
    assert torch.equal(ref.status, res.status) and torch.equal(ref.iterations, res.iterations)
    assert torch.equal(ref.x_true, res.x_true)
    got = res.metrics()
    up = np.sqrt((np.mod(np.asarray(xt)[:, 0], 2 * np.pi) - np.pi) ** 2
                 + 0.1 * np.asarray(xt)[:, 1] ** 2)
    assert got["mean_up_error"] == pytest.approx(float(up.mean()), rel=1e-9)
    assert got["success_rate"] == float(np.mean(np.stack(statuses) == 0))
