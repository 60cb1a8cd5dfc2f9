"""Per-lane cost rows and h through the batched solve and its trial grid.

JAX's `solve_tiled` takes any leaf of the problem batched through
`prob_axes` (altro_tpu/tile_solver.py:118-123) and its trial-grid kernel
streams every cost row and h per lane, broadcasting the shared ones
(altro_tpu/ops/pallas_rollout_tiled.py:237-248). The port's DiagonalCost
takes a trailing lane axis on any leaf (Q, q [N+1, n, B], R, r
[N+1, m, B], c [N+1, B]) and its Problem h [N, B].

* f64: the bicycle with the steering bound (P = 2), N = 8, 6 lanes, all
  six leaves random per lane, through the port's `solve_tiled` and
  `solve_tiled_with_rescue` against jax.vmap(solve) over the same
  per-lane problems (the per-lane iterates JAX's `solve_tiled` promises;
  its tiled kernels take float32 only) and the rescue's two tiers
  composed from it: statuses and iterations equal lane for lane, states
  and inputs within 1e-10.
* f32: the port's plain trial grid (`rollout_grid_ref`) with every leaf
  per lane against JAX's `rollout_grid_pallas_tiled` in interpret mode on
  one lane tile (1024 lanes): phi within 1e-5 relative to the size of the
  terms that cancel in it (each lane's sum of |c| over the knots), states
  within 1e-5 of their scale.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.io.scotty import load_scotty as jload  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.tile_steps import bicycle_cols as jbicycle_cols  # noqa: E402
from altro_tpu.models.tile_steps import midpoint_cols as jmidpoint_cols  # noqa: E402
from altro_tpu.ops import tile_iter as jti  # noqa: E402
from altro_tpu.ops.pallas_riccati import batch_to_tiles, tiles_to_batch  # noqa: E402
from altro_tpu.ops.pallas_rollout_tiled import rollout_grid_pallas_tiled  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import DiagonalCost as JDiagonalCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import convert, mpc, rescue  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.models.bicycle import bicycle_continuous  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.tile_steps import bicycle_cols, midpoint_cols  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from altro_tpu_torch.parallel.batch import batch_init_state  # noqa: E402

N, n, m = 8, 4, 2
DM = 60 * np.pi / 180.0
LEAVES = ("Q", "q", "R", "r", "c", "h")
OPTS, OPTS_R = mpc.bench_options(iterations_max=3)


def _jopts(o):
    return JOpts(**{f.name: getattr(o, f.name) for f in dataclasses.fields(o)})


def _leaves(B, seed=0):
    """Every cost leaf and h per lane, batch-major [B, ...] (JAX's layout
    under prob_axes): the tracking cost of a window at lane b's own place
    on the path, with per-lane weights and step lengths."""
    rng = np.random.default_rng(seed)
    ref = jload()
    starts = rng.integers(0, 400, size=B)
    xr = np.stack([ref.x[s: s + N + 1] for s in starts])  # [B, N+1, n]
    ur = np.stack([ref.u[s: s + N + 1] for s in starts])
    Q = 1e-2 * (1.0 + rng.random((B, N + 1, n)))
    R = 1e-3 * (1.0 + rng.random((B, N + 1, m)))
    h = float(np.float32(ref.tf / ref.N)) * (1.0 + 0.1 * rng.random((B, N)))
    c = 0.5 * np.sum(Q * xr * xr, axis=2) + 0.5 * np.sum(R * ur * ur, axis=2) \
        + 1e-3 * rng.standard_normal((B, N + 1))
    x0 = xr[:, 0] + 0.05 * rng.standard_normal((B, n))
    return dict(Q=Q, q=-Q * xr, R=R, r=-R * ur, c=c, h=h, x0=x0), xr, ur


def _steering_j():
    return JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                 cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                 label="steering", diag_hessian=True, affine=True)


def _jax_problem(arrays, dt, lane=None):
    """JAX's problem with lane `lane`'s leaves (None: the batched leaves
    whole, for prob_axes)."""
    a = {k: jnp.asarray(v if lane is None else v[lane], dt) for k, v in arrays.items()}
    return JProblem(N=N, n=n, m=m, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
                    constraints=(_steering_j(),),
                    cost=JDiagonalCost(Q=a["Q"], R=a["R"], q=a["q"], r=a["r"], c=a["c"]),
                    h=a["h"], x0=a["x0"], dynamics_cols=jmidpoint_cols(jbicycle_cols()))


def _port_problem(arrays, dtype):
    bound = mpc.scotty_problem(jload(), N=N, dtype=dtype, device="cpu").constraints
    return convert.problem_from_numpy(arrays, N=N, n=n, m=m,
                                      dynamics=midpoint(bicycle_continuous()),
                                      constraints=bound,
                                      dynamics_cols=midpoint_cols(bicycle_cols()),
                                      batched=LEAVES + ("x0",), dtype=dtype, device="cpu")


def _warm(B, xr, ur):
    return dict(x=xr, u=np.stack([np.stack([ur[b, :N, 0], np.zeros(N)], axis=1)
                                  for b in range(B)]))


def _jax_vmapped(arrays, warm, opts, dt=jnp.float64, state=None):
    B = arrays["x0"].shape[0]
    probs = _jax_problem(arrays, dt)
    if state is None:
        state = dataclasses.replace(jbatch_init(_jax_problem(arrays, dt, 0), B),
                                    x=jnp.asarray(warm["x"], dt), u=jnp.asarray(warm["u"], dt))

    def one(Q, q, R, r, c, h, x0, s):
        prob = dataclasses.replace(probs, cost=JDiagonalCost(Q=Q, R=R, q=q, r=r, c=c), h=h,
                                   x0=x0)
        return jsolve(prob, s, _jopts(opts))

    c = probs.cost
    return jax.jit(jax.vmap(one))(c.Q, c.q, c.R, c.r, c.c, probs.h, probs.x0, state)


def _port_state(prob, B, warm, dtype):
    st = batch_init_state(dataclasses.replace(prob, x0=prob.x0[:, 0]), B)
    return tsv.state_to_lanes(dataclasses.replace(
        st, x=torch.as_tensor(warm["x"], dtype=dtype), u=torch.as_tensor(warm["u"], dtype=dtype)))


def test_per_lane_leaves_solve_tiled_and_rescue_match_jax_f64():
    B = 6
    arrays, xr, ur = _leaves(B)
    warm = _warm(B, xr, ur)
    prob = _port_problem(arrays, torch.float64)
    assert prob.cost.lane_leaves == ("Q", "q", "R", "r", "c") and prob.h.shape == (N, B)
    assert rg.rollout_tiled_eligible(prob)  # the kernel takes per-lane rows

    j_st, j_stats = _jax_vmapped(arrays, warm, OPTS)
    st, stats = tsv.solve_tiled(prob, _port_state(prob, B, warm, torch.float64), OPTS)
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(j_stats.status))
    np.testing.assert_array_equal(stats.iterations.numpy(), np.asarray(j_stats.iterations))
    for got, want in ((st.x, j_st.x), (st.u, j_st.u)):
        np.testing.assert_allclose(tsv.lanes_to_batch(got).numpy(), np.asarray(want),
                                   rtol=0, atol=1e-10)

    # the rescue: failed lanes solved again from their post-solve state
    failed = np.asarray(j_stats.status) != 0
    assert failed.any() and not failed.all()
    r_st, r_stats = _jax_vmapped(arrays, warm, OPTS_R, state=j_st)
    info = {}
    st2, stats2 = rescue.solve_tiled_with_rescue(
        prob, _port_state(prob, B, warm, torch.float64), OPTS, OPTS_R, info)
    assert info["rescued"]
    np.testing.assert_array_equal(
        stats2.status.numpy(), np.where(failed, np.asarray(r_stats.status), j_stats.status))
    np.testing.assert_array_equal(
        stats2.iterations.numpy(),
        np.asarray(j_stats.iterations) + np.where(failed, np.asarray(r_stats.iterations), 0))
    for got, want_r, want in ((st2.x, r_st.x, j_st.x), (st2.u, r_st.u, j_st.u)):
        sel = failed.reshape((-1,) + (1,) * (np.asarray(want).ndim - 1))
        np.testing.assert_allclose(tsv.lanes_to_batch(got).numpy(),
                                   np.where(sel, np.asarray(want_r), np.asarray(want)),
                                   rtol=0, atol=1e-10)


def test_plain_grid_per_lane_rows_match_pallas_interpret_f32():
    B, W = 1024, 8
    arrays, xr, ur = _leaves(B, seed=3)
    rng = np.random.default_rng(4)
    K = 0.2 * rng.standard_normal((B, N, m, n))
    d = 0.2 * rng.standard_normal((B, N, m))
    z = np.abs(rng.standard_normal((B, N + 1, 2)))
    rho = 1.0 + 9.0 * rng.random(B)
    alphas = np.asarray([0.5 ** k for k in range(W)])
    f32 = jnp.float32

    prob_j = _jax_problem(arrays, f32)
    axes = dataclasses.replace(
        prob_j, cost=dataclasses.replace(prob_j.cost, Q=True, R=True, q=True, r=True, c=True),
        h=True, x0=True, A=False, B=False, f_aff=False,
        constraints=tuple(dataclasses.replace(s, active=False) for s in prob_j.constraints))
    tiled = dataclasses.replace(
        prob_j, cost=jax.tree.map(batch_to_tiles, prob_j.cost), h=batch_to_tiles(prob_j.h),
        x0=batch_to_tiles(prob_j.x0))
    ta = jti.TileArgs(tiled, axes, (True,))
    t = lambda a: batch_to_tiles(jnp.asarray(a, f32))  # noqa: E731
    phi_j, xs_j = rollout_grid_pallas_tiled(
        ta, t(xr), t(ur[:, :N]), t(K), t(d), (t(z),), t(rho), jnp.asarray(alphas, f32),
        t(arrays["x0"]), interpret=True)
    phi_j = np.stack([np.asarray(tiles_to_batch(phi_j[w])) for w in range(W)])  # [W, B]
    xs_j = np.stack([np.asarray(tiles_to_batch(xs_j[w])) for w in range(W)])  # [W, B, N+1, n]

    prob = _port_problem(arrays, torch.float32)
    L = lambda a: tsv.batch_to_lanes(torch.as_tensor(a, dtype=torch.float32))  # noqa: E731
    phi, xs = rg.rollout_grid_ref(prob, L(xr), L(ur[:, :N]), L(K), L(d), (L(z),), L(rho),
                                  torch.as_tensor(alphas, dtype=torch.float32), prob.x0)
    # phi is the small difference of the cost's large terms (c near 8 a knot
    # on the path's coordinates): 1e-5 relative to their size, sum |c|
    size = np.abs(arrays["c"]).sum(axis=1)  # [B]
    assert np.all(np.abs(phi.numpy() - phi_j) <= 1e-5 * size[None]), \
        float(np.max(np.abs(phi.numpy() - phi_j) / size[None]))
    xs_p = xs.permute(0, 3, 1, 2).numpy()  # [W, B, N+1, n]
    scale = np.abs(xs_j).max()
    assert np.abs(xs_p - xs_j).max() <= 1e-5 * scale
