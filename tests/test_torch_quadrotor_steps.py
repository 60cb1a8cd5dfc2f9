"""The quadrotor's rk4 column and block steps, and the batched trial grid
on them, against altro_tpu.

* `rk4_cols(quadrotor_cols())` and `rk4_tile(quadrotor_tile())` against
  the JAX steps of models/tile_steps.py and against the lane dynamics
  `rk4(quadrotor_continuous())` (the case of tests/test_pallas_rollout.py
  :56), in f64 to 1e-12; each names the quadrotor's device step.
* `rollout_grid_ref` on the quadrotor waypoint problem against the JAX
  scan grid `ops/tile_iter.rollout_grid_tiled` (whose lanes the Pallas
  kernel matches), f64, W=8, N=30: phi and the state stacks to 1e-10.
  JAX's tiles hold 1024 lanes; the port runs the first B=8 of them (each
  lane's grid depends on that lane alone).
* What the kernel paths accept: `rollout_grid.ineligibility` and
  `trial_rollout.ineligibility` take the quadrotor's steps at P=0 and
  name the row count they refuse.
csrc/rollout_grid.cu's quadrotor instantiation is held against
`rollout_grid_ref` on the card (tests/test_torch_kernels_cuda.py).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.integrators import rk4 as jrk4  # noqa: E402
from altro_tpu.models.quadrotor import quadrotor_continuous as jquad  # noqa: E402
from altro_tpu.models.tile_steps import quadrotor_cols as jquad_cols  # noqa: E402
from altro_tpu.models.tile_steps import quadrotor_tile as jquad_tile  # noqa: E402
from altro_tpu.models.tile_steps import rk4_cols as jrk4_cols  # noqa: E402
from altro_tpu.models.tile_steps import rk4_tile as jrk4_tile  # noqa: E402
from altro_tpu.ops import tile_iter as jti  # noqa: E402
from altro_tpu.ops.pallas_riccati import batch_to_tiles, tiles_to_batch  # noqa: E402
from altro_tpu.problem import DiagonalCost as JDiag  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.models.integrators import rk4  # noqa: E402
from altro_tpu_torch.models.quadrotor import quadrotor_continuous  # noqa: E402
from altro_tpu_torch.models.tile_steps import (  # noqa: E402
    INTEGRATOR_RK4,
    MODEL_QUADROTOR,
    block_step_from_cols,
    quadrotor_cols,
    quadrotor_tile,
    rk4_cols,
    rk4_tile,
)
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402

n, m, W, N, H = 12, 4, 8, 30, 0.05
PARAMS = (0.5, 9.81, 0.175, 1.0, 0.0245, 0.0023, 0.0023, 0.004)


def _states(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((rows, n))
    u = 1.2 + 0.3 * rng.standard_normal((rows, m))
    return x, u


def test_column_step_matches_jax_and_lane_dynamics():
    x, u = _states(16)
    cols = rk4_cols(quadrotor_cols())
    got = torch.stack(cols(tuple(torch.as_tensor(x.T)), tuple(torch.as_tensor(u.T)), H))
    jgot = np.stack(jrk4_cols(jquad_cols())(tuple(jnp.asarray(x.T)), tuple(jnp.asarray(u.T)), H))
    lane = rk4(quadrotor_continuous())(torch.as_tensor(x.T), torch.as_tensor(u.T), H, 0)
    jlane = jax.vmap(lambda xi, ui: jrk4(jquad())(xi, ui, H, 0))(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), lane.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(lane.numpy().T, np.asarray(jlane), rtol=1e-12, atol=1e-12)
    ds = cols.device_step
    assert (ds.model, ds.integrator, ds.n, ds.m) == (MODEL_QUADROTOR, INTEGRATOR_RK4, n, m)
    assert ds.params == PARAMS


def test_block_step_matches_jax_and_lane_dynamics():
    x, u = _states(W, seed=1)
    hcol = torch.full((W, 1), H, dtype=torch.float64)
    step = rk4_tile(quadrotor_tile())
    got = step(torch.as_tensor(x), torch.as_tensor(u), hcol)
    jgot = jrk4_tile(jquad_tile())(jnp.asarray(x), jnp.asarray(u), jnp.full((W, 1), H))
    lane = rk4(quadrotor_continuous())(torch.as_tensor(x.T), torch.as_tensor(u.T), H, 0).T
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), lane.numpy(), rtol=1e-12, atol=1e-12)
    # the column step lifted to blocks is the same step, with the same twin
    lifted = block_step_from_cols(rk4_cols(quadrotor_cols()))
    np.testing.assert_allclose(lifted(torch.as_tensor(x), torch.as_tensor(u), hcol).numpy(),
                               got.numpy(), rtol=1e-14, atol=1e-15)
    assert lifted.device_step == step.device_step == rk4_cols(quadrotor_cols()).device_step


def test_kernel_paths_accept_the_quadrotor_steps():
    prob = mpc.quadrotor_waypoint_problem(N=4, device="cpu")
    assert rg.ineligibility(prob) is None and rg.rollout_tiled_eligible(prob)
    for Wt in (1, 8, 32):
        assert tr.ineligibility(prob.dynamics_tile, n, m, Wt, 0) is None
    assert "W=33" in tr.ineligibility(prob.dynamics_tile, n, m, 33, 0)
    assert "quadrotor_rk4 step is instantiated for (0,)" in tr.ineligibility(
        prob.dynamics_tile, n, m, 8, 2)
    assert "n=12, m=4" in tr.ineligibility(prob.dynamics_tile, 4, 2, 8, 0)
    assert "names no device step" in rg.ineligibility(
        dataclasses.replace(prob, dynamics_cols=rk4_cols(lambda x, u: x)))


def _lanes(a):
    return torch.as_tensor(np.moveaxis(a, 0, -1)).contiguous()


def test_rollout_grid_ref_matches_jax_scan_grid_f64():
    Bj, Bt = 1024, 8
    tprob = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    c = tprob.cost
    jcost = JDiag(**{k: jnp.asarray(getattr(c, k).numpy()) for k in ("Q", "R", "q", "r", "c")})
    rng = np.random.default_rng(3)
    # around hover: small rotor imbalances and gains keep the attitudes
    # bounded over the 1.5 s horizon
    x = 0.1 * rng.standard_normal((Bj, N + 1, n))
    u = mpc.QUAD_HOVER + 0.01 * rng.standard_normal((Bj, N, m))
    K = 0.02 * rng.standard_normal((Bj, N, m, n))
    d = 0.02 * rng.standard_normal((Bj, N, m))
    rho = 1.0 + rng.random(Bj)
    x0 = x[:, 0] + 0.05 * rng.standard_normal((Bj, n))
    alphas = 0.5 ** np.arange(W)

    jprob = JProblem(N=N, n=n, m=m, dynamics=jrk4(jquad()), dynamics_jac=None, constraints=(),
                     cost=jcost, h=jnp.full(N, H), x0=jnp.zeros(n))
    T = batch_to_tiles
    x0_t = T(jnp.asarray(x0))
    axes = dataclasses.replace(
        jprob, cost=dataclasses.replace(jprob.cost, Q=False, R=False, q=False, r=False, c=False),
        h=False, x0=True, A=False, B=False, f_aff=False, constraints=())
    ta = jti.TileArgs(dataclasses.replace(jprob, x0=x0_t), axes, ())
    phi_j, xs_j = jti.rollout_grid_tiled(
        ta, T(jnp.asarray(x)), T(jnp.asarray(u)), T(jnp.asarray(K)), T(jnp.asarray(d)), (),
        T(jnp.asarray(rho)[:, None])[:, 0], jnp.asarray(alphas), x0_t)
    phi_j = np.stack([np.asarray(tiles_to_batch(p[..., None, :, :]))[:Bt, 0] for p in phi_j])
    xs_j = np.stack([np.asarray(tiles_to_batch(xw))[:Bt] for xw in xs_j])  # [W, Bt, N+1, n]

    args = (_lanes(x[:Bt]), _lanes(u[:Bt]), _lanes(K[:Bt]), _lanes(d[:Bt]), (),
            torch.as_tensor(rho[:Bt]), torch.as_tensor(alphas), _lanes(x0[:Bt]))
    before = rg.LAUNCHES
    phi, xs = rg.rollout_grid(tprob, *args)
    assert rg.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert phi.shape == (W, Bt) and xs.shape == (W, N + 1, n, Bt)
    assert np.all(np.isfinite(phi_j)) and np.all(np.isfinite(xs_j))
    assert 0.3 < float(np.abs(xs_j).max()) < 10.0
    np.testing.assert_allclose(phi.numpy(), phi_j, rtol=1e-10)
    np.testing.assert_allclose(np.moveaxis(xs.numpy(), -1, 1), xs_j, rtol=1e-10, atol=1e-10)
    assert torch.equal(phi, rg.rollout_grid_ref(tprob, *args)[0])
