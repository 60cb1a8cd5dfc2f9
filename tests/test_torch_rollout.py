"""W-trial rollout grid of the PyTorch port against altro_tpu.

The plain version (ops/rollout_grid.py::rollout_grid_ref) against the JAX
scan grid `ops/tile_iter.rollout_grid_tiled` (which the Pallas kernel
matches) at B=1024, N=12, W=8, unconstrained and with the steering bound
active and nonzero duals: phi and the state stacks to rtol 1e-10 in f64.
Also checks the kernel's operand contract (the rows it forms from the
affine stacks, z and rho, through their plain twin) against the plain AL
merit, since the CUDA kernel itself runs only on the card.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.ops import tile_iter as jti  # noqa: E402
from altro_tpu.ops.pallas_riccati import batch_to_tiles, tiles_to_batch  # noqa: E402
from altro_tpu.ops.pallas_rollout import affine_constraint_stacks as jstacks  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu_torch import al, mpc  # noqa: E402
from altro_tpu_torch.cones import Cone  # noqa: E402
from altro_tpu_torch.convert import problem_from_numpy  # noqa: E402
from altro_tpu_torch.models.bicycle import bicycle_continuous  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.tile_steps import bicycle_cols, midpoint_cols  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from altro_tpu_torch.problem import ConstraintSpec  # noqa: E402

B, N, n, m, W = 1024, 12, 4, 2, 8
DM = 60 * np.pi / 180.0


def _problems(constrained):
    rng = np.random.default_rng(3)
    xref = np.cumsum(0.1 * rng.standard_normal((N + 1, n)), axis=0)
    uref = 0.1 * rng.standard_normal((N + 1, m))
    Qd, Rd = np.full((N + 1, n), 1e-2), np.full((N + 1, m), 1e-3)
    jcost = jlqr(jnp.asarray(Qd), jnp.asarray(Rd), jnp.asarray(xref), jnp.asarray(uref))
    jspec = JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                  cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                  diag_hessian=True, affine=True)
    jprob = JProblem(N=N, n=n, m=m, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
                     constraints=(jspec,) if constrained else (), cost=jcost,
                     h=jnp.full(N, 0.1), x0=jnp.asarray(xref[0]))
    arrays = {k: np.asarray(getattr(jcost, k)) for k in ("Q", "R", "q", "r", "c")}
    arrays.update(h=np.full(N, 0.1), x0=xref[0], active=[np.ones(N + 1, bool)])
    steering = ConstraintSpec(fn=mpc._steering_fn, cone=Cone.NEGATIVE_ORTHANT, dim=2,
                              active=torch.ones(N + 1, dtype=torch.bool),
                              diag_hessian=True, affine=True)
    tprob = problem_from_numpy(arrays, N=N, n=n, m=m, dynamics=midpoint(bicycle_continuous()),
                               constraints=(steering,) if constrained else (),
                               dynamics_cols=midpoint_cols(bicycle_cols()), device="cpu")
    return jprob, tprob


def _inputs(problem_dims_z, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((B, N + 1, n))
    # steering angle around the 60 deg bound, on either side
    x[:, :, 3] = np.sign(rng.standard_normal((B, 1))) * (1.0 + 0.1 * x[:, :, 3])
    u = 0.1 * rng.standard_normal((B, N, m))
    K = 0.05 * rng.standard_normal((B, N, m, n))
    d = 0.1 * rng.standard_normal((B, N, m))
    z = tuple(np.abs(rng.standard_normal((B, N + 1, p))) for p in problem_dims_z)
    rho = 1.0 + 9.0 * rng.random(B)
    x0 = x[:, 0] + 0.05 * rng.standard_normal((B, n))
    return x, u, K, d, z, rho, x0


def _lanes(a):
    return torch.as_tensor(np.moveaxis(a, 0, -1)).contiguous()


@pytest.mark.parametrize("constrained", [False, True])
def test_ref_matches_jax_scan_grid(constrained):
    jprob, tprob = _problems(constrained)
    x, u, K, d, z, rho, x0 = _inputs([2] if constrained else [])
    alphas = 0.5 ** np.arange(W)
    T = batch_to_tiles
    x0_t = T(jnp.asarray(x0))
    prob_axes = dataclasses.replace(
        jprob, cost=dataclasses.replace(jprob.cost, Q=False, R=False, q=False, r=False,
                                        c=False),
        h=False, x0=True, A=False, B=False, f_aff=False,
        constraints=tuple(dataclasses.replace(s, active=False) for s in jprob.constraints))
    ta = jti.TileArgs(dataclasses.replace(jprob, x0=x0_t), prob_axes,
                      tuple(True for _ in z))
    phi_j, xs_j = jti.rollout_grid_tiled(
        ta, T(jnp.asarray(x)), T(jnp.asarray(u)), T(jnp.asarray(K)), T(jnp.asarray(d)),
        tuple(T(jnp.asarray(zj)) for zj in z), T(jnp.asarray(rho)[:, None])[:, 0],
        jnp.asarray(alphas), x0_t)
    phi_j = np.stack([np.asarray(tiles_to_batch(p[..., None, :, :]))[:, 0] for p in phi_j])
    xs_j = np.stack([np.asarray(tiles_to_batch(xw)) for xw in xs_j])  # [W, B, N+1, n]

    phi, xs = rg.rollout_grid_ref(
        tprob, _lanes(x), _lanes(u), _lanes(K), _lanes(d), tuple(_lanes(zj) for zj in z),
        torch.as_tensor(rho), torch.as_tensor(alphas), _lanes(x0))
    assert np.all(np.isfinite(phi_j))
    np.testing.assert_allclose(phi.numpy(), phi_j, rtol=1e-10)
    np.testing.assert_allclose(np.moveaxis(xs.numpy(), -1, 1), xs_j, rtol=1e-10, atol=1e-12)
    # the wrapper on CPU tensors is the plain version
    phi2, _ = rg.rollout_grid(
        tprob, _lanes(x), _lanes(u), _lanes(K), _lanes(d), tuple(_lanes(zj) for zj in z),
        torch.as_tensor(rho), torch.as_tensor(alphas), _lanes(x0))
    assert torch.equal(phi, phi2)


def test_affine_stacks_match_jax():
    jprob, tprob = _problems(True)
    for a, b in zip(rg.affine_constraint_stacks(tprob), jstacks(jprob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=0)


def test_kernel_rows_reproduce_al_merit():
    """The kernel's operand contract: from the lane-shared affine stacks,
    the lane's duals z and its rho, the rows it forms (`premultiplied_rows`,
    their plain twin) give the plain AL merit (`al.al_cost`) at every
    stage knot and at the terminal knot, and sum to the grid's phi."""
    _, tprob = _problems(True)
    x, u, K, d, z, rho, x0 = _inputs([2], seed=7)
    Wt = 3
    alphas = torch.as_tensor(0.5 ** np.arange(Wt))
    args = (_lanes(x), _lanes(u), _lanes(K), _lanes(d), tuple(_lanes(zj) for zj in z),
            torch.as_tensor(rho), alphas, _lanes(x0))
    phi, xs = rg.rollout_grid_ref(tprob, *args)
    xr, ur, Kl, dl, zl, rh, _, _ = args
    wax, wau, wg, rhoi = rg.premultiplied_rows(rg.affine_constraint_stacks(tprob), zl, rh)
    c = tprob.cost
    xk = xs[:, :N]
    uk = ur[None] - torch.einsum("kjib,wkib->wkjb", Kl, xk - xr[None, :N]) \
        + alphas[:, None, None, None] * dl[None]
    stage = (0.5 * (c.Q[:N, :, None] * xk * xk).sum(2) + (c.q[:N, :, None] * xk).sum(2)
             + 0.5 * (c.R[:N, :, None] * uk * uk).sum(2) + (c.r[:N, :, None] * uk).sum(2)
             + c.c[:N, None])
    we = wg[None, :N] - torch.einsum("kpib,wkib->wkpb", wax[:N], xk) \
        - torch.einsum("kpjb,wkjb->wkpb", wau[:N], uk)
    stage = stage + (rhoi * torch.clamp(we, max=0.0) ** 2).sum(2)  # [W, N, B]
    xN = xs[:, N]
    term = 0.5 * (c.Q[N, :, None] * xN * xN).sum(1) + (c.q[N, :, None] * xN).sum(1) + c.c[N]
    weN = wg[None, N] - torch.einsum("pib,wib->wpb", wax[N], xN)
    term = term + (rhoi * torch.clamp(weN, max=0.0) ** 2).sum(1)  # [W, B]
    assert float((torch.clamp(we, max=0.0) != 0).float().mean()) > 0.01  # bound bites

    z_stage = tuple(zj[:N] for zj in zl)
    z_term = tuple(zj[N:] for zj in zl)
    for w in range(Wt):
        ref = al.al_cost(tprob, torch.arange(N), xk[w], uk[w], z_stage, rh, terminal=False)[0]
        np.testing.assert_allclose(stage[w].numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)
        ref_t = al.al_cost(tprob, torch.full((1,), N), xN[w][None], None, z_term, rh,
                           terminal=True)[0][0]
        np.testing.assert_allclose(term[w].numpy(), ref_t.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose((stage.sum(1) + term).numpy(), phi.numpy(), rtol=1e-10)
