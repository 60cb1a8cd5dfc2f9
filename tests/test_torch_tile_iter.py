"""Batched iteration blocks of the PyTorch port against altro_tpu's tiled ones.

Counterpart: altro_tpu/ops/tile_iter.py. Both packages get the same
solver state (a JAX SolverState after np.asarray on each leaf, loaded with
convert.state_from_numpy) at B=1024, N=12, f64, with the steering bound
active and nonzero duals; `cost_expansions_tiled` (diagonal and dense),
`completion_tiled` and `light_from_xstack_tiled` agree to rtol 1e-10.
The trial selection and the adaptive-regularization retry are checked on
their own.
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
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import SolverState as JState  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.ops import tile_iter as ti  # noqa: E402
from altro_tpu_torch.ops.riccati_backward import Gains  # noqa: E402

B, N, n, m = 1024, 12, 4, 2
DM = 60 * np.pi / 180.0


def _setup():
    ref = load_scotty()
    tprob = mpc.scotty_problem(ref, N=N, dtype=torch.float64)
    h = float(tprob.h[0])
    jprob = JProblem(
        N=N, n=n, m=m, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
        constraints=(JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                           cone=JCone.NEGATIVE_ORTHANT, dim=2,
                           active=jnp.ones(N + 1, bool), diag_hessian=True, affine=True),),
        cost=jlqr(jnp.asarray(np.full((N + 1, n), 1e-2)),
                  jnp.asarray(np.full((N + 1, m), 1e-3)),
                  jnp.asarray(ref.x[: N + 1]), jnp.asarray(ref.u[: N + 1])),
        h=jnp.full(N, h), x0=jnp.asarray(ref.x[0]))
    rng = np.random.default_rng(11)
    x = ref.x[None, : N + 1] + 0.2 * rng.standard_normal((B, N + 1, n))
    x[:, :, 3] = np.sign(rng.standard_normal((B, 1))) * (1.0 + 0.1 * rng.standard_normal((B, N + 1)))
    jstate = JState(
        x=jnp.asarray(x), u=jnp.asarray(ref.u[None, :N] + 0.1 * rng.standard_normal((B, N, m))),
        y=jnp.asarray(rng.standard_normal((B, N + 1, n))),
        z=(jnp.asarray(np.abs(rng.standard_normal((B, N + 1, 2)))),),
        rho=jnp.asarray(1.0 + 9.0 * rng.random(B)),
        K=jnp.asarray(0.1 * rng.standard_normal((B, N, m, n))),
        d=jnp.asarray(0.1 * rng.standard_normal((B, N, m))),
        P=jnp.asarray(rng.standard_normal((B, N + 1, n, n))),
        p=jnp.asarray(rng.standard_normal((B, N + 1, n))),
        reg=jnp.zeros(B))
    arrays = {f.name: (tuple(np.asarray(z) for z in jstate.z) if f.name == "z"
                       else np.asarray(getattr(jstate, f.name)))
              for f in dataclasses.fields(JState)}
    tstate = tsv.state_to_lanes(state_from_numpy(arrays))
    prob_axes = dataclasses.replace(
        jprob, cost=dataclasses.replace(jprob.cost, Q=False, R=False, q=False, r=False,
                                        c=False),
        h=False, x0=True, A=False, B=False, f_aff=False,
        constraints=tuple(dataclasses.replace(s, active=False) for s in jprob.constraints))
    x0 = x[:, 0]
    ta = jti.TileArgs(dataclasses.replace(jprob, x0=batch_to_tiles(jnp.asarray(x0))),
                      prob_axes, (True,))
    tprob = dataclasses.replace(tprob, x0=torch.as_tensor(x0.T).contiguous())
    jt = {k: batch_to_tiles(getattr(jstate, k)) for k in ("x", "u", "K", "d", "P", "p")}
    jt["z"] = tuple(batch_to_tiles(z) for z in jstate.z)
    jt["rho"] = batch_to_tiles(jstate.rho[:, None])[:, 0]
    return ta, jt, tprob, tstate, arrays


SETUP = None


def _get():
    global SETUP
    if SETUP is None:
        SETUP = _setup()
    return SETUP


def _cmp(port, jax_tiled, name, scalar=False):
    ref = np.asarray(tiles_to_batch(jax_tiled[..., None, :, :]))[:, 0] if scalar \
        else np.asarray(tiles_to_batch(jax_tiled))
    np.testing.assert_allclose(np.moveaxis(port.numpy(), -1, 0), ref, rtol=1e-10,
                               atol=1e-12, err_msg=name)


def test_state_round_trip():
    _, _, _, tstate, arrays = _get()
    back = state_to_numpy(tsv.state_from_lanes(tstate))
    for k, v in arrays.items():
        if k == "z":
            for a, b in zip(back[k], v):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("diag", [True, False])
def test_cost_expansions_match(diag):
    ta, jt, tprob, ts, _ = _get()
    jout = jti.cost_expansions_tiled(ta, jt["x"], jt["u"], jt["z"], jt["rho"], diag=diag)
    tout = ti.cost_expansions_tiled(tprob, ts.x, ts.u, ts.z, ts.rho, diag=diag)
    for name, a, b in zip(("lx", "lu", "lxx", "luu"), tout[:4], jout[:4]):
        _cmp(a, b, name)
    if diag:
        assert tout[4] is None and jout[4] is None
    else:
        _cmp(tout[4], jout[4], "lux")
    _cmp(tout[5], jout[5], "phi0", scalar=True)


def test_completion_and_light_match():
    ta, jt, tprob, ts, _ = _get()
    jA, jB, jlx, jlu = jti.completion_tiled(ta, jt["x"], jt["u"], jt["z"], jt["rho"])
    tA, tB, tlx, tlu = ti.completion_tiled(tprob, ts.x, ts.u, ts.z, ts.rho)
    for name, a, b in (("A", tA, jA), ("B", tB, jB), ("lx", tlx, jlx), ("lu", tlu, jlu)):
        _cmp(a, b, name)
    alpha = np.linspace(0.0, 1.0, B)
    x_new = ts.x + 0.01
    ju, jy, jconv, jzp = jti.light_from_xstack_tiled(
        ta, jt["x"] + 0.01, jt["x"], jt["u"], jt["K"], jt["d"], jt["P"], jt["p"], jt["z"],
        jt["rho"], batch_to_tiles(jnp.asarray(alpha)[:, None])[:, 0])
    tu, ty, tconv, tzp = ti.light_from_xstack_tiled(
        tprob, x_new, ts.x, ts.u, ts.K, ts.d, ts.P, ts.p, ts.z, ts.rho,
        torch.as_tensor(alpha))
    for name, a, b in (("u", tu, ju), ("y", ty, jy), ("convals", tconv[0], jconv[0]),
                       ("zproj", tzp[0], jzp[0])):
        _cmp(a, b, name)
    assert float((tzp[0] != 0).double().mean()) > 0.01  # duals project to nonzero


def test_select_trial_and_best_ignore_nonfinite_trials():
    """A diverged trial's inf/NaN must not reach the selected lane."""
    Bl = 5
    phis = torch.stack([torch.full((Bl,), float("inf")), torch.full((Bl,), 2.0),
                        torch.full((Bl,), 5.0)]).double()
    xst = torch.stack([torch.full((4, 2, Bl), float("nan")), torch.full((4, 2, Bl), 20.0),
                       torch.full((4, 2, Bl), 50.0)]).double()
    alphas = torch.tensor([1.0, 0.5, 0.25], dtype=torch.float64)
    alpha, phi, xsel = ti.select_best_tiled(alphas, phis, xst)
    assert torch.all(phi == 2.0) and torch.all(alpha == 0.5) and torch.all(xsel == 20.0)
    passes = torch.stack([torch.zeros(Bl, dtype=torch.bool), torch.ones(Bl, dtype=torch.bool),
                          torch.ones(Bl, dtype=torch.bool)])
    found, idx, alpha2, phi2, xsel2 = ti.select_trial_tiled(passes, alphas, phis, xst)
    assert bool(found.all()) and torch.all(idx == 1)
    assert torch.all(phi2 == 2.0) and torch.all(xsel2 == 20.0) and torch.all(alpha2 == 0.5)
    none = torch.zeros_like(passes)
    found3, idx3, _, _, _ = ti.select_trial_tiled(none, alphas, phis, xst)
    assert not bool(found3.any()) and torch.all(idx3 == 0)


def test_retry_bumps_reg_only_on_failing_lanes():
    from altro_tpu_torch.options import SolverOptions

    opts = SolverOptions(reg_min=1e-3, reg_scaling=10.0, reg_max_retries=5)
    calls = []

    def attempt(reg):
        calls.append(reg.clone())
        ok = reg >= torch.tensor([0.0, 0.0, 1e-2, 0.0])  # lane 2 needs reg >= 1e-2
        z = torch.zeros(4, dtype=torch.float64)
        return Gains(reg[None], z[None], z[None], z[None], z[None], ok,
                     torch.where(ok, 3, 0).to(torch.int32))

    g, reg = ti.retry_tiled(opts, attempt, torch.zeros(4, dtype=torch.float64))
    assert bool(g.ok.all())
    np.testing.assert_allclose(reg.numpy(), [0.0, 0.0, 1e-2, 0.0])
    assert len(calls) == 3  # 0 -> 1e-3 -> 1e-2
    np.testing.assert_allclose(g.K[0].numpy(), [0.0, 0.0, 1e-2, 0.0])
