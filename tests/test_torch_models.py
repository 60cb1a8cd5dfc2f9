"""Bicycle model, midpoint integrator and column-form steps of the PyTorch
port against altro_tpu, all three frames, f64 to rtol 1e-12.

Counterparts: altro_tpu/models/bicycle.py, altro_tpu/models/integrators.py,
altro_tpu/models/tile_steps.py, altro_tpu/problem.py (dyn_expansion via
jax.jacfwd, lqr_cost_from_reference).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models import bicycle as jb  # noqa: E402
from altro_tpu.models import integrators as ji  # noqa: E402
from altro_tpu.models import tile_steps as jts  # noqa: E402
from altro_tpu import problem as jp  # noqa: E402
from altro_tpu_torch.models import bicycle as tb  # noqa: E402
from altro_tpu_torch.models import integrators as tint  # noqa: E402
from altro_tpu_torch.models import tile_steps as tts  # noqa: E402
from altro_tpu_torch import problem as tp  # noqa: E402

FRAMES = ["cog", "rear", "front"]
L = 37  # lanes


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((L, 4))
    u = rng.standard_normal((L, 2))
    h = 0.1
    return x, u, h


@pytest.mark.parametrize("frame", FRAMES)
def test_midpoint_bicycle_matches_jax(frame):
    x, u, h = _inputs()
    jstep = ji.midpoint(jb.bicycle_continuous(jb.BicycleFrame(frame)))
    tstep = tint.midpoint(tb.bicycle_continuous(tb.BicycleFrame(frame)))
    ref = np.asarray(jax.vmap(lambda a, b: jstep(a, b, h, 0))(jnp.asarray(x), jnp.asarray(u)))
    got = tstep(torch.as_tensor(x.T), torch.as_tensor(u.T), h, 0).numpy().T
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    # one lane, unbatched
    one = tstep(torch.as_tensor(x[3]), torch.as_tensor(u[3]), h, 0).numpy()
    np.testing.assert_allclose(one, ref[3], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("frame", FRAMES)
def test_column_step_matches_jax(frame):
    x, u, h = _inputs(1)
    jstep = jts.midpoint_cols(jts.bicycle_cols(frame))
    tstep = tts.midpoint_cols(tts.bicycle_cols(frame))
    ref = np.stack([np.asarray(c) for c in jstep(tuple(jnp.asarray(x.T)),
                                                 tuple(jnp.asarray(u.T)), h)])
    got = np.stack([c.numpy() for c in tstep(tuple(torch.as_tensor(x.T)),
                                             tuple(torch.as_tensor(u.T)), h)])
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    # the column step equals the per-lane dynamics (triangle identity vs atan2)
    dyn = tint.midpoint(tb.bicycle_continuous(tb.BicycleFrame(frame)))
    np.testing.assert_allclose(
        got, dyn(torch.as_tensor(x.T), torch.as_tensor(u.T), h, 0).numpy(),
        rtol=1e-12, atol=1e-14)
    ds = tstep.device_step
    assert (ds.model, ds.integrator, ds.n, ds.m) == (tts.MODEL_BICYCLE, tts.INTEGRATOR_MIDPOINT, 4, 2)
    assert ds.params == (tts.BICYCLE_FRAMES[frame], 2.7, 1.5)


@pytest.mark.parametrize("frame", FRAMES)
def test_dyn_expansion_matches_jacfwd(frame):
    x, u, h = _inputs(2)
    N = 1
    jdyn = ji.midpoint(jb.bicycle_continuous(jb.BicycleFrame(frame)))
    jprob = jp.Problem(N=N, n=4, m=2, dynamics=jdyn, dynamics_jac=None, constraints=(),
                       cost=None, h=jnp.full(N, h), x0=jnp.zeros(4))
    A_ref, B_ref = jax.vmap(lambda a, b: jprob.dyn_expansion(0, a, b))(
        jnp.asarray(x), jnp.asarray(u))
    tdyn = tint.midpoint(tb.bicycle_continuous(tb.BicycleFrame(frame)))
    tprob = tp.Problem(N=N, n=4, m=2, dynamics=tdyn, dynamics_jac=None, constraints=(),
                       cost=None, h=torch.full((N,), h, dtype=torch.float64),
                       x0=torch.zeros(4, dtype=torch.float64))
    A, Bm = tprob.dyn_expansion(0, torch.as_tensor(x.T), torch.as_tensor(u.T))
    np.testing.assert_allclose(np.moveaxis(A.numpy(), -1, 0), np.asarray(A_ref),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.moveaxis(Bm.numpy(), -1, 0), np.asarray(B_ref),
                               rtol=1e-12, atol=1e-14)
    assert A.dtype == torch.float64
    # float32 stays float32 through jacfwd
    A32, _ = tprob.dyn_expansion(0, torch.as_tensor(x.T, dtype=torch.float32),
                                 torch.as_tensor(u.T, dtype=torch.float32))
    assert A32.dtype == torch.float32


def test_lqr_cost_and_diagonal_cost_match_jax():
    rng = np.random.default_rng(5)
    N, n, m, Bsz = 6, 4, 2, 5
    Q, R = np.abs(rng.standard_normal((N + 1, n))), np.abs(rng.standard_normal((N + 1, m)))
    xr, ur = rng.standard_normal((N + 1, n)), rng.standard_normal((N + 1, m))
    jc = jp.lqr_cost_from_reference(*(jnp.asarray(a) for a in (Q, R, xr, ur)))
    tc = tp.lqr_cost_from_reference(*(torch.as_tensor(a) for a in (Q, R, xr, ur)))
    for name in ("Q", "R", "q", "r", "c"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   rtol=1e-12)
    x = rng.standard_normal((Bsz, N + 1, n))
    u = rng.standard_normal((Bsz, N, m))
    ks = torch.arange(N)
    tx = torch.as_tensor(np.moveaxis(x, 0, -1))  # [N+1, n, B]
    tu = torch.as_tensor(np.moveaxis(u, 0, -1))
    got = tc.stage_value(ks, tx[:N], tu).numpy()  # [N, B]
    ref = np.asarray(jax.vmap(jax.vmap(lambda k, a, b: jc.stage_value(k, a, b),
                                       in_axes=(0, 0, 0)), in_axes=(None, 0, 0))(
        jnp.arange(N), jnp.asarray(x[:, :N]), jnp.asarray(u)))
    np.testing.assert_allclose(got, ref.T, rtol=1e-12)
    gterm = tc.term_value(tx[N:]).numpy()[0]
    rterm = np.asarray(jax.vmap(jc.term_value)(jnp.asarray(x[:, N])))
    np.testing.assert_allclose(gterm, rterm, rtol=1e-12)
