"""Single-lane trial-grid rollout of the PyTorch port against altro_tpu.

The plain version (ops/trial_rollout.py::trial_rollout_ref) against the
JAX portable scan `ops/pallas_rollout._scan_rollout` in f64 (rtol 1e-10)
and against the packed Pallas kernel `_pallas_rollout(interpret=True)` in
f32 (phi to 2e-5 of its scale, states to 1e-5 of theirs: the tolerances
tests/test_pallas_rollout.py holds the kernel to), without constraint rows
(P = 0) and with the steering bound's rows (P = 2) active on part of the
knots. Also: the block step equals the per-lane dynamics, and the rows
the single-lane solve builds give the plain AL merit.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.tile_steps import bicycle_tile as jbicycle_tile  # noqa: E402
from altro_tpu.models.tile_steps import midpoint_tile as jmidpoint_tile  # noqa: E402
from altro_tpu.ops.pallas_rollout import _pallas_rollout, _scan_rollout  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.models.bicycle import bicycle_continuous  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.tile_steps import (  # noqa: E402
    bicycle_cols,
    bicycle_tile,
    block_step_from_cols,
    midpoint_cols,
    midpoint_tile,
)
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402
from altro_tpu_torch.ops.rollout_grid import affine_constraint_stacks  # noqa: E402

N, n, m, W = 36, 4, 2, 8
REF = load_scotty()


def _inputs(P, seed=0):
    """Rollout operands around the Scotty path with the steering angle
    near the 60 deg bound, and (P = 2) the solver's premultiplied rows."""
    rng = np.random.default_rng(seed)
    prob = mpc.scotty_problem(REF, N=N, dtype=torch.float64, device="cpu")
    c = prob.cost
    xref = REF.x[: N + 1] + 0.1 * rng.standard_normal((N + 1, n))
    xref[:, 3] = 1.0 + 0.05 * rng.standard_normal(N + 1)
    uref = REF.u[:N] + 0.02 * rng.standard_normal((N, m))
    uref[:, 1] *= 0.1
    K = 0.05 * rng.standard_normal((N, m, n))
    d = 0.1 * rng.standard_normal((N, m))
    x0 = xref[0] + 0.01 * rng.standard_normal(n)
    alphas = 0.5 ** np.arange(W)
    ops = dict(alphas=alphas, x0=x0, xref=xref, uref=uref, K=K, d=d,
               Qd=c.Q.numpy(), ql=c.q.numpy(), Rd=c.R.numpy(), rl=c.r.numpy(),
               cconst=c.c.numpy(), h=prob.h.numpy())
    con = None
    if P:
        ax, au, g, act = (t.numpy() for t in affine_constraint_stacks(prob))
        act[: N // 3] = 0.0  # the bound inactive on the first third of the knots
        z = np.abs(rng.standard_normal((N + 1, P)))
        rho = 3.0
        con = (rho * ax * act[..., None], rho * au * act[..., None], (z - rho * g) * act,
               1.0 / (2.0 * rho))
    return ops, con


def _jax_args(ops, con, dtype):
    args = tuple(jnp.asarray(v, dtype) for v in ops.values())
    cb = None if con is None else tuple(jnp.asarray(v, dtype) for v in con)
    return args, cb


def _torch_args(ops, con, dtype):
    args = tuple(torch.as_tensor(np.asarray(v), dtype=dtype) for v in ops.values())
    cb = None if con is None else tuple(torch.as_tensor(np.asarray(v), dtype=dtype)
                                        for v in con)
    return args, cb


@pytest.mark.parametrize("P", [0, 2])
def test_plain_matches_jax_scan_f64(P):
    ops, con = _inputs(P)
    jargs, jcon = _jax_args(ops, con, jnp.float64)
    phi_j, xs_j = _scan_rollout(jmidpoint_tile(jbicycle_tile()), *jargs, con=jcon)
    targs, tcon = _torch_args(ops, con, torch.float64)
    before = tr.LAUNCHES
    phi, xs = tr.trial_rollout(midpoint_tile(bicycle_tile()), *targs, con=tcon)
    assert tr.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert phi.shape == (W,) and xs.shape == (W, N + 1, n)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_j), rtol=1e-10)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=1e-10, atol=1e-12)
    if P:
        # the bound bites: some active row has w = wg - wa.x < 0
        wa, _, wg, _ = tcon
        w = wg[None, :N] - torch.einsum("kpi,wki->wkp", wa[:N], xs[:, :N])
        assert float((w < 0).double().mean()) > 0.05


@pytest.mark.parametrize("P", [0, 2])
def test_plain_matches_pallas_kernel_interpret_f32(P):
    ops, con = _inputs(P, seed=1)
    jargs, jcon = _jax_args(ops, con, jnp.float32)
    phi_k, xs_k = _pallas_rollout(jmidpoint_tile(jbicycle_tile()), *jargs, con=jcon,
                                  interpret=True)
    targs, tcon = _torch_args(ops, con, torch.float32)
    phi, xs = tr.trial_rollout(midpoint_tile(bicycle_tile()), *targs, con=tcon)
    scale = max(float(np.abs(np.asarray(phi_k)).max()), 1.0)
    assert float(np.abs(phi.numpy() - np.asarray(phi_k)).max()) < 2e-5 * scale
    # states to 1e-5 of their scale: positions reach ~50 here (one f32 ulp
    # is 3.8e-6 there) and roundoff accumulates over the 36-step chain
    xscale = max(float(np.abs(np.asarray(xs_k)).max()), 1.0)
    assert float(np.abs(xs.numpy() - np.asarray(xs_k)).max()) < 1e-5 * xscale


def test_block_step_matches_lane_dynamics():
    """midpoint_tile(bicycle_tile()) on [W, n] rows equals the per-lane
    midpoint(bicycle_continuous()) and the JAX block step, in f64."""
    rng = np.random.default_rng(4)
    x = 0.3 * rng.standard_normal((W, n))
    x[:, 3] = 0.9 * np.sign(x[:, 3])
    u = 1.0 + 0.3 * rng.standard_normal((W, m))
    h = 0.1
    step = midpoint_tile(bicycle_tile())
    got = step(torch.as_tensor(x), torch.as_tensor(u), torch.full((W, 1), h, dtype=torch.float64))
    lane = midpoint(bicycle_continuous())(torch.as_tensor(x.T), torch.as_tensor(u.T), h, 0).T
    jgot = jmidpoint_tile(jbicycle_tile())(jnp.asarray(x), jnp.asarray(u), jnp.full((W, 1), h))
    np.testing.assert_allclose(got.numpy(), lane.numpy(), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-13, atol=1e-14)
    ds = step.device_step
    assert (ds.model, ds.integrator, ds.n, ds.m) == (0, 0, n, m)
    # the discrete column step lifted to blocks is the same step
    lifted = block_step_from_cols(midpoint_cols(bicycle_cols()))
    hcol = torch.full((W, 1), h, dtype=torch.float64)
    np.testing.assert_allclose(lifted(torch.as_tensor(x), torch.as_tensor(u), hcol).numpy(),
                               got.numpy(), rtol=1e-14, atol=1e-15)
    assert lifted.device_step == ds
    assert tr.ineligibility(step, n, m) is None
    assert "no device step" in tr.ineligibility(midpoint_tile(lambda x, u: x), n, m)


def test_solver_rows_reproduce_plain_al_merit():
    """With the rows `solver.solve` builds from z and rho, the trial
    rollout's merit equals the plain grid through the problem's own
    dynamics and AL cost (`solver.merit_rollout_phi_x`), in f64."""
    from altro_tpu_torch import solver

    ops, _ = _inputs(0, seed=2)
    prob = mpc.scotty_problem(REF, N=N, dtype=torch.float64, device="cpu")
    prob = dataclasses.replace(prob, x0=torch.as_tensor(ops["x0"]))
    rng = np.random.default_rng(5)
    z = (torch.as_tensor(np.abs(rng.standard_normal((N + 1, 2)))),)
    rho = torch.tensor(4.0, dtype=torch.float64)
    ax, au, g, act = affine_constraint_stacks(prob)
    cz = torch.cat(z, dim=1)
    con = (rho * (ax * act[..., None]), rho * (au * act[..., None]), (cz - rho * g) * act,
           1.0 / (2.0 * rho))
    targs, _ = _torch_args(ops, None, torch.float64)
    phi, xs = tr.trial_rollout(prob.dynamics_tile, *targs, con=con)
    t = lambda k: torch.as_tensor(ops[k])  # noqa: E731
    phi_p, xs_p = solver.merit_rollout_phi_x(prob, t("xref"), t("uref"), t("K"), t("d"), z,
                                             rho, t("alphas"), prob.x0)
    np.testing.assert_allclose(phi.numpy(), phi_p.numpy(), rtol=1e-10)
    np.testing.assert_allclose(xs.numpy(), xs_p.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("W, N_", [(1, 1), (8, 500), (32, 64)])
def test_kernel_outputs_are_views_of_one_aligned_buffer(W, N_):
    """phis [W] and xstack [W, N+1, n] share one float32 allocation, do not
    overlap, and xstack starts 16-byte aligned (the merit warp stores a
    state 16 bytes at a time)."""
    phi, xs = tr.output_views(W, N_, n, "cpu")
    assert phi.shape == (W,) and xs.shape == (W, N_ + 1, n)
    assert phi.dtype == xs.dtype == torch.float32 and xs.is_contiguous()
    assert phi.untyped_storage().data_ptr() == xs.untyped_storage().data_ptr()
    assert (xs.data_ptr() - xs.untyped_storage().data_ptr()) % 16 == 0
    assert phi.data_ptr() >= xs.data_ptr() + xs.numel() * 4
    xs.fill_(1.0)
    phi.zero_()
    assert float(xs.sum()) == xs.numel()


@pytest.mark.parametrize("frame", ["cog", "rear", "front"])
@pytest.mark.parametrize("W, P, why", [(1, 0, None), (32, 2, None), (33, 0, "W=33 > 32"),
                                       (8, 1, "P=1 constraint rows"),
                                       (8, 3, "P=3 constraint rows")])
def test_kernel_instantiations_cover_the_eligible_grids(frame, W, P, why):
    """`ineligibility` admits exactly what csrc/trial_rollout.cu has an
    instantiation for: every bicycle frame, W <= 32, P in (0, 2, 4) (P=4
    since the two-group fixture of tests/test_pallas_rollout.py:259 was
    ported); the wrapper raises its reason on the card."""
    step = midpoint_tile(bicycle_tile(frame))
    got = tr.ineligibility(step, n, m, W, P)
    assert got is None if why is None else why in got
    assert tr.KERNEL_P == (0, 2, 4) and tr.KERNEL_MAX_W == 32
