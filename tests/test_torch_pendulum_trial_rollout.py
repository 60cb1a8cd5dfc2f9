"""The pendulum's block step and its single-lane trial rollout in the port,
against altro_tpu.

`models/tile_steps.pendulum_tile` (under `midpoint_tile`) equals JAX's on
[W, n] trial rows and the per-lane dynamics, and names the device step
the new kernel of csrc/trial_rollout.cu runs. The plain twin
`trial_rollout_ref` with that step equals JAX's
`make_trial_grid_rollout(midpoint_tile(pendulum_tile()), interpret=True,
n_con=P)` in f64 (phi and states to 1e-12) at P in (0, 2) (the torque
bound's two rows on u, as the facade's `set_input_bounds` makes them,
active on part of the knots, or two random rows in x and u active at
every knot, the terminal knot's included), W in (1, 8), N in (1, 30); and
the packed Pallas kernel in f32 (interpret mode) at N=30, W=8, to the tolerances
tests/test_pallas_rollout.py holds that kernel to. `ineligibility` admits
what the kernel is instantiated for.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.tile_steps import midpoint_tile as jmidpoint_tile  # noqa: E402
from altro_tpu.models.tile_steps import pendulum_tile as jpendulum_tile  # noqa: E402
from altro_tpu.ops.pallas_rollout import make_trial_grid_rollout  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.pendulum import pendulum_continuous  # noqa: E402
from altro_tpu_torch.models.tile_steps import midpoint_tile, pendulum_tile  # noqa: E402
from altro_tpu_torch.mpc import trial_operands  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402

n, m = 2, 1


def inputs(N, W, P, rows="bounds", seed=0):
    """`mpc.trial_operands("pendulum", ...)` in f64 as numpy arrays (rhoi a
    number): one swing-up search near the torque bound, and (P = 2) the
    bound rows the solve forms or random state rows active at every knot."""
    _, args, con = trial_operands("pendulum", N, W, P, rows=rows, seed=seed,
                                  dtype=torch.float64, device="cpu")
    ops = [a.numpy() for a in args]
    if con is None:
        return ops, None
    return ops, [c.numpy() for c in con[:3]] + [float(con[3])]


def _policy_rows(ops, con, xs):
    """w = wg - wa.x - wu.u of every trial at the stage knots and (state
    terms only) the terminal knot, from the trials' states."""
    N = ops[4].shape[0]
    wa, wu, wg, _ = con
    u = (ops[3][None] - np.einsum("kji,wki->wkj", ops[4], xs[:, :N] - ops[2][None, :N])
         + ops[0][:, None, None] * ops[5][None])
    w = wg[None, :N] - np.einsum("kpi,wki->wkp", wa[:N], xs[:, :N]) - np.einsum(
        "kpj,wkj->wkp", wu[:N], u)
    return w, wg[None, N] - np.einsum("pi,wi->wp", wa[N], xs[:, N])


def _jax(ops, con, dtype):
    grid = make_trial_grid_rollout(jmidpoint_tile(jpendulum_tile()), interpret=True,
                                   n_con=0 if con is None else con[2].shape[1])
    args = [jnp.asarray(a, dtype) for a in ops]
    if con is not None:
        args += [jnp.asarray(a, dtype) for a in con]
    phi, xs = grid(*args)
    return np.asarray(phi, np.float64), np.asarray(xs, np.float64)


def _port(ops, con, dtype):
    args = [torch.as_tensor(np.asarray(a), dtype=dtype) for a in ops]
    tcon = None if con is None else tuple(torch.as_tensor(np.asarray(a), dtype=dtype)
                                          for a in con)
    before = tr.LAUNCHES
    phi, xs = tr.trial_rollout(midpoint_tile(pendulum_tile()), *args, con=tcon)
    assert tr.LAUNCHES == before  # CPU tensors: the plain twin
    return phi.double().numpy(), xs.double().numpy()


ROWS = pytest.mark.parametrize("P, rows", [(0, "bounds"), (2, "bounds"), (2, "state")],
                               ids=["0", "2", "2-state"])


@pytest.mark.parametrize("N", [1, 30])
@pytest.mark.parametrize("W", [1, 8])
@ROWS
def test_plain_twin_matches_jax_grid_f64(P, rows, W, N):
    ops, con = inputs(N, W, P, rows)
    phi_j, xs_j = _jax(ops, con, jnp.float64)
    phi, xs = _port(ops, con, torch.float64)
    assert phi.shape == (W,) and xs.shape == (W, N + 1, n)
    np.testing.assert_allclose(phi, phi_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(xs, xs_j, rtol=1e-12, atol=1e-12)
    if not P:
        return
    w, w_N = _policy_rows(ops, con, xs)
    if rows == "bounds" and N > 1:  # the bound bites: an active row has w = wg - wu.u < 0
        assert (w < 0).mean() > 0.05
    if rows == "state":  # the rows' state terms and the terminal rows enter the merit
        assert (w_N < 0).any() and float(np.abs(con[0][N]).min()) > 0.0
        assert N == 1 or (w < 0).mean() > 0.2


@ROWS
def test_plain_twin_matches_pallas_kernel_interpret_f32(P, rows):
    N, W = 30, 8
    ops, con = inputs(N, W, P, rows, seed=1)
    phi_k, xs_k = _jax(ops, con, jnp.float32)  # f32 + interpret: the Pallas kernel
    phi, xs = _port(ops, con, torch.float32)
    scale = max(float(np.abs(phi_k).max()), 1.0)
    assert float(np.abs(phi - phi_k).max()) < 2e-5 * scale
    xscale = max(float(np.abs(xs_k).max()), 1.0)
    assert float(np.abs(xs - xs_k).max()) < 1e-5 * xscale


def test_pendulum_tile_matches_jax_and_lane_dynamics():
    rng = np.random.default_rng(4)
    W = 8
    x = rng.standard_normal((W, n))
    u = 3.0 * rng.standard_normal((W, m))
    h = 0.06
    step = midpoint_tile(pendulum_tile())
    got = step(torch.as_tensor(x), torch.as_tensor(u), torch.full((W, 1), h, dtype=torch.float64))
    jgot = jmidpoint_tile(jpendulum_tile())(jnp.asarray(x), jnp.asarray(u), jnp.full((W, 1), h))
    lane = midpoint(pendulum_continuous())(torch.as_tensor(x.T), torch.as_tensor(u.T), h, 0).T
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), lane.numpy(), rtol=1e-13, atol=1e-14)
    ds = step.device_step
    assert (ds.model, ds.integrator, ds.n, ds.m) == (2, 0, n, m)
    assert ds.params == (1.0, 0.5, 0.1, 9.81)


@pytest.mark.parametrize("W, P, why", [(1, 0, None), (8, 2, None), (32, 2, None),
                                       (33, 2, "W=33 > 32"), (8, 1, "P=1 constraint rows"),
                                       (8, 4, "P=4 constraint rows")])
def test_kernel_instantiations_cover_the_pendulum_grids(W, P, why):
    got = tr.ineligibility(midpoint_tile(pendulum_tile()), n, m, W, P)
    assert got is None if why is None else why in got
    assert "n=4, m=2" in tr.ineligibility(midpoint_tile(pendulum_tile()), 4, 2, 8, 0)
