"""The bicycle's single-lane trial rollout at P=4: two constraint groups.

tests/test_pallas_rollout.py:259's fixture (the bicycle on the path's
first 60 knots with random gains; the steering bound |delta| <= 0.01 and
the input bound |u_0| <= 0.05, the latter active on the first half of
the horizon only, so its rows are all zero from knot 30 on; nonzero
duals, rho = 2.5) through the port's plain trial rollout
(`trial_rollout_ref`, what `trial_rollout` runs on CPU tensors) in f64:
phi and states within 1e-10 of JAX's `make_trial_grid_rollout(...,
n_con=4)` (its scan) and of the vmapped `merit_rollout_phi_x`, the merit
through the problem's own dynamics and AL cost. In f32, against the
Pallas kernel in interpret mode, to the JAX test's tolerances. The rows
are the ones the single-lane solve forms (`affine_constraint_stacks`,
active-masked and rho-premultiplied), equal to JAX's.
`ineligibility` admits P=4. csrc/trial_rollout.cu's P=4 instantiation is
held against this plain version on the card (tests/test_torch_kernels_
cuda.py).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.io.scotty import synthetic_scotty  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.tile_steps import bicycle_tile as jbicycle_tile  # noqa: E402
from altro_tpu.models.tile_steps import midpoint_tile as jmidpoint_tile  # noqa: E402
from altro_tpu.ops.pallas_rollout import affine_constraint_stacks as jstacks  # noqa: E402
from altro_tpu.ops.pallas_rollout import make_trial_grid_rollout  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import merit_rollout_phi_x  # noqa: E402
from altro_tpu_torch.cones import Cone  # noqa: E402
from altro_tpu_torch.models.bicycle import bicycle_continuous  # noqa: E402
from altro_tpu_torch.models.integrators import midpoint  # noqa: E402
from altro_tpu_torch.models.tile_steps import bicycle_tile, midpoint_tile  # noqa: E402
from altro_tpu_torch.ops import rollout_grid as rg  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402
from altro_tpu_torch.problem import ConstraintSpec, Problem, lqr_cost_from_reference  # noqa: E402

N, n, m, P = 60, 4, 2, 4
ALPHAS = np.asarray([1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625, 0.0078125])
DMAX, AMAX, RHO = 0.01, 0.05, 2.5


def _fixture():
    """test_pallas_rollout.py's `_bicycle_fixture` with its two groups, as
    numpy: (x0, xref, uref, K, d, Q, q, R, r, c, h), z per group."""
    ref = synthetic_scotty(N=500)
    Qd, Rd = np.full((N + 1, 4), 1e-2), np.full((N + 1, 2), 1e-3)
    xr, ur_full = np.asarray(ref.x[: N + 1]), np.asarray(ref.u[: N + 1])
    h = np.full(N, float(np.float32(ref.tf / ref.N)))
    rng = np.random.default_rng(1)
    uref = np.asarray(ref.u[:N]) + 0.01 * rng.standard_normal((N, 2))
    K = 0.1 * rng.standard_normal((N, 2, 4))
    d = 0.05 * rng.standard_normal((N, 2))
    q, r = -Qd * xr, -Rd * ur_full
    c = 0.5 * np.sum(Qd * xr * xr, 1) + 0.5 * np.sum(Rd * ur_full * ur_full, 1) * (
        np.arange(N + 1) != N)
    rng = np.random.default_rng(4)
    z = tuple(0.1 * rng.standard_normal((N + 1, 2)) for _ in range(2))
    return (xr[0], xr, uref, K, d, Qd, q, Rd, r, c, h), z


def _jax_problem(ops, dtype):
    x0, xr, uref, K, d, Qd, q, Rd, r, c, h = ops
    active = jnp.arange(N + 1) < (N // 2)
    specs = (JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DMAX, -DMAX - x[3]]),
                   cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                   diag_hessian=True, affine=True),
             JSpec(fn=lambda x, u, k: jnp.stack([u[0] - AMAX, -AMAX - u[0]]),
                   cone=JCone.NEGATIVE_ORTHANT, dim=2, active=active, diag_hessian=True,
                   affine=True))
    ref = synthetic_scotty(N=500)
    cost = jlqr(jnp.full((N + 1, 4), 1e-2, dtype), jnp.full((N + 1, 2), 1e-3, dtype),
                jnp.asarray(ref.x[: N + 1], dtype), jnp.asarray(ref.u[: N + 1], dtype))
    return JProblem(N=N, n=4, m=2, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
                    constraints=specs, cost=cost, h=jnp.asarray(h, dtype),
                    x0=jnp.asarray(x0, dtype))


def _port_problem(ops, dtype):
    x0, xr, uref, K, d, Qd, q, Rd, r, c, h = ops
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    active = torch.arange(N + 1) < (N // 2)
    specs = (ConstraintSpec(fn=lambda x, u, k: torch.stack([x[3] - DMAX, -DMAX - x[3]]),
                            cone=Cone.NEGATIVE_ORTHANT, dim=2,
                            active=torch.ones(N + 1, dtype=torch.bool), diag_hessian=True,
                            affine=True),
             ConstraintSpec(fn=lambda x, u, k: torch.stack([u[0] - AMAX, -AMAX - u[0]]),
                            cone=Cone.NEGATIVE_ORTHANT, dim=2, active=active,
                            diag_hessian=True, affine=True))
    ref = synthetic_scotty(N=500)
    cost = lqr_cost_from_reference(t(np.full((N + 1, 4), 1e-2)), t(np.full((N + 1, 2), 1e-3)),
                                   t(ref.x[: N + 1]), t(ref.u[: N + 1]))
    return Problem(N=N, n=4, m=2, dynamics=midpoint(bicycle_continuous()), dynamics_jac=None,
                   constraints=specs, cost=cost, h=t(h), x0=t(x0),
                   dynamics_tile=midpoint_tile(bicycle_tile()))


def _con(ax, au, g, act, z):
    """The solve's rows: (rho ax act, rho au act, (z - rho g) act, 1/(2 rho))."""
    return (RHO * ax * act[..., None], RHO * au * act[..., None],
            (np.concatenate(z, 1) - RHO * g) * act, 1.0 / (2.0 * RHO))


def _port(ops, con, dtype):
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    args = [t(ALPHAS)] + [t(a) for a in ops]
    tcon = (t(con[0]), t(con[1]), t(con[2]), t([con[3]]))
    before = tr.LAUNCHES
    phi, xs = tr.trial_rollout(midpoint_tile(bicycle_tile()), *args, con=tcon)
    assert tr.LAUNCHES == before  # CPU tensors: the plain twin
    return phi.double().numpy(), xs.double().numpy()


def _jax_grid(ops, con, dtype):
    grid = make_trial_grid_rollout(jmidpoint_tile(jbicycle_tile()), interpret=True, n_con=P)
    args = [jnp.asarray(ALPHAS, dtype)] + [jnp.asarray(a, dtype) for a in ops]
    args += [jnp.asarray(a, dtype) for a in con]
    phi, xs = grid(*args)
    return np.asarray(phi, np.float64), np.asarray(xs, np.float64)


def test_rows_match_jax_and_the_group_goes_off():
    ops, _ = _fixture()
    got = rg.affine_constraint_stacks(_port_problem(ops, torch.float64))
    want = jstacks(_jax_problem(ops, jnp.float64))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    act = got[3].numpy()
    assert got[0].shape == (N + 1, P, n) and act[:N // 2].all() and not act[N // 2:, 2:].any()


def test_plain_twin_matches_jax_f64():
    ops, z = _fixture()
    stacks = [a.numpy() for a in rg.affine_constraint_stacks(_port_problem(ops, torch.float64))]
    con = _con(*stacks, z)
    phi, xs = _port(ops, con, torch.float64)
    phi_g, xs_g = _jax_grid(ops, con, jnp.float64)
    np.testing.assert_allclose(phi, phi_g, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(xs, xs_g, rtol=0, atol=1e-10)
    jp = _jax_problem(ops, jnp.float64)
    x0, xr, uref, K, d = (jnp.asarray(a) for a in ops[:5])
    jz = tuple(jnp.asarray(zj) for zj in z)
    phi_m, xs_m = jax.vmap(lambda a: merit_rollout_phi_x(jp, xr, uref, K, d, jz,
                                                         jnp.asarray(RHO), a, x0))(
        jnp.asarray(ALPHAS))
    np.testing.assert_allclose(phi, np.asarray(phi_m), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(xs, np.asarray(xs_m), rtol=0, atol=1e-10)
    # both groups bite along the trials (else this pins nothing)
    phi_free, _ = _port(ops, (0 * con[0], 0 * con[1], np.full_like(con[2], 1.0), con[3]),
                        torch.float64)
    assert float(np.min(phi - phi_free)) > 1e-3


def test_plain_twin_matches_pallas_kernel_interpret_f32():
    ops, z = _fixture()
    stacks = [a.numpy() for a in rg.affine_constraint_stacks(_port_problem(ops, torch.float64))]
    con = _con(*stacks, z)
    phi_k, xs_k = _jax_grid(ops, con, jnp.float32)  # f32 + interpret: the Pallas kernel
    phi, xs = _port(ops, con, torch.float32)
    scale = max(float(np.abs(phi_k).max()), 1.0)
    assert float(np.abs(phi - phi_k).max()) < 2e-5 * scale
    assert float(np.abs(xs - xs_k).max()) < 1e-5


@pytest.mark.parametrize("frame", ["cog", "rear", "front"])
def test_p4_is_instantiated(frame):
    assert tr.ineligibility(midpoint_tile(bicycle_tile(frame)), n, m, 8, P) is None
    prob = _port_problem(_fixture()[0], torch.float64)
    assert tr.problem_ineligibility(prob) is None
    assert rg.ineligibility(dataclasses.replace(prob, dynamics_cols=None)) is not None
