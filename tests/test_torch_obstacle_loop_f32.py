"""Where the obstacle loop's float32 Armijo tests part (tests/
test_obstacle_mpc.py's loop, tick 0, the disc, tolerance 1e-3).

On JAX's own f32 iterates of the tick (recorded through ordered debug
callbacks around its expansions and backward pass), each package's two
sides of the Armijo test: phi0, the total AL cost at the reference
trajectory, and merit(0), the trial rollout's merit at alpha = 0 (the
same trajectory).

What the measurements pin:
* the port's phi0 is, bit for bit, the knot-order sum of JAX's knot costs
  evaluated op by op (and `jnp.sum` of them is that sum): the port
  computes JAX's expression in JAX's order, so the order of phi0's sum is
  not where the packages part;
* on its own iterates the port's merit(0) equals its phi0 exactly;
* inside JAX's jitted solve both sides round otherwise: its phi0 differs
  from the op-by-op sum on some iterates, and its merit(0), summed in its
  scan over the same re-rolled states, differs from its phi0. XLA's
  fusion of the while body and of the scan body rounds each knot cost
  (terms near 14 that cancel to 1e-4) in its own way. Near convergence
  that gap (a few 1e-6) exceeds the merit's decrease, and the two
  packages' Armijo tests part there.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu import al as jal  # noqa: E402
from altro_tpu import solver as jsolver  # noqa: E402
from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JConstraintSpec  # noqa: E402
from altro_tpu.problem import DiagonalCost as JDiagonalCost  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu_torch import mpc, solver  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.ops import tile_iter as ti  # noqa: E402
from altro_tpu_torch.problem import DiagonalCost  # noqa: E402

test_obstacle_mpc = pytest.importorskip("test_obstacle_mpc")

F32 = jnp.float32
N = test_obstacle_mpc.N


def _port_problem():
    return mpc.obstacle_problem(load_scotty(), N, t_obs=test_obstacle_mpc.T_OBS,
                                r_obs=test_obstacle_mpc.R_OBS, declared=True,
                                dtype=torch.float32, device="cpu")


def _jax_problem(port):
    """tests/test_obstacle_mpc.py's problem in float32 on the port's cost
    rows (one set of numbers for both packages)."""
    ref = test_obstacle_mpc._ref()
    dm = float(np.deg2rad(60.0))
    cx, cy = (float(v) for v in ref.x[test_obstacle_mpc.T_OBS + N // 2][:2])
    r2 = float(test_obstacle_mpc.R_OBS) ** 2
    on = jnp.ones(N + 1, bool)
    cons = (
        JConstraintSpec(fn=lambda x, u, k: jnp.stack([x[3] - dm, -dm - x[3]]),
                        cone=JCone.NEGATIVE_ORTHANT, dim=2, active=on, label="steering",
                        diag_hessian=True, affine=True),
        JConstraintSpec(fn=lambda x, u, k: jnp.stack([u[0] - 8.0, -u[0], u[1] - 1.5,
                                                      -1.5 - u[1]]),
                        cone=JCone.NEGATIVE_ORTHANT, dim=4, active=on.at[N].set(False),
                        label="input bounds", diag_hessian=True, affine=True),
        JConstraintSpec(fn=lambda x, u, k: jnp.stack([r2 - (x[0] - cx) ** 2 - (x[1] - cy) ** 2]),
                        cone=JCone.NEGATIVE_ORTHANT, dim=1, active=on, label="obstacle"))
    c = port.cost
    cost = JDiagonalCost(*(jnp.asarray(a.numpy()) for a in (c.Q, c.R, c.q, c.r, c.c)))
    problem = JProblem(N=N, n=4, m=2, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
                       constraints=cons, cost=cost, h=jnp.asarray(port.h.numpy()),
                       x0=jnp.asarray(port.x0.numpy()))
    state = dataclasses.replace(
        jsolver.init_state(problem),
        u=jnp.tile(jnp.asarray([ref.u[0][0], 0.0], F32), (N, 1)),
        x=jnp.asarray(ref.x[: N + 1], F32))
    return problem, state


@pytest.fixture(scope="module")
def jax_iterates():
    """JAX's f32 tick 0: its status, iterations and, per iteration, the
    expansions' inputs (x, u, z, rho), phi0, K and d."""
    port = _port_problem()
    problem, state = _jax_problem(port)
    rec = []

    def expansions(prob, x, u, z, rho, exact=False):
        out = orig_exp(prob, x, u, z, rho, exact=exact)
        jax.debug.callback(lambda *v: rec.append([np.asarray(a) for a in v]),
                           x, u, rho, out[-1], *z, ordered=True)
        return out

    def backward(*a, **k):
        g, reg = orig_bw(*a, **k)
        jax.debug.callback(lambda K, d: rec[-1].extend([np.asarray(K), np.asarray(d)]),
                           g.K, g.d, ordered=True)
        return g, reg

    orig_exp, orig_bw = jsolver._cost_expansions_and_cost, jsolver.backward_adaptive
    opts = JOpts(iterations_max=30, use_backtracking_linesearch=True, penalty_warm_start=True,
                 throw_errors=False, tol_stationarity=1e-3, tol_primal_feasibility=1e-3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsolver, "_cost_expansions_and_cost", expansions)
        mp.setattr(jsolver, "backward_adaptive", backward)
        _, stats = jax.jit(jsolver.solve, static_argnames=("opts",))(problem, state, opts)
        jax.effects_barrier()
    G = len(problem.constraints)
    iters = [dict(x=r[0], u=r[1], rho=r[2], phi0=r[3], z=tuple(r[4:4 + G]), K=r[4 + G],
                  d=r[5 + G]) for r in rec]
    return port, problem, int(stats.status), int(stats.iterations), iters


def _jax_sides(problem, it):
    """JAX's merit at alpha = 0 (its scan's sum), the states it re-rolls,
    and its knot costs evaluated op by op (vmapped, not jitted) with the
    terminal one."""
    Z = jnp.zeros((N + 1, problem.n, problem.n), F32)
    p = jnp.zeros((N + 1, problem.n), F32)
    m = jsolver.merit_function(problem, it["x"], it["u"], it["K"], it["d"], Z, p, it["z"],
                               it["rho"], 0.0, problem.x0, with_derivative=False)
    knots = jax.vmap(lambda k, xk, uk, zk: jal.al_cost(problem, k, xk, uk, zk, it["rho"],
                                                       terminal=False)[0])(
        jnp.arange(N), it["x"][:N], it["u"], tuple(zj[:N] for zj in it["z"]))
    term = jal.al_cost(problem, N, it["x"][N], None, tuple(zj[N] for zj in it["z"]),
                       it["rho"], terminal=True)[0]
    return np.float32(m.phi), np.asarray(m.x), np.asarray(knots), np.float32(term)


def test_tick0_armijo_sides(jax_iterates):
    port, problem, status, iterations, iters = jax_iterates
    assert (status, iterations) == (0, 6)  # JAX: SUCCESS after 6 iterations
    assert len(iters) == iterations
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731  (a writable copy)
    fused_phi0, fused_gap = [], []
    for it in iters:
        z = tuple(t(zj) for zj in it["z"])
        rho = t(it["rho"])
        phi0 = ti.cost_expansions_tiled(port, t(it["x"])[..., None], t(it["u"])[..., None],
                                        tuple(zj[..., None] for zj in z), rho.reshape(1),
                                        diag=False)[-1][0]
        jm0, jx, knots, term = _jax_sides(problem, it)
        np.testing.assert_array_equal(jx, it["x"])  # JAX's scan re-rolls the same states
        seq = np.float32(0.0)
        for v in knots:
            seq = np.float32(seq + v)
        seq = np.float32(seq + term)
        assert np.float32(jnp.sum(jnp.asarray(knots)) + term) == seq
        assert float(phi0) == float(seq)  # JAX's expression in JAX's order, bit for bit
        fused_phi0.append(float(it["phi0"]) - float(seq))
        fused_gap.append(float(jm0) - float(it["phi0"]))
    # inside the jitted solve JAX's two sides round otherwise
    assert max(abs(g) for g in fused_phi0) > 0.0
    assert max(abs(g) for g in fused_gap) > 1e-6


def test_port_sides_agree_on_its_iterates():
    """On the port's own f32 iterates of the tick, its merit(0) (the trial
    rollout re-rolling its states) equals its phi0 bit for bit."""
    port = _port_problem()
    ref = load_scotty()
    rec = []
    orig = solver._cost_expansions_and_cost

    def expansions(problem, x, u, z, rho, exact=False):
        out = orig(problem, x, u, z, rho, exact=exact)
        rec.append((x, u, z, rho, out[-1]))
        return out

    def backward(*a, **k):
        g, reg = orig_bw(*a, **k)
        rec[-1] += (g.K, g.d)
        return g, reg

    orig_bw = solver.backward_adaptive
    u0 = torch.tensor([ref.u[0][0], 0.0])
    state = dataclasses.replace(solver.init_state(port), u=u0.expand(N, 2).contiguous(),
                                x=torch.as_tensor(ref.x[: N + 1], dtype=torch.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver, "_cost_expansions_and_cost", expansions)
        mp.setattr(solver, "backward_adaptive", backward)
        solver.solve(port, state, mpc.obstacle_loop_options(1e-3))
    assert len(rec) >= 6
    for x, u, z, rho, phi0, K, d in rec:
        merit0 = solver.merit_rollout_phi_x(port, x, u, K, d, z, rho, torch.zeros(1),
                                            port.x0)[0][0]
        assert float(merit0) == float(phi0)


def test_knot_costs_match_jax_vmapped_f32():
    """The port's diagonal knot cost against JAX's vmapped `stage_value`
    in float32 on numpy inputs at the obstacle loop's scale (terms near
    14 that cancel to 1e-4): equal bit for bit."""
    rng = np.random.default_rng(0)
    K, n, m = 64, 4, 2
    xr = rng.uniform(-40.0, 40.0, (K, n)).astype(np.float32)
    x = (xr + 1e-2 * rng.standard_normal((K, n))).astype(np.float32)
    u = rng.standard_normal((K, m)).astype(np.float32)
    Q = np.full((K, n), 1e-2, np.float32)
    R = np.full((K, m), 1e-3, np.float32)
    q = (-Q * xr).astype(np.float32)
    r = rng.standard_normal((K, m)).astype(np.float32) * 1e-3
    c = (0.5 * np.sum(Q * xr * xr, axis=1)).astype(np.float32)
    jc = JDiagonalCost(Q=jnp.asarray(Q), R=jnp.asarray(R), q=jnp.asarray(q), r=jnp.asarray(r),
                       c=jnp.asarray(c))
    jv = np.asarray(jax.jit(jax.vmap(jc.stage_value))(jnp.arange(K), jnp.asarray(x),
                                                      jnp.asarray(u)))
    pc = DiagonalCost(*(torch.as_tensor(a) for a in (Q, R, q, r, c)))
    pv = pc.stage_value(torch.arange(K), torch.as_tensor(x)[..., None],
                        torch.as_tensor(u)[..., None])[:, 0].numpy()
    np.testing.assert_array_equal(pv, jv)
