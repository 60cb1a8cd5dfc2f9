"""The port's vmapped solve on the bicycle with its steering bound, and
the lane loop it shares with `solve_tiled`.

* Against `jax.vmap(solve)` with the quadrotor row's line search on the
  Scotty problem (the bench's options with `pallas_backward=True`, the
  strong-Wolfe test on trial 0, Armijo slack 1e-6): dense expansions
  with the AL Hessian of the bound, B=8, N=12, two closed-loop ticks from
  starts whose steering sits near or past the 60 deg bound (offsets as in
  tests/test_torch_solve.py). Status, iterations and ls_iterations exact;
  x, u and stats.dphi to 1e-8.
* With `ls_armijo_only=True` the vmapped solve equals `solve_tiled` lane
  for lane (the same loop), and its dphi follows jax.vmap(solve): NaN on
  lanes that took a step, dphi(0) on the others.
* The options that were refused until the batched solves ran the
  reference's line searches (parallel_linesearch=False: the sequential
  backtracking; ls_phase_split=False: the non-split grid) now hold
  against `jax.vmap(solve)` with the same checks.
* The options it does not port are refused by name.
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
from altro_tpu.mpc import shift_trajectory  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.parallel.batch import batch_init_state as jbatch_init  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import solve  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.options import Verbosity  # noqa: E402
from altro_tpu_torch.parallel.batch import batch_init_state, vmap_solve  # noqa: E402

N, B, T, n, m = 12, 8, 2, 4, 2
DM = 60 * np.pi / 180.0
REF = jload()
H = float(np.float32(REF.tf / REF.N))
OPTS = mpc.bench_options(iterations_max=10)[0].replace(
    ls_armijo_only=False, pallas_backward=True, ls_armijo_slack=1e-6)
DYN = jmidpoint(jbicycle())


def _x_true0():
    rng = np.random.default_rng(0)
    x = REF.x[0][None] + 0.3 * rng.standard_normal((B, n))
    x[:, 3] += np.where(np.arange(B) % 2, 0.9, 1.2) * np.sign(rng.standard_normal(B))
    return x


def _windows():
    xw = np.stack([REF.x[t: t + N + 1] for t in range(T + 1)])
    Qd, Rd = np.full(n, 1e-2), np.full(m, 1e-3)
    qs, cs = -(Qd * xw), 0.5 * np.sum(Qd * xw * xw, axis=2)
    cs[:, :N] += 0.5 * float(REF.u[0] @ (Rd * REF.u[0]))
    return qs, cs


def _jax_run(opts=OPTS, ticks=T):
    j_opts = JOpts(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})
    jprob = JProblem(
        N=N, n=n, m=m, dynamics=DYN, dynamics_jac=None,
        constraints=(JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                           cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                           diag_hessian=True, affine=True),),
        cost=jlqr(jnp.asarray(np.full((N + 1, n), 1e-2)), jnp.asarray(np.full((N + 1, m), 1e-3)),
                  jnp.asarray(REF.x[: N + 1]), jnp.asarray(REF.u[: N + 1])),
        h=jnp.full(N, H), x0=jnp.asarray(REF.x[0]))

    @jax.jit
    def tick(x_true, st, q, c):
        prob = dataclasses.replace(jprob, cost=dataclasses.replace(jprob.cost, q=q, c=c))
        st, stats = jax.vmap(
            lambda x0, s: solve(dataclasses.replace(prob, x0=x0), s, j_opts))(x_true, st)
        x_true = jax.vmap(lambda x, u: DYN(x, u, jnp.asarray(H), 0))(x_true, st.u[:, 0])
        return x_true, jax.vmap(shift_trajectory)(st), stats

    st = dataclasses.replace(
        jbatch_init(jprob, B), u=jnp.tile(jnp.asarray([REF.u[0][0], 0.0]), (B, N, 1)),
        x=jnp.tile(jnp.asarray(REF.x[: N + 1]), (B, 1, 1)))
    xt = jnp.asarray(_x_true0())
    qs, cs = _windows()
    out = []
    for t in range(ticks):
        xt, st, stats = tick(xt, st, jnp.asarray(qs[t]), jnp.asarray(cs[t]))
        out.append((np.asarray(xt), jax.tree.map(np.asarray, st),
                    jax.tree.map(np.asarray, stats)))
    return out


def _port_start():
    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=N, dtype=torch.float64, device="cpu")
    st = dataclasses.replace(
        batch_init_state(prob, B),
        u=torch.tensor([ref.u[0][0], 0.0], dtype=torch.float64).expand(B, N, 2).contiguous(),
        x=torch.as_tensor(ref.x[: N + 1]).expand(B, N + 1, n).contiguous())
    return prob, st


def _tick_problem(prob, t, x_true):
    qs, cs = _windows()
    cost = dataclasses.replace(prob.cost, q=torch.as_tensor(qs[t]), c=torch.as_tensor(cs[t]))
    return dataclasses.replace(prob, cost=cost, x0=x_true)


def _assert_port_matches(j_run, opts):
    """The port's vmapped closed loop against JAX's, tick for tick; returns
    whether some lane escalated its penalty (the bound bit)."""
    prob, st = _port_start()
    xt = torch.as_tensor(_x_true0())
    saw_penalty = False
    for t, (j_xt, j_st, j_stats) in enumerate(j_run):
        st, stats = vmap_solve(_tick_problem(prob, t, None), opts)(xt, st)
        xt = prob.dynamics(xt.T, st.u[:, 0].T, prob.h[0], 0).T
        st = dataclasses.replace(st, x=torch.cat([st.x[:, 1:], st.x[:, -1:]], dim=1),
                                 u=torch.cat([st.u[:, 1:], st.u[:, -1:]], dim=1))
        for name in ("status", "iterations", "ls_iterations"):
            np.testing.assert_array_equal(getattr(stats, name).numpy(), getattr(j_stats, name),
                                          err_msg=f"tick {t}: {name}")
        np.testing.assert_allclose(stats.dphi.numpy(), j_stats.dphi, rtol=0, atol=1e-8)
        np.testing.assert_allclose(xt.numpy(), j_xt, rtol=0, atol=1e-8)
        np.testing.assert_allclose(st.x.numpy(), j_st.x, rtol=0, atol=1e-8)
        np.testing.assert_allclose(st.u.numpy(), j_st.u, rtol=0, atol=1e-8)
        np.testing.assert_allclose(st.rho.numpy(), j_st.rho, rtol=1e-12)
        saw_penalty |= bool((stats.rho > 1.0).any())
    return saw_penalty


def test_steering_bound_matches_jax_vmapped_solve():
    assert _assert_port_matches(_jax_run(), OPTS)  # the bound bit: some lane escalated


@pytest.mark.parametrize("change", [dict(parallel_linesearch=False), dict(ls_phase_split=False)],
                         ids=["parallel_linesearch", "ls_phase_split"])
def test_vmap_solve_runs_formerly_refused_options(change):
    """The sequential backtracking (parallel_linesearch=False with the
    bench's use_backtracking_linesearch, without cubic-first) and the
    non-split grid (ls_phase_split=False) now solve, lane for lane as
    jax.vmap(solve) does on the steering-bound problem. (The real-time
    iteration without the phase split is held to JAX on the double
    integrator, test_torch_vmap_solve_default_rti.py: its full steps
    diverge here on the lanes started past the bound, where f64 roundoff
    grows to O(1) within a few iterations in both packages.)"""
    opts = OPTS.replace(**change)
    _assert_port_matches(_jax_run(opts), opts)


def test_armijo_only_vmapped_solve_equals_solve_tiled():
    opts = mpc.bench_options(iterations_max=4)[0]
    assert opts.ls_armijo_only and tsv.supported_options(opts)
    prob, st = _port_start()
    xt = torch.as_tensor(_x_true0())
    tiled_prob = _tick_problem(prob, 0, tsv.batch_to_lanes(xt))
    st_t, s_t = tsv.solve_tiled(tiled_prob, tsv.state_to_lanes(st), opts)
    st_v, s_v = vmap_solve(_tick_problem(prob, 0, None), opts)(xt, st)
    for name in ("status", "iterations", "ls_iterations", "objective_value", "merit_value",
                 "stationarity", "primal_feasibility", "rho", "alpha", "bp_fail_index"):
        assert torch.equal(getattr(s_v, name), getattr(s_t, name)), name
    st_t = tsv.state_from_lanes(st_t)
    for name in ("x", "u", "y", "K", "d", "P", "p", "rho", "reg"):
        assert torch.equal(getattr(st_v, name), getattr(st_t, name)), name
    assert torch.isnan(s_t.dphi).all()
    stepped = s_v.alpha > 0
    assert bool(stepped.any())
    assert bool(torch.isnan(s_v.dphi[stepped]).all())


@pytest.mark.parametrize("change, name, base", [
    (dict(ls_grid_x_only=False), None, {}),
    (dict(rti_mode=True, parallel_linesearch=False, ls_grid_x_only=False), None,
     dict(rti_mode=True, parallel_linesearch=False)),
    (dict(parallel_riccati=True, pallas_backward=False), None, dict(pallas_backward=False)),
    (dict(exact_al_hessian=True), None, {}),
    (dict(iteration_callback=print), None, {}),
    (dict(verbose=Verbosity.INNER), None, {}),
])
def test_vmap_solve_refuses_unported_options(change, name, base, capsys):
    """Options the vmapped solve did not port were refused by name; none is
    left since parallel_riccati was ported (the associative backward on
    dense expansions takes the serial backward's iterates lane for lane,
    to roundoff). The others run: exact_al_hessian (ported with the
    obstacle row) on the affine steering bound equals the Gauss-Newton
    solve lane for lane (the dense backward is on in OPTS), and
    iteration_callback and verbose (ported with the per-lane slice) leave
    the solve as it was; the light-payload grid (ls_grid_x_only=False, in
    the grid and in the RTI step) takes the x-only route's iterates, to
    roundoff."""
    prob, st = _port_start()
    if name is not None:
        with pytest.raises(NotImplementedError, match=name):
            vmap_solve(prob, OPTS.replace(**change))
        return
    p, xt = _tick_problem(prob, 0, None), torch.as_tensor(_x_true0())
    st1, s1 = vmap_solve(p, OPTS.replace(**change))(xt, st)
    st0, s0 = vmap_solve(p, OPTS.replace(**base))(xt, st)
    for f in ("status", "iterations", "ls_iterations"):
        assert torch.equal(getattr(s1, f), getattr(s0, f)), f
    if "ls_grid_x_only" in change or "parallel_riccati" in change:
        # the associative pass: x of size 50 at 9e-12 (roundoff over 10 iterations)
        tol = 1e-9 if "parallel_riccati" in change else 1e-12
        np.testing.assert_allclose(st1.x.numpy(), st0.x.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(st1.u.numpy(), st0.u.numpy(), rtol=0, atol=tol)
        return
    assert torch.equal(st1.x, st0.x) and torch.equal(st1.u, st0.u)


@pytest.mark.parametrize("change", [dict(parallel_riccati=True), dict(symmetrize_ctg=True)])
def test_pallas_backward_exclusions_carry_over(change):
    prob, _ = _port_start()
    with pytest.raises(ValueError, match="mutually exclusive"):
        vmap_solve(prob, OPTS.replace(**change))
