"""The port's single-lane solve and grid line search against altro_tpu.

`solver.solve` against the JAX `solve` in f64 on the Scotty problem at
N = 40 with the options of the N=500 rows (mpc.long_horizon_options: 20
iterations, the phase-split x-only Armijo-only grid of width 8 over 24
trials, the latency backward and trial-rollout paths, diagonal
expansions), the JAX problem carrying the same block step so both take
the trial-rollout grid. Both variants: the steering bound |delta| <= 60
deg (the start's steering offset puts the bound in play) and the
unconstrained problem. Status, iterations and ls_iterations equal; x, u
and the objective to 1e-8. The starts are chosen where the problem is
well conditioned: from steering near +-pi/2 (the tangent's pole) the
closed loop amplifies roundoff so strongly that no two implementations
agree.

The options the solve refuses, each by name, and the three it ran
only after the strong-Wolfe search, the non-split grid and dense
expansions were ported (the sequential backtracking, the non-split grid,
dense expansions), each against the JAX solve. Problems the trial
rollout cannot take: refused on the card, and on the CPU solved on the
grid JAX falls back to, against the JAX solve.

`linesearch.parallel_backtracking_search_split` against the JAX search
on synthetic merits: one that first passes Armijo in block 2 (with and
without the strong-Wolfe test of trial 0), and one that never passes and
falls back to its best decrease.
"""

import dataclasses
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.io.scotty import load_scotty as jload  # noqa: E402
from altro_tpu.linesearch import LineSearchOptions as JLSOpts  # noqa: E402
from altro_tpu.linesearch import parallel_backtracking_search_split as jsearch  # noqa: E402
from altro_tpu.models.bicycle import bicycle_continuous as jbicycle  # noqa: E402
from altro_tpu.models.integrators import midpoint as jmidpoint  # noqa: E402
from altro_tpu.models.tile_steps import bicycle_tile as jbicycle_tile  # noqa: E402
from altro_tpu.models.tile_steps import midpoint_tile as jmidpoint_tile  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import lqr_cost_from_reference as jlqr  # noqa: E402
from altro_tpu.solver import init_state as jinit  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import linesearch as ls  # noqa: E402
from altro_tpu_torch import mpc, solver  # noqa: E402
from altro_tpu_torch.cones import Cone  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.ops import riccati_latency as rl  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402
from altro_tpu_torch.problem import ConstraintSpec  # noqa: E402

N, n, m = 40, 4, 2
DM = 60 * np.pi / 180.0
REF = jload()
H = float(np.float32(REF.tf / REF.N))
T_OPTS = mpc.long_horizon_options()

# (variant, start offset of (px, py, theta, delta) from the path's start,
# option overrides). The third case takes trial 0 on Armijo plus strong
# Wolfe, which completes its payload with the dphi recurrence.
STARTS = [("steering_bound", (0.0, 0.0, 0.3, 0.6), {}),
          ("unconstrained", (-1.0, 0.5, -0.3, 0.4), {}),
          ("steering_bound_wolfe_first", (0.0, 0.0, 0.3, 0.6), {"ls_armijo_only": False})]


def _jax_solve(constrained, x0, opts, case=None):
    """JAX's solve of the Scotty problem; `case` alters it as
    test_solve_refuses_ineligible_trial_grid does."""
    steering = JSpec(fn=lambda x, u, k: jnp.stack([x[3] - DM, -DM - x[3]]),
                     cone=JCone.NEGATIVE_ORTHANT, dim=2, active=jnp.ones(N + 1, bool),
                     diag_hessian=True, affine=True)
    groups = (steering,) if constrained else ()
    if case == "non_affine_group":
        groups = (dataclasses.replace(steering, affine=False),)
    elif case == "three_rows":
        groups = (steering, dataclasses.replace(
            steering, fn=lambda x, u, k: jnp.stack([x[3] - DM]), dim=1))
    prob = JProblem(
        N=N, n=n, m=m, dynamics=jmidpoint(jbicycle()), dynamics_jac=None,
        constraints=groups,
        cost=jlqr(jnp.full((N + 1, n), 1e-2), jnp.full((N + 1, m), 1e-3),
                  jnp.asarray(REF.x[: N + 1]), jnp.asarray(REF.u[: N + 1])),
        h=jnp.full(N, H), x0=jnp.asarray(x0),
        dynamics_tile=None if case == "no_block_step" else jmidpoint_tile(jbicycle_tile()))
    st = dataclasses.replace(jinit(prob),
                             u=jnp.tile(jnp.asarray([REF.u[0][0], 0.0]), (N, 1)),
                             x=jnp.asarray(REF.x[: N + 1]))
    jopts = JOpts(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)})
    return jax.jit(lambda s: jsolve(prob, s, jopts))(st)


@pytest.mark.parametrize("variant,offset,override", STARTS, ids=[s[0] for s in STARTS])
def test_solve_matches_jax_solve_f64(variant, offset, override):
    constrained = variant.startswith("steering_bound")
    opts = T_OPTS.replace(**override)
    x0 = REF.x[0] + np.asarray(offset)
    j_state, j_stats = _jax_solve(constrained, x0, opts)

    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=N, dtype=torch.float64, device="cpu")
    prob = dataclasses.replace(prob, x0=torch.as_tensor(x0))
    if not constrained:
        prob = dataclasses.replace(prob, constraints=())
    before = (rl.LAUNCHES, tr.LAUNCHES)
    state, stats = solver.solve(prob, mpc.long_horizon_state(prob, ref), opts)
    assert (rl.LAUNCHES, tr.LAUNCHES) == before  # CPU: plain versions only

    for k in ("status", "iterations", "ls_iterations", "bp_fail_index"):
        assert int(getattr(stats, k)) == int(getattr(j_stats, k)), k
    assert int(stats.iterations) == 20  # the full budget: every iteration compared
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(stats.objective_value), float(j_stats.objective_value),
                               rtol=1e-8)
    np.testing.assert_allclose(float(stats.merit_value), float(j_stats.merit_value), rtol=1e-8)
    np.testing.assert_allclose(float(stats.rho), float(j_stats.rho), rtol=1e-12)
    for zt, zj in zip(state.z, j_state.z):
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-8)
    if constrained:
        # the bound is in play: the start steers within 0.45 rad of it and
        # the penalty term is nonzero along the way
        assert float(stats.merit_value) != float(stats.objective_value)


@pytest.mark.parametrize("kw,word", [
    (dict(rti_mode=True), None),
    (dict(pallas_backward=True, symmetrize_ctg=False), None),
    (dict(iteration_callback=lambda *a: None), None),
    (dict(verbose=2), None),
    (dict(exact_al_hessian=True), None),
    (dict(parallel_riccati=True), None),
    (dict(ls_grid_x_only=False), None),
], ids=["rti_mode", "pallas_backward", "iteration_callback", "verbose", "exact_al_hessian",
        "parallel_riccati", "ls_grid_x_only"])
def test_solve_refuses_unported_options(kw, word, capsys):
    """Options the single-lane solve did not implement were refused by
    name; none is left since parallel_riccati was ported (the associative
    backward on dense expansions takes the dense serial solve's iterates,
    to roundoff). The others run: iteration_callback and
    verbose (ported with the facade) leave the solve unchanged; so does
    exact_al_hessian (ported with the obstacle row): on this problem's
    affine bound it equals the Gauss-Newton Hessian of dense expansions
    (diag_expansion=False). Since the per-lane slice: ls_grid_x_only=False
    (the light-payload grid) takes the x-only grid's trials and payloads,
    pallas_backward (dense expansions, the plain recursion) the dense
    solve's, to roundoff; rti_mode takes the full step every iteration."""
    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=6, dtype=torch.float64, device="cpu")
    st = mpc.long_horizon_state(prob, ref)
    if word is not None:
        with pytest.raises(NotImplementedError, match=word):
            solver.solve(prob, st, T_OPTS.replace(**kw))
        return
    st1, stats1 = solver.solve(prob, st, T_OPTS.replace(**kw))
    if "rti_mode" in kw:
        assert int(stats1.status) == 0
        assert float(stats1.alpha) == 1.0 and int(stats1.ls_iterations) == 1
        return
    base = T_OPTS
    if "exact_al_hessian" in kw or "parallel_riccati" in kw:
        base = T_OPTS.replace(diag_expansion=False)
    if "pallas_backward" in kw:
        base = T_OPTS.replace(diag_expansion=False, symmetrize_ctg=False)
    st0, stats0 = solver.solve(prob, st, base)
    assert int(stats1.status) == int(stats0.status)
    assert int(stats1.iterations) == int(stats0.iterations)
    if "pallas_backward" in kw or "ls_grid_x_only" in kw or "parallel_riccati" in kw:
        np.testing.assert_allclose(st1.x.numpy(), st0.x.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(st1.u.numpy(), st0.u.numpy(), rtol=0, atol=1e-12)
        return
    assert torch.equal(st1.x, st0.x) and torch.equal(st1.u, st0.u)
    assert ("ALTRO SOLVE FINISHED" in capsys.readouterr().out) == ("verbose" in kw)


@pytest.mark.parametrize("kw", [
    dict(parallel_linesearch=False, ls_armijo_only=False),
    dict(ls_phase_split=False, ls_armijo_only=False),
    dict(diag_expansion=False),
], ids=["sequential_backtracking", "non_split_grid", "dense_expansions"])
def test_solve_runs_formerly_refused_options(kw):
    """The options the solve refused before the strong-Wolfe search, the
    non-split grid and dense expansions were ported: the sequential
    backtracking search, the non-split grid and dense expansions (with
    the trial-rollout grid) now solve, as JAX's solve does: status,
    iterations and ls_iterations equal, x and u to 1e-8."""
    opts = T_OPTS.replace(**kw)
    x0 = REF.x[0] + np.asarray(STARTS[0][1])
    j_state, j_stats = _jax_solve(True, x0, opts)
    ref = load_scotty()
    prob = dataclasses.replace(mpc.scotty_problem(ref, N=N, dtype=torch.float64, device="cpu"),
                               x0=torch.as_tensor(x0))
    state, stats = solver.solve(prob, mpc.long_horizon_state(prob, ref), opts)
    for k in ("status", "iterations", "ls_iterations", "bp_fail_index"):
        assert int(getattr(stats, k)) == int(getattr(j_stats, k)), k
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)


class _OnCard:
    """Stands in for an x0 on a CUDA device: anything past the refusal
    that touched it would fail with another error."""

    is_cuda = True
    dtype = torch.float32
    device = torch.device("cuda", 0)  # a name only: nothing is allocated there


@pytest.mark.parametrize("case,word", [("no_block_step", "no block step"),
                                       ("non_affine_group", "steering bound.*not an affine"),
                                       ("three_rows", r"3 constraint rows \(the kernel takes")])
def test_solve_refuses_ineligible_trial_grid(case, word):
    """pallas_rollout on a problem without the block step, with a
    non-affine group or with a row count the trial-rollout kernel lacks:
    on the card `single_lane_refusal` names what is missing before the
    solve starts; on the CPU the solve runs the grid JAX's solve runs
    (its scan grid without the block step or with a non-affine group, the
    trial rollout's plain version with three rows) and equals it: status,
    iterations and ls_iterations, x and u to 1e-8."""
    ref = load_scotty()
    x0 = REF.x[0] + np.asarray(STARTS[0][1])
    prob = dataclasses.replace(mpc.scotty_problem(ref, N=N, dtype=torch.float64, device="cpu"),
                               x0=torch.as_tensor(x0))
    steering = prob.constraints[0]
    if case == "no_block_step":
        prob = dataclasses.replace(prob, dynamics_tile=None)
    elif case == "non_affine_group":
        prob = dataclasses.replace(
            prob, constraints=(dataclasses.replace(steering, affine=False),))
    else:  # the steering bound and its upper row again: three rows in two affine
        # groups (the kernel takes 0, 2 or 4 since the obstacle row's slice)
        upper = ConstraintSpec(fn=lambda x, u, k: torch.stack([x[3] - mpc.DELTA_MAX]),
                               cone=Cone.NEGATIVE_ORTHANT, dim=1, active=steering.active,
                               label="upper", diag_hessian=True, affine=True)
        prob = dataclasses.replace(prob, constraints=(steering, upper))
    st = mpc.long_horizon_state(prob, ref)
    on_card = dataclasses.replace(prob, x0=_OnCard())
    assert re.search("pallas_rollout.*" + word, solver.single_lane_refusal(on_card, T_OPTS))
    with pytest.raises(NotImplementedError, match="pallas_rollout.*" + word):
        solver.solve(on_card, st, T_OPTS)
    assert solver.single_lane_refusal(on_card, T_OPTS.replace(pallas_rollout=False)) is None

    assert solver.single_lane_refusal(prob, T_OPTS) is None
    j_state, j_stats = _jax_solve(True, x0, T_OPTS, case)
    before = (rl.LAUNCHES, tr.LAUNCHES)
    state, stats = solver.solve(prob, st, T_OPTS)
    assert (rl.LAUNCHES, tr.LAUNCHES) == before  # CPU: plain versions only
    for k in ("status", "iterations", "ls_iterations", "bp_fail_index"):
        assert int(getattr(stats, k)) == int(getattr(j_stats, k)), k
    np.testing.assert_allclose(state.x.numpy(), np.asarray(j_state.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.u.numpy(), np.asarray(j_state.u), rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# grid line search on synthetic merits
# ---------------------------------------------------------------------------

def _merit(xp, kind):
    """phi(alpha) with phi0 = 1, dphi0 = -1, and a payload [alpha, phi]."""
    def merit(a):
        k = -xp.log2(a)
        if kind == "block2":  # Armijo first holds at alpha = 2^-9 (block 2)
            phi = xp.where(k > 8.5, 1.0 - 0.5 * a, 1.0 + a)
        else:  # never Armijo; the only decrease is at alpha = 2^-10
            phi = xp.where(xp.abs(k - 10.0) < 0.5, 1.0 - 0.5e-4 * a, 1.0 + a)
        return phi, xp.stack([a, phi])
    return merit


def _complete(xp):
    def complete(light, with_dphi=True):
        dphi = -0.01 * light[0] if with_dphi else light[0] * float("nan")
        return dphi, (2.0 * light, light[1] + 1.0)
    return complete


@pytest.mark.parametrize("kind,armijo_only", [("block2", True), ("block2", False),
                                              ("best_decrease", True)])
def test_grid_search_matches_jax(kind, armijo_only):
    opts = dict(max_iters=24, beta_decrease=0.5, c1=1e-4, c2=0.9)
    j = jsearch(_merit(jnp, kind), _complete(jnp), jnp.asarray(1.0), jnp.asarray(-1.0), 1.0,
                JLSOpts(**opts), width=8, armijo_only=armijo_only,
                best_decrease_fallback=True)
    t = ls.parallel_backtracking_search_split(
        _merit(torch, kind), _complete(torch), torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(-1.0, dtype=torch.float64), 1.0, ls.LineSearchOptions(**opts), width=8,
        armijo_only=armijo_only, best_decrease_fallback=True)
    want_code, want_iters = (1, 10) if kind == "block2" else (8, 24)
    assert int(t.code) == int(j.code) == want_code
    assert int(t.n_iters) == int(j.n_iters) == want_iters
    for a, b in ((t.alpha, j.alpha), (t.phi, j.phi), (t.aux_alpha, j.aux_alpha),
                 (t.aux[0], j.aux[0]), (t.aux[1], j.aux[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)
    assert np.isnan(float(t.dphi)) == np.isnan(float(j.dphi)) == armijo_only
