"""The batched solves' kernel refusal and the `pallas_rollout_tiled` switch.

Counterpart: altro_tpu/tile_solver.py:329-342, where the batched solve
runs the trial-rollout kernel only under `pallas_rollout_tiled` and
otherwise the scan grid. The port runs its CUDA kernels on CUDA tensors
or refuses the problem before anything runs
(`tile_solver.kernel_refusal`, one message naming every kernel and what
it cannot take); `pallas_rollout_tiled=False` selects the plain grid on
any device. Shapes and options only: no solve runs on the card here, and
a stand-in x0 that claims to lie on one shows that each entry point
refuses before it touches anything else.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from altro_tpu_torch import mpc, rescue, solver  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.io.scotty import load_scotty  # noqa: E402
from altro_tpu_torch.parallel import batch  # noqa: E402
from altro_tpu_torch.problem import Problem, lqr_cost_from_reference  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.reference_problems import (  # noqa: E402
    cartpole_swingup_problem,
    rocket_landing_problem,
)

OPTS, OPTS_R = mpc.bench_options(iterations_max=3)


def _linear_problem(dtype=torch.float32, N=4, n=2):
    """A chain of n integrators driven by one input, written here (no
    column-form step): n = 2 the pendulum's (2, 1), n = 4 the cartpole's
    (4, 1), a shape the batched backward kernels still lack (the
    single-lane one has it), n = 3 a shape no backward kernel has."""
    kw = dict(dtype=dtype, device="cpu")

    def step(x, u, h, k):
        return torch.stack([x[i] + h * x[i + 1] for i in range(n - 1)] + [x[n - 1] + h * u[0]])

    cost = lqr_cost_from_reference(torch.ones((N + 1, n), **kw), torch.full((N + 1, 1), 0.1, **kw),
                                   torch.zeros((N + 1, n), **kw), torch.zeros((N + 1, 1), **kw))
    return Problem(N=N, n=n, m=1, dynamics=step, dynamics_jac=None, constraints=(), cost=cost,
                   h=torch.full((N,), 0.1, **kw), x0=torch.zeros(n, **kw))


def _bicycle(rows, dtype=torch.float32, N=4):
    """The Scotty problem with `rows` affine steering rows: 2 is the main
    path's bound; 1 keeps its upper row; 3 adds a second group of one."""
    prob = mpc.scotty_problem(load_scotty(), N=N, dtype=dtype, device="cpu")
    bound = prob.constraints[0]
    if rows == 2:
        return prob
    upper = dataclasses.replace(bound, fn=lambda x, u, k: x[3:4] - mpc.DELTA_MAX, dim=1,
                                jac=None, label="upper steering bound")
    groups = (upper,) if rows == 1 else (bound, upper)
    return dataclasses.replace(prob, constraints=groups)


def _problem(name):
    if name == "linear_2x1":
        return _linear_problem()
    if name == "linear_4x1":
        return _linear_problem(n=4)
    if name == "pendulum":
        return mpc.pendulum_swingup_problem(N=4, device="cpu")
    if name == "rocket":
        return rocket_landing_problem(N=4, device="cpu")[0]
    if name == "quadrotor":  # without its column and block steps
        return dataclasses.replace(mpc.quadrotor_waypoint_problem(N=4, device="cpu"),
                                   dynamics_cols=None, dynamics_tile=None)
    if name == "quadrotor_full":
        return mpc.quadrotor_waypoint_problem(N=4, device="cpu")
    if name == "main_path_f64":
        return _bicycle(2, dtype=torch.float64)
    return _bicycle({"bicycle_1_row": 1, "main_path": 2, "bicycle_3_rows": 3}[name])


# (problem, words the refusal names with pallas_rollout_tiled, words it
# names without it); () means no refusal
CASES = [
    ("linear_2x1", ("rollout_grid", "column-form", "pallas_rollout_tiled=False"), ()),
    ("linear_4x1", ("riccati_backward", "n=4, m=1", "rollout_grid", "column-form",
                    "pallas_rollout_tiled=False"),
     ("riccati_backward", "n=4, m=1")),
    ("pendulum", (), ()),
    ("rocket", ("rollout_grid", "column-form", "pallas_rollout_tiled=False"), ()),
    ("quadrotor", ("rollout_grid", "column-form", "pallas_rollout_tiled=False"), ()),
    ("bicycle_1_row", ("rollout_grid", "1 constraint rows in 1 groups"), ()),
    ("bicycle_3_rows", ("rollout_grid", "3 constraint rows in 2 groups"), ()),
    ("main_path_f64", ("riccati_backward", "rollout_grid", "float32"),
     ("riccati_backward", "float32")),
    ("main_path", (), ()),
    ("quadrotor_full", (), ()),
]


@pytest.mark.parametrize("name, words, words_plain_grid", CASES, ids=[c[0] for c in CASES])
def test_kernel_refusal_names_each_kernel(name, words, words_plain_grid):
    """One message names every kernel `solve_tiled` would launch and what
    it cannot take; `pallas_rollout_tiled=False` drops the rollout's."""
    prob = _problem(name)
    for opts, expect in ((OPTS, words), (OPTS.replace(pallas_rollout_tiled=False),
                                         words_plain_grid)):
        why = tsv.kernel_refusal(prob, opts, vmapped=False)
        if not expect:
            assert why is None, why
            continue
        for word in expect:
            assert word in why, (word, why)
        if not opts.pallas_rollout_tiled:
            assert "rollout_grid" not in why


@pytest.mark.parametrize("name", ["linear_2x1", "quadrotor", "main_path", "quadrotor_full",
                                  "linear_4x1", "rocket"])
def test_vmapped_refusal_reads_only_the_dense_kernel(name):
    """The vmapped solve runs the plain grid always and a kernel only for
    the backward pass under `pallas_backward`."""
    prob = _problem(name)
    fused = OPTS.replace(pallas_backward=True)
    why = tsv.kernel_refusal(prob, fused, vmapped=True)
    if name == "linear_4x1":
        assert "riccati_dense" in why and "n=4, m=1" in why and "rollout_grid" not in why
    else:
        assert why is None, why
    assert tsv.kernel_refusal(prob, OPTS, vmapped=True) is None


class _OnCard:
    """Stands in for an x0 on a CUDA device: anything past the refusal
    that touched it would fail with another error."""

    is_cuda = True
    dtype = torch.float32
    device = torch.device("cuda", 0)  # a name only: nothing is allocated there


@pytest.mark.parametrize("entry", ["solve_tiled", "solve_tiled_with_rescue", "solve_lanes",
                                   "vmap_solve", "vmap_solve_with_rescue"])
def test_entry_points_refuse_before_anything_runs(entry):
    prob = dataclasses.replace(_linear_problem(n=4), x0=_OnCard())
    fused = OPTS.replace(pallas_backward=True)
    calls = {
        "solve_tiled": lambda: tsv.solve_tiled(prob, None, OPTS),
        "solve_tiled_with_rescue": lambda: rescue.solve_tiled_with_rescue(prob, None, OPTS,
                                                                          OPTS_R),
        "solve_lanes": lambda: batch.solve_lanes(prob, None, fused),
        "vmap_solve": lambda: batch.vmap_solve(_linear_problem(n=4), fused)(_OnCard(), None),
        "vmap_solve_with_rescue": lambda: rescue.vmap_solve_with_rescue(
            _linear_problem(n=4), _OnCard(), None, OPTS, fused),
    }
    with pytest.raises(NotImplementedError, match=f"{entry}: .*n=4, m=1"):
        calls[entry]()


def test_rescue_checks_both_tiers_up_front():
    """The main path passes its primary options; a rescue tier that asks
    for the trial-grid kernel on a 3-row problem is refused before the
    primary tier runs."""
    prob = dataclasses.replace(_bicycle(3), x0=_OnCard())
    with pytest.raises(NotImplementedError, match="3 constraint rows"):
        rescue.solve_tiled_with_rescue(prob, None, OPTS.replace(pallas_rollout_tiled=False),
                                       OPTS_R)


def test_plain_grid_option_never_calls_the_kernel_wrapper(monkeypatch):
    """With pallas_rollout_tiled=False the lane loop runs rollout_grid_ref
    and never the kernel's wrapper; on the CPU both give the same solve."""
    prob = mpc.scotty_problem(load_scotty(), N=6, dtype=torch.float64, device="cpu")
    x0 = mpc.perturbed_initial_states(load_scotty(), 3, seed=1, dtype=torch.float64,
                                      device="cpu")
    state = tsv.state_to_lanes(batch.batch_init_state(prob, 3))
    prob = dataclasses.replace(prob, x0=tsv.batch_to_lanes(x0))
    calls = []
    wrapper = tsv.rollout_grid

    def counting(*args, **kw):
        calls.append(1)
        return wrapper(*args, **kw)

    monkeypatch.setattr(tsv, "rollout_grid", counting)
    st_k, stats_k = tsv.solve_tiled(prob, state, OPTS)
    assert calls

    def refuse(*args, **kw):
        raise AssertionError("the kernel's wrapper ran under pallas_rollout_tiled=False")

    monkeypatch.setattr(tsv, "rollout_grid", refuse)
    st_p, stats_p = tsv.solve_tiled(prob, state, OPTS.replace(pallas_rollout_tiled=False))
    assert torch.equal(stats_k.status, stats_p.status)
    assert torch.equal(stats_k.iterations, stats_p.iterations)
    assert torch.equal(st_k.x, st_p.x) and torch.equal(st_k.u, st_p.u)


# (problem, options, words the single-lane refusal names on the card); ()
# means no refusal
SINGLE_LANE_CASES = [
    ("quadrotor_full", {}, ()),
    ("quadrotor", {}, ("pallas_rollout", "no block step")),
    ("quadrotor_full", {"ls_parallel_width": 33}, ("trial_rollout", "W=33")),
    ("quadrotor_full", {"pallas_rollout": False}, ()),
]


@pytest.mark.parametrize("name, kw, words", SINGLE_LANE_CASES,
                         ids=["full", "no_block_step", "w33", "plain_grid"])
def test_single_lane_refusal_on_the_card(name, kw, words):
    """The latency row's options on the card: the (12, 4) backward kernel
    and the quadrotor's trial-rollout kernel take the full quadrotor;
    without its block step, or with more trials than the kernel's warp
    holds, the solve is refused before it starts."""
    prob = dataclasses.replace(_problem(name), x0=_OnCard())
    why = solver.single_lane_refusal(prob, mpc.quadrotor_latency_options().replace(**kw))
    if not words:
        assert why is None, why
        return
    for word in words:
        assert word in why, (word, why)


# (problem, options, words the single-lane refusal names on the card); ()
# means no refusal
LATENCY_SHAPE_CASES = [
    ("rocket_6x3", lambda: rocket_landing_problem(N=4, device="cpu")[0],
     mpc.rocket_landing_options(), ()),
    ("cartpole_4x1", lambda: cartpole_swingup_problem(N=4, device="cpu")[0],
     mpc.cartpole_swingup_options(), ()),
    ("linear_3x1", lambda: _linear_problem(n=3), SolverOptions(),
     ("riccati_latency", "n=3, m=1", "pallas_latency_backward=False")),
]


@pytest.mark.parametrize("name, make, opts, words", LATENCY_SHAPE_CASES,
                         ids=[c[0] for c in LATENCY_SHAPE_CASES])
def test_single_lane_refusal_reads_the_latency_shapes(name, make, opts, words):
    """The single-lane backward kernel takes the rocket's (6, 3) and the
    cart-pole's (4, 1) under their rows' options; a shape it lacks is
    refused on the card, naming the kernel and the plain backward, and
    runs there with pallas_latency_backward=False."""
    prob = dataclasses.replace(make(), x0=_OnCard())
    why = solver.single_lane_refusal(prob, opts)
    if not words:
        assert why is None, why
        return
    for word in words:
        assert word in why, (word, why)
    assert solver.single_lane_refusal(prob, opts.replace(pallas_latency_backward=False)) is None


def test_tiled_row_options_take_the_full_quadrotor():
    """The tiled row's options: both batched kernels take the quadrotor
    with its column step; the vmapped row's dense kernel too."""
    prob = _problem("quadrotor_full")
    assert tsv.kernel_refusal(prob, mpc.quadrotor_tiled_options(), vmapped=False) is None
    assert tsv.kernel_refusal(prob, mpc.quadrotor_options(), vmapped=True) is None
    assert tsv.supported_options(mpc.quadrotor_tiled_options())


def test_vmapped_plain_run_takes_the_tiled_rows_steps():
    """The tiled row's float64 reference on the card is the vmapped loop
    with the tiled row's options and pallas_backward=False: the plain
    backward, the plain grid and the Armijo-only search. On the CPU, where
    `solve_tiled` runs the same plain versions, the two loops agree
    exactly in statuses, iterations, states and inputs."""
    prob = mpc.quadrotor_waypoint_problem(N=6, dtype=torch.float64, device="cpu")
    x0 = mpc.quadrotor_initial_states(3, seed=1, dtype=torch.float64, device="cpu")
    opts = mpc.quadrotor_tiled_options().replace(iterations_max=3)
    tiled = mpc.run_quadrotor_waypoints_tiled(prob, x0, ticks=3, opts=opts, switch_every=2)
    vmapped = mpc.run_quadrotor_waypoints(prob, x0, ticks=3, switch_every=2,
                                          opts=opts.replace(pallas_backward=False))
    assert torch.equal(tiled.status, vmapped.status)
    assert torch.equal(tiled.iterations, vmapped.iterations)
    assert torch.equal(tiled.x_true, vmapped.x_true)
    assert torch.equal(tiled.state.u, vmapped.state.u)


def test_other_models_rows_take_their_kernels_and_the_rocket_grid_is_refused():
    """The pendulum row's options take its problem on both batched kernels
    ((2, 1) backward, the pendulum's column step with its two rows on u);
    the rocket row's take (6, 3) on the backward with the plain grid, and
    with `pallas_rollout_tiled` `solve_tiled` refuses it on the card,
    naming the trial-grid kernel, before anything runs."""
    pend = _problem("pendulum")
    assert tsv.kernel_refusal(pend, mpc.pendulum_swingup_options(), vmapped=False) is None
    rocket = _problem("rocket")
    opts = mpc.rocket_soc_options()
    assert tsv.kernel_refusal(rocket, opts, vmapped=False) is None
    assert tsv.kernel_refusal(rocket, opts.replace(pallas_backward=True), vmapped=True) is None
    on_card = dataclasses.replace(rocket, x0=_OnCard())
    with_grid = opts.replace(pallas_rollout_tiled=True)
    with pytest.raises(NotImplementedError,
                       match="solve_tiled: the trial-grid kernel.*column-form"):
        tsv.solve_tiled(on_card, None, with_grid)


def _per_lane_costs(prob, lanes=3):
    """The problem with q [N+1, n, B] and c [N+1, B], one row per lane (as
    batched_tracking_solver gives them)."""
    cost = prob.cost
    q = cost.q[..., None] + 0.01 * torch.arange(lanes, dtype=cost.q.dtype)
    c = cost.c[:, None].expand(-1, lanes).contiguous()
    return dataclasses.replace(prob, cost=dataclasses.replace(cost, q=q, c=c))


def test_per_lane_costs_refuse_the_trial_grid_kernel():
    """The trial-grid kernel reads per-lane cost rows in its LANE_COST
    instantiations, the quadrotor's included: with per-lane q and c (or
    h) the bicycle's and the quadrotor's problems are taken by both
    batched kernels. What it refuses, as JAX's `rollout_tiled_eligible`
    does (altro_tpu/ops/pallas_rollout_tiled.py:78-92), is a constraint
    group with a per-lane `active` mask, and linear dynamics arrays
    (no column-form step): `solve_tiled` on the card under
    `pallas_rollout_tiled` refuses them before anything runs, with the
    reason and the plain grid's switch; without it (and in the vmapped
    solve, which runs the plain grid) nothing is refused."""
    bike = _per_lane_costs(_bicycle(2))
    assert tsv.kernel_refusal(bike, OPTS, vmapped=False) is None
    bike_h = dataclasses.replace(_bicycle(2), h=_bicycle(2).h[:, None].expand(-1, 3))
    assert tsv.kernel_refusal(bike_h, OPTS, vmapped=False) is None
    for prob in (_per_lane_costs(_problem("quadrotor_full")),
                 dataclasses.replace(_problem("quadrotor_full"),
                                     h=_problem("quadrotor_full").h[:, None].expand(-1, 3))):
        assert tsv.kernel_refusal(prob, mpc.quadrotor_tiled_options(), vmapped=False) is None
        assert tsv.kernel_refusal(prob, mpc.quadrotor_options(), vmapped=True) is None

    spec = _bicycle(2).constraints[0]
    masks = dataclasses.replace(_bicycle(2), constraints=(dataclasses.replace(
        spec, active=spec.active[:, None].expand(-1, 3).contiguous()),))
    fleet = rp.fleet_problem(rp.fleet_arrays(3, N=4), dtype=torch.float32, device="cpu")
    for prob, words in ((masks, "per-lane active mask"), (fleet, "linear dynamics")):
        why = tsv.kernel_refusal(prob, OPTS, vmapped=False)
        assert "rollout_grid" in why and words in why and "pallas_rollout_tiled=False" in why
        assert tsv.kernel_refusal(prob, OPTS.replace(pallas_rollout_tiled=False),
                                  vmapped=False) is None
        assert tsv.kernel_refusal(prob, OPTS.replace(pallas_backward=True), vmapped=True) is None
        with pytest.raises(NotImplementedError, match=f"solve_tiled: .*{words}"):
            tsv.solve_tiled(dataclasses.replace(prob, x0=_OnCard()), None, OPTS)


@pytest.mark.parametrize("change", [dict(parallel_linesearch=False), dict(ls_phase_split=False),
                                    {"use_backtracking_linesearch": False,
                                     "parallel_linesearch": False},
                                    dict(ls_grid_x_only=False),
                                    dict(iteration_callback=print)],
                         ids=["sequential_backtracking", "non_split_grid", "strong_wolfe",
                              "light_payload_grid", "iteration_callback"])
def test_solve_tiled_keeps_refusing_the_other_searches(change):
    """As JAX's solve_tiled (altro_tpu/tile_solver.py:133-147, :286-291),
    the port's takes the phase-split x-only Armijo-only grid or RTI only,
    without an iteration_callback: the searches the vmapped solve runs,
    the light-payload grid among them, and the callback are a ValueError
    there, on the card as on the CPU."""
    with pytest.raises(ValueError, match="solve_tiled supports"):
        tsv.solve_tiled(_bicycle(2), None, OPTS.replace(**change))
    with pytest.raises(ValueError, match="solve_tiled supports"):
        tsv.solve_tiled(dataclasses.replace(_bicycle(2), x0=_OnCard()), None,
                        OPTS.replace(**change))


def test_default_options_vmap_solve_refuses_a_shape_before_launching():
    """Default SolverOptions() (the strong-Wolfe search) with
    `pallas_backward` on a shape the dense kernel lacks: refused by
    `vmap_solve` and `batched_tracking_solver` on the card, by name,
    before anything runs."""
    from altro_tpu_torch.options import SolverOptions

    prob = _linear_problem(n=4)
    opts = SolverOptions(pallas_backward=True)
    with pytest.raises(NotImplementedError, match="vmap_solve: .*riccati_dense.*n=4, m=1"):
        batch.vmap_solve(prob, opts)(_OnCard(), None)
    with pytest.raises(NotImplementedError,
                       match="batched_tracking_solver: .*riccati_dense.*n=4, m=1"):
        batch.batched_tracking_solver(prob, opts)(_OnCard(), None, None, None)
    assert tsv.kernel_refusal(prob, SolverOptions(), vmapped=True) is None


def _facade_on_card(build):
    """A facade built on the CPU whose problem then claims to lie on the
    card (the stand-in x0): its solve must refuse before anything runs."""
    s = build()
    card = _OnCard()
    card.dtype = s.problem.dtype
    s._problem = dataclasses.replace(s.problem, x0=card)
    return s


def _facade_3x2(dtype=torch.float64):
    """tests/test_hetero_dims.py's phase B alone: (n, m) = (3, 2), in
    float64, which the single-lane backward kernel does not take (it takes
    float32; its (3, 2) instantiation runs the float32 problem)."""
    from altro_tpu_torch.api import ALTROSolver

    s = ALTROSolver(10, dtype=dtype, device="cpu")
    s.set_dimension(3, 2)
    s.set_time_step(0.1)
    s.set_explicit_dynamics(lambda x, u, h, k: torch.stack(
        [x[0] + x[1] * h + 0.5 * u[0] * h * h, x[1] + (u[0] - u[1] * x[1]) * h, x[2] + x[0] * h]))
    s.set_lqr_cost([1.0, 1.0, 0.5], [0.1, 0.1], [1.0, 0.0, 0.0], [0.0, 0.0])
    s.initialize()
    return s


def _facade_foreign_block_step():
    """tests/test_api.py:250-293's configuration with a block step that
    names no device step (a pendulum written here, not pendulum_tile)."""
    from altro_tpu_torch.api import ALTROSolver
    from altro_tpu_torch.models.integrators import midpoint
    from altro_tpu_torch.models.pendulum import pendulum_continuous
    from altro_tpu_torch.models.tile_steps import midpoint_tile

    f = pendulum_continuous()
    s = ALTROSolver(30, device="cpu")
    s.set_dimension(2, 1)
    s.set_time_step(0.06)
    s.set_explicit_dynamics(midpoint(f))
    s.set_lqr_cost([0.1, 0.1], [1e-3], [3.14159, 0.0], [0.0])
    s.set_input_bounds(u_lo=[-6.0], u_hi=[6.0])
    s.set_tile_dynamics(midpoint_tile(lambda x, u: f(x.T, u.T).T))
    s.initialize()
    s.set_options(SolverOptions(use_backtracking_linesearch=True, parallel_linesearch=True,
                                ls_phase_split=True, ls_armijo_only=True))
    return s


@pytest.mark.parametrize("build, words, plain", [
    (_facade_3x2, ("riccati_latency", "torch.float64", "pallas_latency_backward=False"),
     dict(pallas_latency_backward=False)),
    (_facade_foreign_block_step, ("trial_rollout", "names no device step",
                                  "pallas_rollout=False"), dict(pallas_rollout=False)),
], ids=["3x2", "foreign_block_step"])
def test_facade_refuses_on_the_card_before_anything_runs(build, words, plain):
    """A facade problem on the card that no kernel takes is refused by its
    solve before anything launches; the message names the option that
    selects the plain path, and with it the refusal is gone."""
    s = _facade_on_card(build)
    with pytest.raises(NotImplementedError) as e:
        s.solve()
    for word in words:
        assert word in str(e.value), (word, str(e.value))
    assert solver.single_lane_refusal(s.problem, s._opts.replace(**plain)) is None
    if build is _facade_3x2:  # the float32 problem runs on the (3, 2) instantiation
        s32 = _facade_on_card(lambda: _facade_3x2(torch.float32))
        assert solver.single_lane_refusal(s32.problem, s32._opts) is None


class _OnCardF64(_OnCard):
    dtype = torch.float64


def test_implicit_solve_refuses_what_the_gauss_newton_kernels_cannot_take():
    """diff.implicit_solve's Gauss-Newton backward on the card: one lane
    runs riccati_latency (it has (4, 1), float32 only), a vmapped batch
    riccati_dense (no (4, 1)); float64 or a missing shape is refused
    before anything runs, under pallas_backward too, and
    pallas_latency_backward=False (the plain backward) or a CPU problem is
    never refused."""
    from altro_tpu_torch import diff

    on_card = dataclasses.replace(_linear_problem(n=4), x0=_OnCard())
    assert diff.gn_refusal(on_card, SolverOptions(), vmapped=False) is None
    why = diff.gn_refusal(on_card, SolverOptions(), vmapped=True)
    assert "riccati_dense" in why and "n=4, m=1" in why
    f64 = dataclasses.replace(_linear_problem(n=4, dtype=torch.float64), x0=_OnCardF64())
    why = diff.gn_refusal(f64, SolverOptions(), vmapped=False)
    assert "riccati_latency" in why and "torch.float64" in why
    plain = SolverOptions(pallas_latency_backward=False)
    assert diff.gn_refusal(f64, plain, vmapped=False) is None
    assert diff.gn_refusal(_linear_problem(n=3), SolverOptions(), vmapped=True) is None
    fused = SolverOptions(pallas_backward=True)  # does not make the backward plain
    for vmapped in (False, True):
        assert "torch.float64" in diff.gn_refusal(f64, fused, vmapped=vmapped)
        assert diff.gn_refusal(f64, fused.replace(pallas_latency_backward=False),
                               vmapped=vmapped) is None
    with pytest.raises(NotImplementedError, match="implicit_solve: .*riccati_latency.*float64"):
        diff.implicit_solve(f64)
