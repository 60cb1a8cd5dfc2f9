"""Per-lane linear dynamics through the port's batched solves, against
`jax.vmap(solve)` with those leaves batched, in f64 on the CPU.

JAX batches any leaf of its `Problem` pytree (altro_tpu/problem.py:367-371)
through `jax.vmap(solve)` and `solve_tiled`'s `prob_axes`. The port takes
one row per lane of any leaf on a trailing lane axis (A [N, n, n, B],
B [N, n, m, B], f_aff [N, n, B], the QuadraticCost's leaves, each group's
`active` [N+1, B]); a leaf without it stays shared.

The problem is `reference_problems.fleet_arrays`: B=8 planar double
integrators at tests/test_diff.py's N=10, h=0.1, each lane with its own
mass, drag and wind (A, B, f_aff), its own QuadraticCost (dense Q, nonzero
H, its own goal) and its own mask of the control bound |u| <= 2. Here A,
B and f_aff hold one row per lane and every other leaf is lane 0's,
shared. Each case runs `solve_lanes` under the default strong-Wolfe
search and the non-split grid, and `solve_tiled` (the split Armijo-only
grid, against `jax.vmap(solve)` with the tiled options: JAX's own contract
for `solve_tiled`). Statuses, iterations and ls_iterations equal lane for
lane; x and u within 1e-9. The helpers serve the other
test_torch_per_lane_*.py files.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.cones import Cone as JCone  # noqa: E402
from altro_tpu.options import SolverOptions as JOpts  # noqa: E402
from altro_tpu.problem import ConstraintSpec as JSpec  # noqa: E402
from altro_tpu.problem import Problem as JProblem  # noqa: E402
from altro_tpu.problem import QuadraticCost as JQuadraticCost  # noqa: E402
from altro_tpu.solver import init_state as jinit_state  # noqa: E402
from altro_tpu.solver import solve as jsolve  # noqa: E402
from altro_tpu_torch import reference_problems as rp  # noqa: E402
from altro_tpu_torch import rescue  # noqa: E402
from altro_tpu_torch import tile_solver as tsv  # noqa: E402
from altro_tpu_torch.options import SolverOptions  # noqa: E402
from altro_tpu_torch.parallel.batch import batch_init_state, solve_lanes  # noqa: E402

B, N = 8, 10
ARRAYS = rp.fleet_arrays(B, N=N, seed=0)
LEAVES = ("A", "B", "f_aff", "Q", "R", "H", "q", "r", "c", "h", "x0")
TILED = rp.fleet_options()[1]
SEARCHES = {
    "default": SolverOptions(),
    "grid": SolverOptions(use_backtracking_linesearch=True, parallel_linesearch=True,
                          ls_phase_split=False),
    "tiled": TILED,
}


def jopts(o):
    return JOpts(**{f.name: getattr(o, f.name) for f in dataclasses.fields(o)})


def jax_problem(a: dict, active) -> JProblem:
    """The JAX package's fleet problem from one lane's arrays."""
    spec = JSpec(fn=lambda x, u, k: jnp.concatenate([u - rp.FLEET_U_MAX, -rp.FLEET_U_MAX - u]),
                 cone=JCone.NEGATIVE_ORTHANT, dim=4, active=active, label="control_bound",
                 diag_hessian=True, affine=True)
    return JProblem(N=a["A"].shape[0], n=4, m=2, dynamics=None, dynamics_jac=None,
                    constraints=(spec,),
                    cost=JQuadraticCost(Q=a["Q"], R=a["R"], H=a["H"], q=a["q"], r=a["r"],
                                        c=a["c"]),
                    h=a["h"], x0=a["x0"], A=a["A"], B=a["B"], f_aff=a["f_aff"])


def lane(arrays, b=0) -> dict:
    """Lane b's leaves (one lane's shapes; the masks [groups, N+1])."""
    return {k: (v[:, b] if k == "active" else v[b]) for k, v in arrays.items()}


def jax_vmapped(arrays, batched, opts):
    """jax.vmap(solve) from the cold start, the leaves in `batched` (and
    x0) one row per lane, the others lane 0's; returns (state, stats)."""
    one_lane = lane(arrays)
    lanes = set(batched) | {"x0"}
    args = [jnp.asarray(arrays[k] if k in lanes else one_lane[k]) for k in LEAVES]
    act = jnp.asarray(arrays["active"][0] if "active" in lanes else one_lane["active"][0])
    axes = tuple(0 if k in lanes else None for k in LEAVES) + (
        0 if "active" in lanes else None,)

    def one(*a):
        prob = jax_problem(dict(zip(LEAVES, a[:-1])), a[-1])
        return jsolve(prob, jinit_state(prob), jopts(opts))

    return jax.jit(jax.vmap(one, in_axes=axes))(*args, act)


def port_run(arrays, batched, opts, search, rescue_opts=None):
    """The port's batched solve of the same lanes: `solve_lanes` (or
    `solve_tiled` for the "tiled" search; with `rescue_opts`, its
    two-tier rescue) from the cold start; returns (state batch-major,
    stats)."""
    prob = rp.fleet_problem(arrays, batched=batched, dtype=torch.float64, device="cpu")
    assert set(prob.lane_leaves) == {("cost." + k if k in "QRHqrc" else
                                      "constraints[0].active" if k == "active" else k)
                                     for k in batched}
    st0 = tsv.state_to_lanes(batch_init_state(dataclasses.replace(prob, x0=prob.x0[:, 0]), B))
    if rescue_opts is not None:
        st, stats = rescue.solve_tiled_with_rescue(prob, st0, opts, rescue_opts)
    elif search == "tiled":
        st, stats = tsv.solve_tiled(prob, st0, opts)
    else:
        st, stats = solve_lanes(prob, st0, opts)
    return tsv.state_from_lanes(st), stats


def assert_same(port, jx):
    (st, stats), (jst, jstats) = port, jx
    for name in ("status", "iterations", "ls_iterations"):
        np.testing.assert_array_equal(getattr(stats, name).numpy(),
                                      np.asarray(getattr(jstats, name)), err_msg=name)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.u.numpy(), np.asarray(jst.u), rtol=0, atol=1e-9)


def check(batched, search):
    opts = SEARCHES[search]
    assert_same(port_run(ARRAYS, batched, opts, search), jax_vmapped(ARRAYS, batched, opts))


@pytest.mark.parametrize("search", list(SEARCHES))
def test_per_lane_dynamics_match_jax_vmap(search):
    check(("A", "B", "f_aff"), search)
