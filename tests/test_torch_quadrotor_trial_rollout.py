"""The single-lane trial-grid rollout on the quadrotor's rk4 block step
against altro_tpu.

The plain version (ops/trial_rollout.py::trial_rollout_ref, what
`trial_rollout` runs on CPU tensors) with `rk4_tile(quadrotor_tile())`
against the JAX portable scan `ops/pallas_rollout._scan_rollout` in f64
(W=8, N=30, rtol 1e-10) and against the packed Pallas kernel
`_pallas_rollout(interpret=True)` in f32 at N=12 (phi and states to 1e-5
of their scale). P = 0: the quadrotor rows have no constraint. The
three-lanes-a-trial kernel of csrc/trial_rollout.cu is held against the
plain version on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu.models.tile_steps import quadrotor_tile as jquad_tile  # noqa: E402
from altro_tpu.models.tile_steps import rk4_tile as jrk4_tile  # noqa: E402
from altro_tpu.ops.pallas_rollout import _pallas_rollout, _scan_rollout  # noqa: E402
from altro_tpu_torch import mpc  # noqa: E402
from altro_tpu_torch.models.tile_steps import quadrotor_tile, rk4_tile  # noqa: E402
from altro_tpu_torch.ops import trial_rollout as tr  # noqa: E402

n, m, W = 12, 4, 8


def _inputs(N, seed):
    """Operands of the waypoint problem's grid around hover: the reference
    a slow climb, small gains and steps (as the solve gives them)."""
    rng = np.random.default_rng(seed)
    prob = mpc.quadrotor_waypoint_problem(N=N, dtype=torch.float64, device="cpu")
    c = prob.cost
    xref = 0.05 * rng.standard_normal((N + 1, n))
    xref[:, 2] += np.linspace(0.0, 0.5, N + 1)
    uref = mpc.QUAD_HOVER + 0.01 * rng.standard_normal((N, m))
    K = 0.05 * rng.standard_normal((N, m, n))
    d = 0.05 * rng.standard_normal((N, m))
    x0 = xref[0] + 0.02 * rng.standard_normal(n)
    return dict(alphas=0.5 ** np.arange(W), x0=x0, xref=xref, uref=uref, K=K, d=d,
                Qd=c.Q.numpy(), ql=c.q.numpy(), Rd=c.R.numpy(), rl=c.r.numpy(),
                cconst=c.c.numpy(), h=prob.h.numpy())


def test_plain_matches_jax_scan_f64():
    ops = _inputs(30, 0)
    phi_j, xs_j = _scan_rollout(jrk4_tile(jquad_tile()),
                                *(jnp.asarray(v, jnp.float64) for v in ops.values()))
    args = tuple(torch.as_tensor(np.asarray(v), dtype=torch.float64) for v in ops.values())
    before = tr.LAUNCHES
    phi, xs = tr.trial_rollout(rk4_tile(quadrotor_tile()), *args)
    assert tr.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert phi.shape == (W,) and xs.shape == (W, 31, n)
    assert float(np.abs(np.asarray(xs_j)).max()) > 0.3
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_j), rtol=1e-10)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=1e-10, atol=1e-12)


def test_plain_matches_pallas_kernel_interpret_f32():
    ops = _inputs(12, 1)
    phi_k, xs_k = _pallas_rollout(jrk4_tile(jquad_tile()),
                                  *(jnp.asarray(v, jnp.float32) for v in ops.values()),
                                  interpret=True)
    args = tuple(torch.as_tensor(np.asarray(v), dtype=torch.float32) for v in ops.values())
    phi, xs = tr.trial_rollout(rk4_tile(quadrotor_tile()), *args)
    scale = max(float(np.abs(np.asarray(phi_k)).max()), 1.0)
    assert float(np.abs(phi.numpy() - np.asarray(phi_k)).max()) < 1e-5 * scale
    xscale = max(float(np.abs(np.asarray(xs_k)).max()), 1.0)
    assert float(np.abs(xs.numpy() - np.asarray(xs_k)).max()) < 1e-5 * xscale
