"""The PyTorch port imports without jax, and its CPU wrappers launch nothing.

Counterpart surface: the whole `altro_tpu_torch` package. Its CUDA
kernels build only on a machine with nvcc; here the build command is
checked without running it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import altro_tpu_torch
names = [m.name for m in pkgutil.walk_packages(altro_tpu_torch.__path__, "altro_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m == "altro_tpu" or m.startswith("altro_tpu.")]
assert not loaded, loaded
assert sys.modules["jax"] is None
print(len(names))
"""


def test_package_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every slice module was imported


def test_nvcc_command_targets_hopper():
    from altro_tpu_torch.ops import _build

    cmd = _build.nvcc_command("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert "--use_fast_math" not in cmd
    srcs = _build.sources()
    assert {os.path.basename(s) for s in srcs} >= {"riccati_backward.cu", "rollout_grid.cu"}
    assert all(s in cmd for s in srcs)
    # every C entry point the wrappers call has declared argument types
    assert set(_build.SIGNATURES) == {"riccati_backward_diag_f32", "rollout_grid_f32"}


def test_cpu_wrappers_do_not_count_launches():
    from altro_tpu_torch import mpc
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.ops import rollout_grid as rg

    rb.LAUNCHES = 0
    rg.LAUNCHES = 0
    rng = np.random.default_rng(0)
    N, n, m, B = 3, 4, 2, 5
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    A = t(np.eye(n)[None, :, :, None] + 0.1 * rng.standard_normal((N, n, n, B)))
    g = rb.riccati_backward(A, t(rng.standard_normal((N, n, m, B))),
                            t(np.ones((N + 1, n, B))), t(np.ones((N, m, B))),
                            t(rng.standard_normal((N + 1, n, B))),
                            t(rng.standard_normal((N, m, B))), 0.0, diag_cost=True)
    assert bool(g.ok.all())
    ref = load_scotty()
    prob = mpc.scotty_problem(ref, N=N, dtype=torch.float64)
    xr = t(np.repeat(ref.x[: N + 1, :, None], B, axis=2))
    ur = t(np.repeat(ref.u[:N, :, None], B, axis=2))
    phi, xs = rg.rollout_grid(prob, xr, ur, g.K, g.d, (t(np.zeros((N + 1, 2, B))),),
                              t(np.ones(B)), t([1.0, 0.5]), xr[0])
    assert phi.shape == (2, B) and xs.shape == (2, N + 1, n, B)
    assert rb.LAUNCHES == 0 and rg.LAUNCHES == 0


def test_kernel_wrappers_refuse_what_they_do_not_implement():
    from altro_tpu_torch import mpc
    from altro_tpu_torch.cones import Cone
    from altro_tpu_torch.io.scotty import load_scotty
    from altro_tpu_torch.ops import riccati_backward as rb
    from altro_tpu_torch.ops import rollout_grid as rg
    import dataclasses

    prob = mpc.scotty_problem(load_scotty(), N=4, dtype=torch.float64)
    assert rg.rollout_tiled_eligible(prob)
    no_cols = dataclasses.replace(prob, dynamics_cols=None)
    assert "column-form" in rg.ineligibility(no_cols)
    soc = dataclasses.replace(prob, constraints=(dataclasses.replace(
        prob.constraints[0], cone=Cone.SECOND_ORDER),))
    assert "NEGATIVE_ORTHANT" in rg.ineligibility(soc)
    nonaffine = dataclasses.replace(prob, constraints=(dataclasses.replace(
        prob.constraints[0], affine=False),))
    assert not rg.rollout_tiled_eligible(nonaffine)
    z = torch.zeros((2, 4, 4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="symmetric"):
        rb.riccati_backward(z, z[:, :, :2], z[0], z[0], z[0], z[0], 0.0, symmetrize=True)
