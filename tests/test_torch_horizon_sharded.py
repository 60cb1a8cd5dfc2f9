"""The port's horizon-split Riccati backward pass (`parallel/horizon.py`)
on gloo worlds of CPU processes against JAX's on the suite's 8 virtual
devices, in float64 on identical numpy inputs (tests/test_horizon_sharded.py's
cases): a world of 8 at N=15 against `tvlqr_backward_horizon_sharded` and
the serial pass, its divisibility check, and the batch x horizon form on
a (2, 2) world of 4 against JAX's 2-D form (a 2 x 4 mesh; the split does
not change the answer). Every rank returns the whole gains, which must
agree with each other and with JAX's to 1e-9 (delta_V 1e-8 relative).
The workers live in tests/test_torch_dist_workers.py (no jax there).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

dw = pytest.importorskip("test_torch_dist_workers")
pr = pytest.importorskip("test_parallel_riccati")

FIELDS = ("K", "d", "P", "p")


def _assert_gains(got, want, N):
    for name in FIELDS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(got["delta_V"].numpy(), np.asarray(want.delta_V), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(want.ok))
    np.testing.assert_array_equal(got["fail_index"].numpy(), np.asarray(want.fail_index))
    assert np.all(np.asarray(want.fail_index) == N)


def test_world_of_8_matches_jax_and_refuses_an_indivisible_horizon(tmp_path):
    from altro_tpu.parallel.horizon import tvlqr_backward_horizon_sharded as jsharded
    from altro_tpu.parallel.mesh import make_mesh as jmake_mesh
    from altro_tpu.tvlqr import tvlqr_backward as jserial

    N = 15  # N + 1 divisible by 8
    args = pr.random_lqr(N, n=4, m=2, seed=N)
    bad = pr.random_lqr(10, n=4, m=2, seed=1)
    res = dw.run_world(dw.horizon_worker, 8, tmp_path, [np.asarray(a) for a in args], (8,),
                       [np.asarray(a) for a in bad])
    want = jsharded(*args, mesh=jmake_mesh(8, axis="horizon"))
    serial = jserial(*args)
    for r in res:
        _assert_gains(r["gains"], want, N)
        _assert_gains(r["gains"], serial, N)
        # JAX's message: (N+1)=11 is not divisible by the axis size
        assert r["error"] == "(N+1)=11 must be divisible by mesh axis size 8"


def test_batch_horizon_world_of_4_matches_jax_2d_form(tmp_path):
    from jax.sharding import Mesh

    from altro_tpu.parallel.horizon import tvlqr_backward_batch_horizon_sharded as jsharded2
    from altro_tpu.tvlqr import tvlqr_backward as jserial

    N, Bsz = 15, 6
    batched = [jnp.stack(a) for a in zip(*[pr.random_lqr(N, n=4, m=2, seed=100 + i)
                                           for i in range(Bsz)])]
    res = dw.run_world(dw.horizon_worker, 4, tmp_path, [np.asarray(a) for a in batched], (2, 2))
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("batch", "horizon"))
    want = jsharded2(*batched, mesh=mesh)
    serial = jax.vmap(lambda *a: jserial(*a))(*batched)
    for r in res:
        _assert_gains(r["gains"], want, N)
        _assert_gains(r["gains"], serial, N)
