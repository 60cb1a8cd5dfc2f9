"""examples/learned_mpc.py's loop on the port (`learned.run_learned_mpc`:
`diff.implicit_solve` under `torch.optim.Adam`) against the example's
own functions under `optax.adam`, in f64 on the CPU: the task loss and
the weights of the first 5 steps equal JAX's to rtol 1e-8."""

import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from altro_tpu_torch.learned import build_problem, run_learned_mpc  # noqa: E402

STEPS = 5
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "learned_mpc.py")


def _example():
    spec = importlib.util.spec_from_file_location("learned_mpc_example", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_first_steps_match_optax_loop():
    ex = _example()
    theta = jnp.log(jnp.asarray([1.0, 1.0, 1.0]))
    loss_and_grad = jax.jit(jax.value_and_grad(ex.task_loss))
    opt = optax.adam(0.1)
    opt_state = opt.init(theta)
    losses, weights = [], []
    for _ in range(STEPS):
        loss, g = loss_and_grad(theta)
        losses.append(float(loss))
        weights.append(np.exp(np.asarray(theta)))
        updates, opt_state = opt.update(g, opt_state)
        theta = optax.apply_updates(theta, updates)
    losses.append(float(loss_and_grad(theta)[0]))
    weights.append(np.exp(np.asarray(theta)))

    res = run_learned_mpc(steps=STEPS, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(res.losses.numpy(), losses, rtol=1e-8)
    np.testing.assert_allclose(res.weights.numpy(), np.stack(weights), rtol=1e-8)
    assert len(res.seconds) == STEPS and all(s > 0 for s in res.seconds)


def test_build_problem_matches_example():
    """The port's controller problem has the example's data leaves."""
    ex = _example()
    logw = np.log([2.0, 0.5, 0.1])
    jp = ex.build_problem(jnp.asarray(logw))
    tp = build_problem(torch.tensor(logw, dtype=torch.float64))
    for name in ("Q", "R", "q", "r", "c"):
        np.testing.assert_allclose(getattr(tp.cost, name).numpy(),
                                   np.asarray(getattr(jp.cost, name)), rtol=1e-15)
    np.testing.assert_array_equal(tp.h.numpy(), np.asarray(jp.h))
    np.testing.assert_array_equal(tp.x0.numpy(), np.asarray(jp.x0))
    assert (tp.N, tp.n, tp.m) == (jp.N, jp.n, jp.m)
