"""The exported tick under `non_split_grid`, 3 closed-loop ticks against JAX's live
`mpc_step` and the port's in f64 on the CPU (test_torch_export_options.py
names the cases and their options)."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_export_options import run_case  # noqa: E402


@pytest.mark.parametrize("name", ["non_split_grid"])
def test_option_artifact_matches_live_solvers(name):
    run_case(name)
