"""The (3, 2) plain backward against the packed Pallas kernel in interpret
mode (f32), the variants with a dense lxx: test_torch_latency_backward_
3x2.py's `check_packed` (its module docstring)."""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from test_torch_latency_backward_3x2 import IDS, VARIANTS, check_packed  # noqa: E402

CASES = [(v, i) for v, i in zip(VARIANTS, IDS) if v[0] is False]


@pytest.mark.parametrize("diag_x,diag_u,with_lux,with_f", [v for v, _ in CASES],
                         ids=[i for _, i in CASES])
def test_plain_matches_pallas_packed_interpret_f32_3x2(diag_x, diag_u, with_lux, with_f):
    check_packed(diag_x, diag_u, with_lux, with_f)
