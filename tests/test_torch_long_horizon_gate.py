"""The bounded N=500 solve's gate of chip_smoke.py (`draw_band`,
`band_verdict`), on objectives read after 20 iterations on an NVIDIA H100
80GB HBM3 (700 W): the plain path's 32 draws in f64 and in f32, the f32
kernels' 16, and the kernel path with its backward's d or K scaled by
0.99 over 8 draws. Pure Python; no solve runs here."""

import pytest

import chip_smoke as cs

F64_PLAIN = [3672.782, 27.077, 671.217, 20.972, 21.186, 21.946, 20.186, 1077.605, 1647.615,
             19.953, 19.925, 20.371, 20.493, 20.514, 785.372, 20.032, 20.217, 20.586, 21.197,
             20.551, 4875.742, 19.731, 1728.596, 19.918, 19.933, 19.901, 3098.855, 807.115,
             20.36, 20.06, 20.487, 2340.288]
F32_PLAIN = [20.372, 156.964, 19.914, 700.255, 20.535, 124.703, 20.491, 5229.15, 20.279,
             19.937, 20.193, 20.397, 321.31, 19.892, 19.975, 20.078, 5297.253, 20.21, 20.196,
             20.255, 20.564, 19.996, 19.434, 19.578, 563.176, 19.955, 20.922, 20.009, 110.549,
             20.492, 20.594, 20.635]
F32_KERNEL = [20.154, 20.018, 20.192, 20.44, 20.349, 19.826, 20.512, 20.322, 20.845, 20.412,
              20.011, 20.443, 20.291, 20.132, 19.973, 19.81]
CONTROL_D = [23.419, 22.162, 23.33, 23.064, 23.624, 23.494, 23.089, 8248.946]
CONTROL_K = [426.011, 657.807, 23.356, 25.18, 26.936, 23.216, 7288.183, 4502.262]
POOL = F64_PLAIN + F32_PLAIN


def test_band_ignores_outliers():
    band, q = cs.draw_band(POOL)
    assert band == pytest.approx((18.85, 22.14), abs=0.01)
    assert q == pytest.approx(45 / 64)
    # one draw moved from the mode near 20 to 1e6 moves the band by a rank
    wide, _ = cs.draw_band([1e6] + POOL[1:3] + POOL[4:])
    assert wide[1] - wide[0] < 1.2 * (band[1] - band[0])


@pytest.mark.parametrize("objs, held", [
    (F64_PLAIN, True), (F32_PLAIN, True), (F32_KERNEL, True),
    (CONTROL_D, False), (CONTROL_K, False),
    # a path whose median is in the band but which leaves it on 10 of 16
    # draws, 5 below and 5 above (chance 0.0066 at the pool's share)
    ([5.0] * 5 + F32_KERNEL[:6] + [2000.0] * 5, False),
    # and one in the band on 7 of 16 (chance 0.024): a path as often out of
    # it as that passes, since the sound plain path leaves it on 30%
    ([5.0] * 4 + F32_KERNEL[:7] + [2000.0] * 5, True),
    # and one with a non-finite draw
    (F32_KERNEL[:15] + [float("nan")], False),
], ids=["f64_plain", "f32_plain", "f32_kernel", "control_d", "control_K", "six_in_band",
        "seven_in_band", "not_finite"])
def test_band_verdict(objs, held):
    band, q = cs.draw_band(POOL)
    assert cs.band_verdict(objs, band, q)["held"] is held
