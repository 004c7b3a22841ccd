"""The frozen kernel counts, pinned to the bounds the program's measurements
have carried since PR 14 at the suite's shapes."""

import pytest

from portbench import counts

CART = counts.plant("cartpole_swingup")


@pytest.mark.parametrize("work, ms, bound", [
    (counts.mppi_work(CART, 10240, 64, 50), 0.0367, "operations"),
    (counts.cem_work(CART, 10240, 64, 50, 8, 3), 0.1077, "operations"),
    (counts.rollout_work(CART, 655360, 50), 0.0430, "bytes"),
], ids=["kernel1", "kernel3", "kernel2"])
def test_least_time_at_the_suite_shapes(work, ms, bound):
    seconds, by = counts.least_time_s(work)
    assert by == bound
    assert seconds * 1e3 == pytest.approx(ms, rel=2e-3)


def test_work_scales_with_the_batch():
    assert counts.mppi_work(CART, 40960, 64, 50)[1] == 4 * counts.mppi_work(CART, 10240, 64, 50)[1]
