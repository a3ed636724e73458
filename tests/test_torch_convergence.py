"""tpufem_torch.convergence against tpufem.convergence on toy ladders: the
probe set array-equal, and the self and NS studies' rows with equal
n_nodes, h, dt and steps, and err_vs_finest and div_rel within 1e-3
relative (both packages run f32 steps, so not bit for bit).
``check=False``: the monotone gates need the real ladders.  The Taylor–Hood
study is in test_torch_convergence_th.py."""

import numpy as np
import pytest
import torch

from tpufem import convergence as jconv
from tpufem_torch import convergence as tconv

torch.set_num_threads(2)

EXACT = ("label", "n_nodes", "h", "dt", "steps")
RTOL = 1e-3


def assert_rows_match(got: list, want: list, keys: tuple) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in EXACT} == {k: w[k] for k in EXACT}
        for k in keys:
            assert abs(g[k] - w[k]) <= RTOL * abs(w[k]) + 1e-6, (k, g[k], w[k])


@pytest.mark.parametrize("n", [200, 1600])
def test_probe_points_array_equal(n):
    np.testing.assert_array_equal(tconv.probe_points(n), jconv.probe_points(n))


def test_self_study_toy_matches_tpufem():
    sizes = [("a", 24, 24), ("b", 32, 32)]
    want = jconv.run_self(sizes=sizes, steps0=20, check=False)
    got = tconv.run_self(sizes=sizes, steps0=20, check=False, device="cpu")
    assert_rows_match(got, want, ("err_vs_finest", "div_rel", "final_div_max", "max_u"))
    assert got[0]["err_vs_finest"] > got[1]["err_vs_finest"] == 0.0


def test_ns_study_toy_matches_tpufem():
    sizes = [("a", 16, 16), ("b", 24, 24)]
    want = jconv.run_ns_conv(sizes=sizes, steps0=20, check=False)
    got = tconv.run_ns_conv(sizes=sizes, steps0=20, check=False, device="cpu")
    assert_rows_match(got, want, ("err_vs_finest", "div_rel", "max_u"))


def test_monotone_gate_raises():
    rows = [{"e": 0.3}, {"e": 0.2}, {"e": 0.25}]
    tconv._check_decreasing(rows[:2], "e", "toy")
    with pytest.raises(AssertionError, match="not decreasing"):
        tconv._check_decreasing(rows, "e", "toy")
