"""The Taylor–Hood convergence study past the dense ceiling: with
``DENSE_TH_DOF_CEIL`` lowered between the two toy rungs (as
tests/test_convergence.py lowers it), the first rung takes the dense
reference and the second ``th_sparse.steady_solve``; the port's rows
against tpufem's (equal sizes and steps, err within 1e-3 relative)."""

import torch

from tpufem import convergence as jconv
from tpufem_torch import convergence as tconv

from tests.test_torch_convergence import assert_rows_match

torch.set_num_threads(2)


def test_th_study_toy_both_references_match_tpufem(monkeypatch):
    sizes = [("a", 12, 16), ("b", 16, 16)]  # 1,032 and 1,756 dofs
    for module in (jconv, tconv):
        monkeypatch.setattr(module, "DENSE_TH_DOF_CEIL", 1500)
    want = jconv.run_th(sizes=sizes, steps0=20, check=False)
    got = tconv.run_th(sizes=sizes, steps0=20, check=False, device="cpu")
    assert_rows_match(got, want, ("err_vs_taylor_hood",))
