"""The sparse and grid Taylor–Hood engines of ``tpufem.workloads.th_sparse``
(Uzawa-CG on the TH operators): not ported yet (ROADMAP Queue 1 item 9).
The dense Taylor–Hood solvers are, in :mod:`tpufem_torch.workloads.navier_stokes`.
"""

from __future__ import annotations


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (the sparse or grid Taylor–Hood engine of workloads/th_sparse.py) is not "
        "ported to tpufem_torch yet; the dense Taylor–Hood solvers are "
        "(ROADMAP Queue 1 item 9)")


class SparseTHProblem:
    @classmethod
    def build(cls, mesh, config=None):
        raise _not_ported("SparseTHProblem")


class GridTHProblem:
    @classmethod
    def build(cls, base, *args, **kwargs):
        raise _not_ported("GridTHProblem")
