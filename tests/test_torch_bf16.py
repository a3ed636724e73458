"""``precision="bf16"`` in the Stokes workload against tpufem's, on the CPU.

tpufem's bf16 run is bounded only on the fused dense step with the XLA
matvec; the port runs that path (``torch.addmv`` in bf16) and refuses the
others with a ``ValueError`` naming tpufem's behaviour there.  Measured on
``generate_annulus_mesh(12, 16)`` (default dt 0.05, B1 = −2), 10 steps:
max|u| 2.0 in both packages; the port's u 3.6e-3 from tpufem's f64 run in
relative L2 (tpufem's bf16 3.7e-3; held at 1e-2) and 1.4e-3 from tpufem's
bf16 run (held at 5e-3): XLA rounds M·x to bf16 before adding b, addmv
once.  After one step the two bf16 runs are bit-equal.
"""

import numpy as np
import pytest
import torch

from tpufem.workloads import stokes as jstokes
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import meshes, rel

torch.set_num_threads(2)

FUSED = dict(solver="inverse", pressure_mode="merge", fused=True)
STEPS = 10


def test_bf16_fused_matches_tpufem_and_f64():
    jm, tm = meshes(12, 16)
    want64, _ = jstokes.run(jstokes.StokesProblem.build(jm, jstokes.StokesConfig(**FUSED)),
                            steps=STEPS)
    want16, _ = jstokes.run(jstokes.StokesProblem.build(
        jm, jstokes.StokesConfig(precision="bf16", **FUSED)), steps=STEPS)
    problem = tstokes.StokesProblem.build(tm, tstokes.StokesConfig(precision="bf16", **FUSED),
                                          device="cpu")
    assert problem.fused_M.dtype == torch.bfloat16
    state, metrics = tstokes.run(problem, steps=STEPS)
    u = state["u"]
    assert u.dtype == torch.bfloat16
    u = u.double().numpy()
    # tpufem's physics gate: max|u| < 1.25·(|B1| + |B2|)
    assert np.abs(u).max() < 1.25 * 2.0
    assert metrics["max_u"].dtype == torch.bfloat16
    assert rel(u, np.asarray(want64["u"])) < 1e-2
    assert rel(u, np.asarray(want16["u"]).astype(np.float64)) < 5e-3
    one, _ = tstokes.run(problem, steps=1)
    want1, _ = jstokes.run(jstokes.StokesProblem.build(
        jm, jstokes.StokesConfig(precision="bf16", **FUSED)), steps=1)
    np.testing.assert_array_equal(one["u"].double().numpy(),
                                  np.asarray(want1["u"]).astype(np.float64))


@pytest.mark.parametrize("kw,match", [
    (dict(solver="inverse", pressure_mode="merge"), "8.5e19"),  # unfused: blows up in tpufem
    (dict(solver="cg", cg_storage="csr"), "508"),  # tpufem's CSR CG blows up
    (dict(solver="cg", cg_storage="grid_interpret"), "TypeError"),  # tpufem's grid raises
    (dict(FUSED, matvec_impl="pallas"), "no bf16 instance"),  # K1, and tpufem's Pallas
    (dict(FUSED, transport="tracers"), "below 256"),  # ids as bf16 floats
], ids=["unfused", "csr-cg", "grid", "pallas", "tracers"])
def test_bf16_refused_where_tpufem_is_unbounded(kw, match):
    _, tm = meshes(12, 16)
    with pytest.raises(ValueError, match=match):
        tstokes.StokesProblem.build(tm, tstokes.StokesConfig(precision="bf16", **kw),
                                    device="cpu")
