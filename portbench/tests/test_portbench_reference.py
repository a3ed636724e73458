"""The plain reference against the program at tiny sizes on the CPU, and the
yardstick's counts on meshes small enough to count by hand."""

import json

import numpy as np
import pytest
import torch
import tiny

from portbench import starts, yardstick
from portbench.steppers import stokes as stokes_steps
from portbench.reference import advect, fem, mesh as ref_mesh
from portbench.reference import step as ref_step


@pytest.mark.parametrize("size", [(14, 16, True), (20, 24, True), (24, 28, False)])
def test_frozen_generator_equals_the_programs(size):
    from tpufem_torch.mesh import generate_annulus_mesh

    n_side, n_circle, pad = size
    mine = ref_mesh.annulus(n_side, n_circle, pad_hole=pad)
    theirs = generate_annulus_mesh(n_side, n_circle, pad_hole=pad)
    for a, b in zip(mine, (theirs.coords, theirs.tris, theirs.markers)):
        np.testing.assert_array_equal(a, b)


def _pair(name: str, steps: int):
    """(the program's state, the reference's) after ``steps`` steps of the
    configuration ``name`` at float64 and converged solves, on a 24 × 24
    annulus, from one seeded start of the cell's traffic."""
    from tpufem_torch.workloads import stokes

    conf = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    conf["stokes"].update(precision="f64", cg_tol_pressure=1e-13, cg_iters_pressure=3000,
                          cg_tol_visc=1e-13, cg_iters_visc=3000)
    mesh = ref_mesh.annulus(24, 28, pad_hole=True)
    traffic = {"starts": 1, "velocity": {"amplitude": 0.1, "modes": [[1, 1], [2, 1]]},
               "dye": {"offset": 0.1} if conf["stokes"]["transport"] == "dye" else None}
    start = starts.make(mesh, conf["stokes"], traffic, 3)[0]
    program = stokes_steps.Program(mesh, conf, "cpu")
    assert program.problem.dtype == torch.float64
    st = program.start(torch.as_tensor(start["u"]),
                       torch.as_tensor(start["c"]) if "c" in start else None)
    st, metrics = stokes.run(program.problem, steps=steps, state=st)
    pb = fem.build(*mesh, stokes_steps.stokes_fields(conf))
    loc = advect.Locator(mesh[0], mesh[1], pb.tri_valid) if "c" in start else None
    ref = ref_step.Stokes(pb, locator=loc)
    return st, metrics, ref, ref.advance(ref.start(start["u"], start.get("c")), steps)


def test_reference_flow_equals_the_programs_csr_path():
    st, _, _, r = _pair("stokes_1m", 4)
    assert float(torch.max(torch.abs(st["u"] - r["u"]))) < 1e-10


def test_reference_dye_and_mixing_equal_the_programs_csr_path():
    st, metrics, ref, r = _pair("dye_410k", 4)
    assert float(torch.max(torch.abs(st["u"] - r["u"]))) < 1e-10
    assert float(torch.max(torch.abs(st["c"] - r["c"]))) < 1e-10
    assert abs(float(metrics["mixing_var"][-1]) - float(ref.mixing_var(r["c"]))) < 1e-12


def test_pcg_raises_when_it_cannot_converge():
    A = torch.tensor([[2.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    with pytest.raises(ref_step.NotConverged):
        ref_step.pcg(lambda v: A @ v, torch.ones(2, dtype=torch.float64), lambda r: r,
                     torch.zeros(2, dtype=torch.float64), 1e-14, 0)


def test_merged_nnz_by_hand():
    # two triangles on a unit square, nodes 0..3: every pair is coupled but 1–3
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    assert yardstick.merged_nnz(tris, 4, np.arange(4)) == 14
    # merging node 3 into node 0: nodes 0, 1, 2 all coupled
    assert yardstick.merged_nnz(tris, 4, np.array([0, 1, 2, 0])) == 9


def test_k3_counts_by_hand():
    cfg = {"precision": "f32", "cg_coarse_dtype": "bf16", "cg_coarse_nodes": 2048,
           "cg_precond": "twolevel"}
    c = yardstick.k3_counts(n=100, nnz=700, stokes=cfg)
    assert c["bytes_per_solve"] == 700 * 4 + 3 * 100 * 4 + 1024 * 1024 * 2
    assert c["flops_per_iter"] == 6 * 700 + 2 * 1024 * 1024 + 28 * 100
    # 10 solves read 10 × the bytes; 50 iterations do 50 × the flops
    least = yardstick.k3_least_s(c, 10, 50)
    assert least == max(10 * c["bytes_per_solve"] / 3.35e12, 50 * c["flops_per_iter"] / 67e12)
    jacobi = yardstick.k3_counts(100, 700, dict(cfg, cg_precond="jacobi"))
    assert jacobi["bytes_per_solve"] == 700 * 4 + 1200


def test_k3_counts_of_a_mesh():
    """On a 14 × 14 annulus: K̃'s nonzeros counted by scipy over the
    triangles with each slave renamed to its master."""
    import scipy.sparse as sp

    conf = json.loads((tiny.BENCH / "configs" / "stokes_1m.json").read_text())["stokes"]
    coords, tris, markers = mesh = ref_mesh.annulus(14, 16, pad_hole=True)
    _, _, masters, slaves = fem.boundary_sets(coords, markers, conf)
    assert len(masters) == 12  # the 14 nodes a side but the two wall corners
    owner = np.arange(196)
    owner[slaves] = masters
    t = owner[tris]
    rows, cols = np.repeat(t, 3, axis=1).ravel(), np.tile(t, (1, 3)).ravel()
    nnz = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(196, 196)).tocsr().nnz
    counts = yardstick.for_mesh(mesh, conf)["k3"]
    assert counts["bytes_per_solve"] == nnz * 4 + 3 * 196 * 4 + 1024 * 1024 * 2
    assert counts["flops_per_iter"] == 6 * nnz + 2 * 1024 * 1024 + 28 * 196
