"""tpufem_torch.roofline: the Hopper byte model against a hand count on a
small operator and on each sparse storage's apply (the one source of the
kernels' bounds), and
the measuring machinery through the kernels' plain versions on the CPU,
which must give finite, self-consistent rows (times and rates mean
something only on the card)."""

import math
import types

import numpy as np
import pytest
import torch

from tpufem_torch import roofline

torch.set_num_threads(2)

HBM = 3.35e12


def small_operator(n_off: int = 5, ns: int = 20, n_rest: int = 7, dtype=torch.float32):
    return types.SimpleNamespace(n=ns * ns, ns=ns, offsets=tuple(range(n_off)), n_rest=n_rest,
                                 diags=torch.zeros((n_off, ns, ns), dtype=dtype))


def test_bounds_match_a_hand_count():
    K = small_operator()
    op = (5 * 400 + 3 * 7) * 4  # planes and remainder (values, sources, targets)
    ac = torch.zeros((64, 64), dtype=torch.bfloat16)
    want = {("K3", 1): 3 * op + 17 * 400 * 4 + 64 * 64 * 2,
            ("K2", 2): op + 23 * 400 * 4,
            ("K4", 2): 2 * op + 39 * 400 * 4}
    for (kernel, cols), nbytes in want.items():
        a = ac if kernel == "K3" else None
        assert roofline.iteration_bytes(kernel, K, cols, a) == nbytes
        assert roofline.iteration_bound(kernel, K, cols, a) == nbytes / HBM * 1e3
    assert roofline.iteration_bytes("K2", K, 2, passes=11) == op + 11 * 400 * 4
    # a whole K3 solve of 10 iterations: inputs once, against its flops
    got = roofline.solve_bound("K3", K, 1, 10, ac)
    nbytes = op + 5 * 400 * 4 + 64 * 64 * 2
    flops = 11 * ((3 * 2 * 5 + 30) * 400 + 2 * 64 * 64)
    assert got["bound_ms"] == max(nbytes / HBM * 1e3, flops / 67e12 * 1e3)
    assert got["bound_by"] == "bytes"
    assert roofline.solve_bound("K2", K, 2, 10) == roofline.bound(
        op + 8 * 400 * 4, 11 * 2 * (2 * 5 + 21) * 400)
    assert roofline.bound(0.0, 67e12)["bound_by"] == "operations"


def test_bf16_preconditioner_planes_match_a_hand_count():
    """K3 under precond_bf16: the CG's apply reads K's f32 planes, the
    preconditioner's two applies K̃'s bf16 planes and its remainder at the
    field's width; a whole solve reads both operators once."""
    K = small_operator()
    K_pre = small_operator(n_rest=9, dtype=torch.bfloat16)
    op = (5 * 400 + 3 * 7) * 4
    pre = 5 * 400 * 2 + 3 * 9 * 4
    ac = torch.zeros((64, 64), dtype=torch.bfloat16)
    nbytes = op + 2 * pre + 17 * 400 * 4 + 64 * 64 * 2
    assert roofline.iteration_bytes("K3", K, 1, ac, K_pre=K_pre) == nbytes
    assert roofline.iteration_bound("K3", K, 1, ac, K_pre=K_pre) == nbytes / HBM * 1e3
    assert (roofline.iteration_bytes("K3", K, 1, ac)
            - roofline.iteration_bytes("K3", K, 1, ac, K_pre=K_pre)) == 2 * (op - pre)
    got = roofline.solve_bound("K3", K, 1, 10, ac, K_pre=K_pre)
    flops = 11 * ((3 * 2 * 5 + 30) * 400 + 2 * 64 * 64)
    assert got == roofline.bound(op + pre + 5 * 400 * 4 + 64 * 64 * 2, flops)


@pytest.mark.parametrize("storage", ["csr", "stencil", "banded", "grid"])
def test_apply_bound_matches_a_hand_count(storage):
    """One apply of each storage (f32, two columns): x and y once, the
    stored values once, the index arrays it reads (int64; the grid
    remainder's three int32), two operations a value and column."""
    from tpufem_torch.mesh.generate import generate_annulus_mesh
    from tpufem_torch.ops import assembly
    from tpufem_torch.ops.banded import BandedOperator
    from tpufem_torch.ops.gridop import GridOperator
    from tpufem_torch.ops.stencil import StencilOperator

    mesh = generate_annulus_mesh(12, 16, pad_hole=True)
    n = mesh.n_nodes
    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh)).astype(torch.float32)
    op = {"csr": lambda: K, "stencil": lambda: StencilOperator.build(K, device="cpu"),
          "banded": lambda: BandedOperator.build(K, device="cpu"),
          "grid": lambda: GridOperator.dense_split(K, 12, device="cpu")}[storage]()
    vectors = 2 * n * 4 * 2
    if storage == "csr":
        stored, extra = len(K.indices), 16 * len(K.indices)
    elif storage == "banded":
        stored, extra = op.diags.numel(), 16 * n
    else:
        stored = op.diags.numel() + op.n_rest
        extra = op.n_rest * (16 if storage == "stencil" else 12)
    assert roofline.apply_bytes(op, cols=2) == stored * 4 + extra + vectors
    assert roofline.apply_flops(op, cols=2) == 2 * stored * 2
    assert roofline.apply_bound(op, cols=2) == roofline.bound(stored * 4 + extra + vectors,
                                                             4 * stored)


@pytest.fixture(scope="module")
def toy_row():
    return roofline.measure(28, 32, iters_p=8, iters_v=4, reps=1, label="toy",
                            storage="grid_interpret", device="cpu")


def test_measure_toy_rows_are_self_consistent(toy_row):
    r = toy_row
    assert r["label"] == "toy" and r["n_nodes"] == 28 * 28 and r["device"] == "cpu"
    assert r["iters_p"] == 8 and r["iters_v"] == 4 and r["itemsize"] == 4
    assert r["n_off_p"] >= 5 and r["n_off_v"] >= 5
    for k in ("t_pressure_s", "t_viscous_s", "gbps_pressure", "gbps_viscous",
              "pct_bound_pressure", "pct_bound_viscous", "build_s"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert r["us_per_p_iter"] == pytest.approx(r["t_pressure_s"] / 8 * 1e6)
    assert r["us_per_v_iter"] == pytest.approx(r["t_viscous_s"] / 4 * 1e6)
    assert r["gbps_pressure"] == pytest.approx(r["bytes_per_p_iter"] / r["us_per_p_iter"] * 1e-3)
    assert r["pct_bound_viscous"] == pytest.approx(100 * r["bound_us_v"] / r["us_per_v_iter"])
    assert r["bound_us_p"] == pytest.approx(r["bytes_per_p_iter"] / HBM * 1e6)


def test_ab_rows_one_per_knob():
    knobs = [{}, {"cg_coarse_dtype": "same"}]
    rows = roofline.ab(28, 32, knobs, iters_p=4, iters_v=2, reps=1, storage="grid_interpret",
                       device="cpu")
    assert [r["knobs"] for r in rows] == knobs
    assert all(np.isfinite(r["us_per_p_iter"]) and r["reps"] == 1 for r in rows)
    # the bench's bf16 coarse inverse (m × m) against one in the field's
    # f32: two bytes an entry more
    diff = int(rows[1]["bytes_per_p_iter"] - rows[0]["bytes_per_p_iter"])
    m = math.isqrt(diff // 2)
    assert m > 0 and 2 * m * m == diff


def test_measure_refuses_a_problem_off_the_grid_storage():
    with pytest.raises(ValueError, match="grid storage"):
        roofline.measure(12, 16, iters_p=2, iters_v=2, reps=1, storage="csr", device="cpu")


def test_probes_rows_have_tpufems_keys():
    rows = roofline.probes(28, 32, iters_p=3, reps=1, label="toy", storage="grid_interpret",
                           device="cpu")
    assert [r["probe"] for r in rows] == ["real", "nofma", "nodma", "exchange"]
    for r in rows:
        assert set(r) == {"label", "n_nodes", "ns", "probe", "iters_p", "reps", "t_pressure_s",
                          "us_per_p_iter"}
        assert r["label"] == "toy" and r["n_nodes"] == r["ns"] ** 2 == 28 * 28
        assert r["iters_p"] == 3 and r["reps"] == 1 and r["t_pressure_s"] > 0
        assert r["us_per_p_iter"] == pytest.approx(r["t_pressure_s"] / 3 * 1e6)


def test_ab_takes_the_bf16_preconditioner_planes():
    """``{"cg_precond_bf16": "on"}`` in the streamed regime: the two
    preconditioner applies read bf16 planes, two bytes an entry fewer each."""
    knobs = [{"cg_stream_diags": "on"}, {"cg_stream_diags": "on", "cg_precond_bf16": "on"}]
    rows = roofline.ab(28, 32, knobs, iters_p=4, iters_v=2, reps=1, storage="grid_interpret",
                       device="cpu")
    assert rows[0]["n_off_p"] == rows[1]["n_off_p"]
    diff = rows[0]["bytes_per_p_iter"] - rows[1]["bytes_per_p_iter"]
    assert diff == 2 * rows[0]["n_off_p"] * 28 * 28 * 2
