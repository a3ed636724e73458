"""The benchmark's frozen peaks and operation counts.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its full 700 W (the
card's power limit is printed beside every run): 3.35 TB/s of HBM, 67
TFLOP/s in float32 outside the tensor cores.

K3 is the pressure solve: two-level preconditioned CG on the merged
periodic pressure stiffness K̃ of the mesh.  Its least time counts what
the textbook algorithm needs for the inputs it is given, never what the
program's kernel does:

* bytes, once a solve: K̃'s values (its CSR nonzeros on the mesh), the
  right-hand side, the warm start and the solution at the field's width,
  and the coarse inverse at the coarse dtype's width;
* flops, each iteration: one product with K̃ for the search direction and
  two in the preconditioner (2·nnz each), the coarse product (2·C²), and
  28 flops a node for the smoothing, restriction, prolongation, the two
  mean projections, the two dot products and the three updates.

The coarse space has the configuration's ``cg_coarse_nodes``, at most 1024
(K3 aggregates the grid into at most 32 × 32 blocks: counting more would
count work the program never does).
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
K3_KERNELS = ("pressure_cg_kernel", "pressure_pb16_kernel", "pressure_nofma_kernel",
              "pressure_nodma_kernel")
_WIDTH = {"f64": 8, "f32": 4, "bf16": 2}
FLOPS_PER_NODE = 28


def merged_nnz(tris: np.ndarray, n: int, owner: np.ndarray) -> int:
    """Nonzeros of the stiffness with every slave merged into its master:
    the distinct (owner[i], owner[j]) pairs over the triangles' corners."""
    t = owner[np.asarray(tris, dtype=np.int64)]
    rows = np.repeat(t, 3, axis=1).reshape(-1)
    cols = np.tile(t, (1, 3)).reshape(-1)
    return int(len(np.unique(rows * n + cols)))


def k3_counts(n: int, nnz: int, stokes: dict) -> dict:
    """{bytes_per_solve, flops_per_iter} of one K3 solve."""
    field = _WIDTH[stokes["precision"]]
    coarse_w = 2 if stokes["cg_coarse_dtype"] == "bf16" else field
    coarse = min(int(stokes["cg_coarse_nodes"]), 1024) if stokes["cg_precond"] == "twolevel" else 0
    return {
        "bytes_per_solve": nnz * field + 3 * n * field + coarse * coarse * coarse_w,
        "flops_per_iter": 6 * nnz + 2 * coarse * coarse + FLOPS_PER_NODE * n,
    }


def k3_least_s(counts: dict, solves: int, iters: int) -> float:
    """Least seconds of ``solves`` K3 solves that took ``iters`` iterations in all."""
    return max(solves * counts["bytes_per_solve"] / PEAK_BYTES_S,
               iters * counts["flops_per_iter"] / PEAK_FLOPS_F32)


def for_mesh(mesh, stokes: dict) -> dict:
    """The cell's counts: K3's, from the mesh's own pressure operator."""
    from portbench.reference import fem

    coords, tris, markers = mesh
    n = len(coords)
    _, _, masters, slaves = fem.boundary_sets(coords, markers, stokes)
    owner = np.arange(n)
    owner[slaves] = masters
    return {"k3": k3_counts(n, merged_nnz(tris, n, owner), stokes)}
