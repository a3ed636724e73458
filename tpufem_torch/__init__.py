"""tpufem_torch: the PyTorch/CUDA port of tpufem, for NVIDIA Hopper.

The JAX package ``tpufem`` is the reference; this package mirrors its
layout and names.  It covers the squirmer Stokes step in its dense and
scale regimes (on any mesh: ``gridify_mesh`` renumbers one for the grid
kernels) with tracer and dye transport, the Navier–Stokes workload with
the dense Taylor–Hood solvers, the sparse and grid Taylor–Hood engines
(``workloads.th_sparse``; ``p2_refine`` makes their P2 meshes),
Poisson, heat and the small workloads, and the space-sharded grid path on
a device mesh (``tpufem_torch.parallel``); the TPU kernels on those paths
are hand-written CUDA kernels (``csrc/``).  The support modules mirror
tpufem's: ``diag`` (the reference's Tests A–J and run guards),
``convergence`` (accuracy ladders), ``roofline`` (the grid kernels against
the card's byte bound), ``viz`` (host-side matplotlib), ``gallery`` (the
reference's figures and the 409,600-node dye movie, computed on the device
and rendered on the host) and the CLI, ``python -m tpufem_torch``.

Quick start::

    from tpufem_torch import generate_annulus_mesh
    from tpufem_torch.workloads import stokes
    mesh = generate_annulus_mesh(n_side=33, n_circle=48)
    cfg = stokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers",
                              solver="inverse", precision="f32",
                              pressure_mode="merge", fused=True,
                              matvec_impl="pallas")
    problem = stokes.StokesProblem.build(mesh, cfg, device="cuda")
    state, metrics = stokes.run(problem, steps=1000)
"""

from tpufem_torch.mesh import Mesh, generate_annulus_mesh, load_mesh, mesh_from_arrays
from tpufem_torch.mesh.gridify import Gridified, gridify_mesh
from tpufem_torch.mesh.p2 import p2_refine
from tpufem_torch import ops, bc, solve, transport, diag

__all__ = ["Mesh", "generate_annulus_mesh", "load_mesh", "mesh_from_arrays", "Gridified",
           "gridify_mesh", "p2_refine", "ops", "bc", "solve", "transport", "diag"]
