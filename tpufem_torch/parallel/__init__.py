"""Sharded execution on a single-controller device mesh (see ``spmd``): the
ensembles (a batch of simulations over ("data", "space")), the
space-sharded grid solvers and Stokes step, the ring halo kernel K6, the
distributed CSR viscous CG, and the halo-exchange CG over banded and
stencil storage."""

from tpufem_torch.parallel.dist_cg import make_sharded_viscous_solver
from tpufem_torch.parallel.grid_remote_dma import halo_rdma, halo_rdma_ref, make_halo_rdma
from tpufem_torch.parallel.grid_sharded import make_sharded_grid_solvers
from tpufem_torch.parallel.halo import make_halo_pressure_solver, make_halo_viscous_solver
from tpufem_torch.parallel.halo_stencil import (make_stencil_halo_pressure_solver,
                                                make_stencil_halo_viscous_solver)
from tpufem_torch.parallel.spmd import (DeviceMesh, EnsembleStep, MultiMeshEnsemble,
                                        ShardedEnsemble, all_gather, build_device_mesh,
                                        make_multimesh_step, make_sharded_step, psum, run_sharded)
from tpufem_torch.parallel.stokes_sharded import make_sharded_matfree_step

__all__ = [
    "MultiMeshEnsemble",
    "ShardedEnsemble",
    "EnsembleStep",
    "make_multimesh_step",
    "make_sharded_step",
    "run_sharded",
    "DeviceMesh",
    "build_device_mesh",
    "psum",
    "all_gather",
    "make_sharded_viscous_solver",
    "make_halo_viscous_solver",
    "make_halo_pressure_solver",
    "make_stencil_halo_viscous_solver",
    "make_stencil_halo_pressure_solver",
    "make_sharded_grid_solvers",
    "make_halo_rdma",
    "halo_rdma",
    "halo_rdma_ref",
    "make_sharded_matfree_step",
]
