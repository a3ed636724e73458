from tpufem_torch.solve.dense import DenseLU, DenseInverse, make_dense_solver
from tpufem_torch.solve.cg import cg, cg_fixed, jacobi_pcg, bicgstab_fixed
from tpufem_torch.solve.matfree import ViscousCG, PressureCG
from tpufem_torch.solve.pressure import merged_pressure_apply_matrix, merge_map, owner_map

__all__ = [
    "DenseLU",
    "DenseInverse",
    "make_dense_solver",
    "cg",
    "cg_fixed",
    "jacobi_pcg",
    "bicgstab_fixed",
    "ViscousCG",
    "PressureCG",
    "merged_pressure_apply_matrix",
    "merge_map",
    "owner_map",
]
