from tpufem_torch.solve.dense import DenseLU, DenseInverse, make_dense_solver
from tpufem_torch.solve.pressure import merged_pressure_apply_matrix, merge_map, owner_map

__all__ = [
    "DenseLU",
    "DenseInverse",
    "make_dense_solver",
    "merged_pressure_apply_matrix",
    "merge_map",
    "owner_map",
]
