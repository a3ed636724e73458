from tpufem_torch.ops.assembly import (
    element_stiffness,
    element_mass,
    element_convection,
    assemble_dense,
    assemble_coo,
    assemble_csr,
    lumped_mass,
    load_vector,
    load_vector_nodal,
)
from tpufem_torch.ops.calculus import (
    divergence,
    gradient,
    vorticity,
    consistent_divergence_rhs,
    divergence_matrices,
    gradient_matrices,
    mass_apply,
    convection_apply,
)
from tpufem_torch.ops.banded import BandedOperator
from tpufem_torch.ops.sparse import CSROperator, csr_matvec

__all__ = [
    "element_stiffness",
    "element_mass",
    "element_convection",
    "assemble_dense",
    "assemble_coo",
    "assemble_csr",
    "lumped_mass",
    "load_vector",
    "load_vector_nodal",
    "divergence",
    "gradient",
    "vorticity",
    "consistent_divergence_rhs",
    "divergence_matrices",
    "gradient_matrices",
    "mass_apply",
    "convection_apply",
    "CSROperator",
    "csr_matvec",
    "BandedOperator",
]
