from tpufem_torch.mesh.core import Mesh, load_mesh, mesh_from_arrays
from tpufem_torch.mesh.io import read_node, read_ele, read_poly
from tpufem_torch.mesh.generate import generate_annulus_mesh, generate_rect_mesh

__all__ = [
    "Mesh",
    "load_mesh",
    "mesh_from_arrays",
    "read_node",
    "read_ele",
    "read_poly",
    "generate_annulus_mesh",
    "generate_rect_mesh",
]
