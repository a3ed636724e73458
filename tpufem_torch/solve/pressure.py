"""The merged periodic pressure operator, precomputed on the host.

The merged operator enforces periodicity exactly by DOF-merging (slave
pressure dofs share their master's column) and bakes the whole solve (M_L
scaling, merge, pseudo-inverse, scatter-back) into ONE (N, N) matrix,
applied per step as a single matvec:

    p = A_eff @ b,   A_eff = M_g (M_gᵀ (K / M_L) M_g)⁺ M_gᵀ

where b = −div(u*)/Δt.  Same construction as ``tpufem.solve.pressure``.
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.mesh.core import Mesh
from tpufem_torch.ops import assembly


def owner_map(n: int, masters: np.ndarray, slaves: np.ndarray) -> np.ndarray:
    """(N,) node → owning node (master for slaves, itself otherwise).

    Non-injective pairings resolve like the reference's sequential
    elimination (last pair wins); ownership chains are collapsed."""
    owner = np.arange(n)
    for m, s in zip(np.asarray(masters), np.asarray(slaves)):
        owner[s] = m
    for _ in range(4):  # resolve chains
        owner = owner[owner]
    return owner


def merge_map(n: int, masters: np.ndarray, slaves: np.ndarray) -> np.ndarray:
    """(N, n_act) periodic DOF-merge matrix M_g with x_full = M_g x_act."""
    owner = owner_map(n, masters, slaves)
    active = np.nonzero(owner == np.arange(n))[0]
    col_of = -np.ones(n, dtype=np.int64)
    col_of[active] = np.arange(len(active))
    col = col_of[owner]
    mg = np.zeros((n, len(active)))
    mg[np.arange(n), col] = 1.0
    return mg


def merged_pressure_apply_matrix(
    mesh: Mesh,
    m_lumped: np.ndarray,
    masters: np.ndarray,
    slaves: np.ndarray,
) -> np.ndarray:
    """Host-precomputed (N, N) float64 matrix solving the periodic pressure
    Poisson equation."""
    n = mesh.n_nodes
    K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh)).numpy()
    m_lumped = np.asarray(m_lumped)

    mg = merge_map(n, masters, slaves)  # p_full = M_g p_act
    a_p = K / (m_lumped[:, None] + 1e-12)  # reference row scaling
    a_act = mg.T @ a_p @ mg
    return mg @ np.linalg.pinv(a_act) @ mg.T
