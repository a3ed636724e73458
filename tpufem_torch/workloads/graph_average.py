"""Graph-Laplacian "averaging" solve, the counterpart of
``tpufem.workloads.graph_average``: each interior node equals the mean of
its mesh neighbours (harmonic interpolation on the mesh graph, not FEM),

    A[i,i] = 1;  A[i,j] = −1/deg(i) for the neighbours j of interior i,
    b[i] = the boundary value of node i's marker,

assembled on the host and solved once (dense, float64) on the device.
The default marker roles are the reference prototype's: marker 1 takes the
inner value, marker 2 the outer one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.solve.dense import make_dense_solver


@dataclasses.dataclass
class GraphAverageConfig:
    marker_values: dict | None = None  # marker -> boundary value
    solver: str = "lu"

    def values(self):
        return self.marker_values or {1: 0.0, 2: 1.0}


def neighbor_lists(mesh: Mesh) -> list[list[int]]:
    """Each node's mesh neighbours, sorted."""
    neigh = [set() for _ in range(mesh.n_nodes)]
    for a, b, c in mesh.tris:
        neigh[a].update((b, c))
        neigh[b].update((a, c))
        neigh[c].update((a, b))
    return [sorted(s) for s in neigh]


def solve(mesh: Mesh, config: GraphAverageConfig = GraphAverageConfig(), device=None):
    """(f (N,), residual ‖A f − b‖) on ``device``: one dense solve."""
    n = mesh.n_nodes
    A = np.zeros((n, n))
    b = np.zeros(n)
    values = config.values()
    neigh = neighbor_lists(mesh)
    for i in range(n):
        A[i, i] = 1.0
        m = int(mesh.markers[i])
        if m == 0:
            for j in neigh[i]:
                A[i, j] = -1.0 / len(neigh[i])
        else:
            b[i] = values.get(m, 0.0)
    dev = tconfig.device(device)
    A_t = torch.as_tensor(A, device=dev)
    b_t = torch.as_tensor(b, device=dev)
    f = make_dense_solver(A, config.solver, device=dev).solve(b_t)
    return f, torch.linalg.norm(A_t @ f - b_t)
