"""The Mesh container: static P1 triangle geometry, precomputed once.

A host-side NumPy container, as in ``tpufem.mesh.core``.  The port moves
to the device only the operators and tables built from it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufem_torch.mesh import io as mesh_io

_DEGENERATE_TOL = 1e-14  # triangles with |det| below this contribute nothing


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An unstructured P1 triangle mesh with precomputed geometry.

    Attributes:
      coords:  (N, 2) node coordinates.
      tris:    (T, 3) triangle → node indices (0-based, P1 corners).
      markers: (N,)   integer boundary markers from the ``.node`` file.
      det:     (T,)   signed determinant = 2 × signed area.
      area:    (T,)   unsigned triangle area.
      grads:   (T, 3, 2) P1 basis gradients ∇φ_i (signed-det convention:
               grads[t, i] = ([y_{i+1}-y_{i+2}], [x_{i+2}-x_{i+1}]) / det).
      valid:   (T,)   mask of non-degenerate triangles (|det| ≥ 1e-14).
      tris_p2: (T, 6) optional P2 connectivity when loaded from a 6-node
               ``.ele`` file, else None.
      segments: (S, 2) optional boundary segments from ``.poly``.
      seg_markers: (S,) markers for the segments.
      holes:   (H, 2) hole seed points from ``.poly``.
    """

    coords: np.ndarray
    tris: np.ndarray
    markers: np.ndarray
    det: np.ndarray
    area: np.ndarray
    grads: np.ndarray
    valid: np.ndarray
    tris_p2: np.ndarray | None = None
    segments: np.ndarray | None = None
    seg_markers: np.ndarray | None = None
    holes: np.ndarray | None = None

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tris.shape[0]

    def nodes_where(self, mask: np.ndarray) -> np.ndarray:
        return np.nonzero(np.asarray(mask))[0].astype(np.int32)

    def nodes_on_line(self, axis: int, value: float, tol: float = 1e-6) -> np.ndarray:
        """Indices of nodes with coords[:, axis] ≈ value."""
        return self.nodes_where(np.abs(self.coords[:, axis] - value) < tol)

    def nodes_with_marker(self, marker: int) -> np.ndarray:
        return self.nodes_where(self.markers == marker)

    def tri_coords(self) -> np.ndarray:
        """(T, 3, 2) gathered corner coordinates."""
        return self.coords[self.tris]

    def centroids(self) -> np.ndarray:
        """(T, 2) triangle centroids."""
        return self.tri_coords().mean(axis=1)

    def tensors(self, dtype, device) -> dict:
        """The per-element arrays as tensors on ``device``: ``tris`` (int64),
        ``grads``, ``det``, ``area`` (in ``dtype``) and ``valid`` (bool).
        Made once per (dtype, device) and kept on the mesh, so a per-step
        operator does not copy the geometry to the device every step."""
        import torch

        cache = self.__dict__.setdefault("_tensors", {})
        dev = torch.device(device if device is not None else "cpu")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        hit = cache.get((dtype, dev))
        if hit is None:
            hit = cache[(dtype, dev)] = {
                "tris": torch.as_tensor(self.tris, dtype=torch.int64, device=dev),
                "grads": torch.as_tensor(self.grads, dtype=dtype, device=dev),
                "det": torch.as_tensor(self.det, dtype=dtype, device=dev),
                "area": torch.as_tensor(self.area, dtype=dtype, device=dev),
                "valid": torch.as_tensor(self.valid, dtype=torch.bool, device=dev),
            }
        return hit


def geometry(coords: np.ndarray, tris: np.ndarray):
    """Vectorized per-element geometry: (det, area, grads, valid).

        det = x1 (y2−y3) + x2 (y3−y1) + x3 (y1−y2)
        ∇φ_i = ( y_{i+1} − y_{i+2} ,  x_{i+2} − x_{i+1} ) / det
    """
    pc = coords[tris]  # (T, 3, 2)
    x, y = pc[..., 0], pc[..., 1]
    det = (
        x[:, 0] * (y[:, 1] - y[:, 2])
        + x[:, 1] * (y[:, 2] - y[:, 0])
        + x[:, 2] * (y[:, 0] - y[:, 1])
    )
    valid = np.abs(det) >= _DEGENERATE_TOL
    safe_det = np.where(valid, det, 1.0)
    area = 0.5 * np.abs(det)
    y_diffs = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    x_diffs = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)
    grads = np.stack([y_diffs, x_diffs], axis=2) / safe_det[:, None, None]
    return det, area, grads, valid


def mesh_from_arrays(
    coords: np.ndarray,
    tris: np.ndarray,
    markers: np.ndarray | None = None,
    **extra,
) -> Mesh:
    coords = np.asarray(coords, dtype=np.float64)
    tris_all = np.asarray(tris, dtype=np.int32)
    tris_p2 = None
    if tris_all.shape[1] == 6:
        tris_p2 = tris_all
        tris_all = tris_all[:, :3]
    if markers is None:
        markers = np.zeros(coords.shape[0], dtype=np.int32)
    det, area, grads, valid = geometry(coords, tris_all)
    return Mesh(
        coords=coords,
        tris=tris_all,
        markers=np.asarray(markers, dtype=np.int32),
        det=det,
        area=area,
        grads=grads,
        valid=valid,
        tris_p2=tris_p2,
        **extra,
    )


def load_mesh(stem: str, coord_dtype=np.float64) -> Mesh:
    """Load ``<stem>.node`` + ``<stem>.ele`` (+ optional ``<stem>.poly``)."""
    coords, markers = mesh_io.read_node(stem + ".node", coord_dtype=coord_dtype)
    tris = mesh_io.read_ele(stem + ".ele")
    segments = seg_markers = holes = None
    try:
        segments, seg_markers, holes = mesh_io.read_poly(stem + ".poly")
    except FileNotFoundError:
        pass
    return mesh_from_arrays(
        coords.astype(np.float64),
        tris,
        markers,
        segments=segments,
        seg_markers=seg_markers,
        holes=holes,
    )
