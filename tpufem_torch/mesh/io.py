"""Triangle mesh-file I/O.

Parses the output of Shewchuk's *Triangle* mesh generator (``.node``,
``.ele`` and ``.poly`` files) into NumPy arrays.  Same readers and writers
as ``tpufem.mesh.io``.

Formats (1-indexed node ids in file, converted to 0-indexed here):

* ``.node``: header ``N dim n_attrs has_marker``; rows ``idx x y [marker]``.
* ``.ele``:  header ``T nodes_per_tri n_attrs``; rows ``idx n1 n2 n3 [n4 n5 n6]``
  (3 = P1 linear, 6 = P2 quadratic).
* ``.poly``: node section header (skipped: nodes live in ``.node``), then
  segment header ``S has_marker``; rows ``idx a b [marker]``; then a hole
  section ``H`` / ``idx x y`` rows.
"""

from __future__ import annotations

import numpy as np


def _tokenize(path: str) -> list[list[str]]:
    """Non-empty, non-comment lines split into tokens."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split())
    return rows


def read_node(path: str, coord_dtype=np.float64):
    """Read a ``.node`` file → ``(coords (N,2), markers (N,))``.

    Node ids in the file are 1-indexed and may appear in any order; rows
    are scattered by id."""
    rows = _tokenize(path)
    header = rows[0]
    n = int(header[0])
    has_marker = len(header) >= 4 and int(header[3]) != 0
    coords = np.zeros((n, 2), dtype=coord_dtype)
    markers = np.zeros(n, dtype=np.int32)
    for row in rows[1 : 1 + n]:
        idx = int(row[0]) - 1
        coords[idx, 0] = float(row[1])
        coords[idx, 1] = float(row[2])
        if has_marker and len(row) > 3:
            markers[idx] = int(row[3])
    return coords, markers


def read_ele(path: str):
    """Read an ``.ele`` file → ``tris (T, 3|6) int32`` (0-indexed).

    P1 files have 3 nodes per triangle; P2 files have 6 (corner nodes
    first, then edge midpoints: Triangle's convention)."""
    rows = _tokenize(path)
    header = rows[0]
    t = int(header[0])
    npt = int(header[1]) if len(header) > 1 else 3
    tris = np.zeros((t, npt), dtype=np.int32)
    for row in rows[1 : 1 + t]:
        idx = int(row[0]) - 1
        tris[idx] = [int(v) - 1 for v in row[1 : 1 + npt]]
    return tris


def read_poly(path: str):
    """Read a ``.poly`` file → ``(segments (S,2), seg_markers (S,), holes (H,2))``.

    The node section is skipped (its count is read from the first header)."""
    rows = _tokenize(path)
    pos = 0
    n_nodes = int(rows[pos][0])
    pos += 1 + n_nodes  # nodes are duplicated in .node; skip

    n_segs = int(rows[pos][0])
    pos += 1
    segments = np.zeros((n_segs, 2), dtype=np.int64)
    seg_markers = np.zeros(n_segs, dtype=np.int64)
    for row in rows[pos : pos + n_segs]:
        idx = int(row[0]) - 1
        segments[idx] = (int(row[1]) - 1, int(row[2]) - 1)
        if len(row) > 3:
            seg_markers[idx] = int(row[3])
    pos += n_segs

    holes = np.zeros((0, 2), dtype=np.float64)
    if pos < len(rows):
        n_holes = int(rows[pos][0])
        pos += 1
        holes = np.zeros((n_holes, 2), dtype=np.float64)
        for row in rows[pos : pos + n_holes]:
            idx = int(row[0]) - 1
            holes[idx] = (float(row[1]), float(row[2]))
    return segments, seg_markers, holes


def write_node(path: str, coords: np.ndarray, markers: np.ndarray) -> None:
    """Write a ``.node`` file (for meshes produced by the generator)."""
    n = coords.shape[0]
    with open(path, "w") as f:
        f.write(f"{n} 2 0 1\n")
        for i in range(n):
            f.write(f"{i + 1} {coords[i, 0]:.17g} {coords[i, 1]:.17g} {int(markers[i])}\n")


def write_ele(path: str, tris: np.ndarray) -> None:
    """Write an ``.ele`` file."""
    t, npt = tris.shape
    with open(path, "w") as f:
        f.write(f"{t} {npt} 0\n")
        for i in range(t):
            ids = " ".join(str(v + 1) for v in tris[i])
            f.write(f"{i + 1} {ids}\n")
