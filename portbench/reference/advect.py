"""Semi-Lagrangian dye advection on a P1 mesh, plain PyTorch.

Each node's departure point x − Δt·u is wrapped into [0, L) in x and held
inside (0, H) in y; the triangle that contains it is found through a
uniform grid of bounding-box buckets, and the dye there is the P1
interpolation of the old field.  A departure point in no triangle (inside
the hole) keeps the node's old value.
"""

from __future__ import annotations

import numpy as np
import torch

EDGE = 1e-12  # y is held this far inside the walls
INSIDE = -1e-12  # least barycentric weight that still counts as inside


class Locator:
    """Bounding-box buckets of the valid triangles on a g×g grid."""

    def __init__(self, coords: np.ndarray, tris: np.ndarray, valid: np.ndarray,
                 dtype=torch.float64, device="cpu", per_cell: float = 2.0):
        coords = np.asarray(coords, dtype=np.float64)
        tris = np.asarray(tris, dtype=np.int64)
        ids = np.nonzero(valid)[0]
        g = max(4, int(np.sqrt(len(ids) / per_cell)))
        lo = coords.min(axis=0)
        size = np.maximum(coords.max(axis=0) - lo, 1e-12) / g
        p = coords[tris[ids]]
        c0 = np.clip(((p.min(axis=1) - lo) / size).astype(np.int64), 0, g - 1)
        c1 = np.clip(((p.max(axis=1) - lo) / size).astype(np.int64), 0, g - 1)
        cells, owners = [], []
        for di in range(int((c1 - c0)[:, 0].max()) + 1):
            for dj in range(int((c1 - c0)[:, 1].max()) + 1):
                sel = (c0[:, 0] + di <= c1[:, 0]) & (c0[:, 1] + dj <= c1[:, 1])
                cells.append((c0[sel, 0] + di) * g + c0[sel, 1] + dj)
                owners.append(ids[sel])
        cells, owners = np.concatenate(cells), np.concatenate(owners)
        order = np.argsort(cells, kind="stable")
        cells, owners = cells[order], owners[order]
        counts = np.bincount(cells, minlength=g * g)
        table = np.full((g * g, int(counts.max())), -1, dtype=np.int64)
        table[cells, np.arange(len(cells)) - np.repeat(np.cumsum(counts) - counts, counts)] = owners
        self.g = g
        self.lo = torch.as_tensor(lo, dtype=torch.float64, device=device)
        self.size = torch.as_tensor(size, dtype=torch.float64, device=device)
        self.table = torch.as_tensor(table, device=device)
        self.tris = torch.as_tensor(tris, device=device)
        self.coords = torch.as_tensor(coords, dtype=dtype, device=device)

    def locate(self, pts: torch.Tensor):
        """→ (found (P,), corner node ids (P, 3), weights (P, 3))."""
        cell = torch.clamp(((pts.double() - self.lo) / self.size).long(), 0, self.g - 1)
        cand = self.table[cell[:, 0] * self.g + cell[:, 1]]  # (P, C)
        real = cand >= 0
        corners = self.tris[torch.where(real, cand, 0)]  # (P, C, 3)
        xy = self.coords[corners]  # (P, C, 3, 2)
        a, b, c = xy[..., 0, :], xy[..., 1, :], xy[..., 2, :]
        q = pts[:, None, :]
        det = (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
            c[..., 0] - a[..., 0]) * (b[..., 1] - a[..., 1])
        safe = torch.where(det == 0, torch.ones_like(det), det)
        wb = ((q[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
              - (c[..., 0] - a[..., 0]) * (q[..., 1] - a[..., 1])) / safe
        wc = ((b[..., 0] - a[..., 0]) * (q[..., 1] - a[..., 1])
              - (q[..., 0] - a[..., 0]) * (b[..., 1] - a[..., 1])) / safe
        w = torch.stack([1.0 - wb - wc, wb, wc], dim=-1)  # (P, C, 3)
        least = torch.where(real & (det != 0), w.min(dim=-1).values,
                            torch.full_like(wb, -float("inf")))
        best = least.argmax(dim=1)
        found = least.max(dim=1).values >= INSIDE
        pick = best[:, None, None].expand(-1, 1, 3)
        return (found, torch.gather(corners, 1, pick)[:, 0],
                torch.gather(w, 1, pick.to(torch.int64))[:, 0])


def semilagrange(locator: Locator, c: torch.Tensor, u: torch.Tensor, dt: float, L: float,
                 H: float) -> torch.Tensor:
    """One step of the dye ``c`` (N,) through the nodal velocity ``u`` (N, 2)."""
    x = locator.coords
    xb = torch.remainder(x[:, 0] - dt * u[:, 0], L)
    yb = x[:, 1] - dt * u[:, 1]
    yb = torch.where(yb < 0.0, torch.full_like(yb, EDGE), yb)
    yb = torch.where(yb > H, torch.full_like(yb, H - EDGE), yb)
    found, corners, w = locator.locate(torch.stack([xb, yb], dim=1))
    new = (w * c[corners]).sum(dim=1)
    return torch.where(found, new, c)
