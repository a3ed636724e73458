"""The one traffic generator: seeded start states of the episodes.

A traffic file gives the sizes; the seed only picks phases, angles and
offsets, so every seed asks for the same amount of work:

* ``velocity``: a smooth interior disturbance, ``amplitude`` of the
  squirmer's boundary-speed scale |B1| + |B2|, spread over the low Fourier
  ``modes`` [kx, ky] (periodic in x, zero on the walls), each at a seeded
  phase; the boundary values are then written in (walls, squirmer ring,
  periodic copy);
* ``dye``: a straight front at a seeded angle, c = 1 on one side, shifted
  from the centre by a seeded offset of at most ``offset``; null for none.

``starts`` distinct states are made; the episodes cycle through them.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import fem


def velocity(coords, markers, stokes: dict, spec: dict | None, rng) -> np.ndarray:
    """(N, 2) float64: the disturbance with the boundary values written in
    (zero at the dummy nodes)."""
    n = len(coords)
    u = np.zeros((n, 2))
    if spec and spec["amplitude"] > 0:
        amp = spec["amplitude"] * (abs(stokes["B1"]) + abs(stokes["B2"])) / len(spec["modes"])
        x, y = coords[:, 0] / stokes["L"], coords[:, 1] / stokes["H"]
        for kx, ky in spec["modes"]:
            phase = rng.uniform(0.0, 2.0 * np.pi, size=2)
            envelope = np.sin(np.pi * ky * y)
            u[:, 0] += amp * np.cos(2.0 * np.pi * kx * x + phase[0]) * envelope
            u[:, 1] += amp * np.cos(2.0 * np.pi * kx * x + phase[1]) * envelope
    u[np.asarray(markers) < 0] = 0.0
    walls, inner, masters, slaves = fem.boundary_sets(coords, markers, stokes)
    u[slaves] = u[masters]
    u[walls] = stokes["outer_value"]
    u[inner] = fem.squirmer(coords[inner], stokes["center"], stokes["B1"], stokes["B2"])
    return u


def dye(coords, spec: dict, rng) -> np.ndarray:
    """(N,) float64 0/1 dye on one side of a seeded front through the
    domain's middle."""
    angle = rng.uniform(0.0, 2.0 * np.pi)
    offset = rng.uniform(-spec["offset"], spec["offset"])
    side = (coords[:, 0] - 0.5) * np.cos(angle) + (coords[:, 1] - 0.5) * np.sin(angle)
    return (side < offset).astype(np.float64)


def make(mesh, stokes: dict, traffic: dict, seed: int) -> list[dict]:
    """The traffic's start states: a list of {"u": (N, 2)[, "c": (N,)]}
    host float64 arrays."""
    coords, _, markers = mesh
    out = []
    for k in range(int(traffic["starts"])):
        rng = np.random.default_rng([seed % 2**63, k])
        start = {"u": velocity(coords, markers, stokes, traffic.get("velocity"), rng)}
        if traffic.get("dye"):
            start["c"] = dye(coords, traffic["dye"], rng)
        out.append(start)
    return out
