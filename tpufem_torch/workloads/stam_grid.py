"""Structured-grid "stable fluids" solver, the counterpart of
``tpufem.workloads.stam_grid``: a Stam-style (G, G) solver with a pulsating
circular obstacle and a dye inflow jet, a Jacobi relaxation (every sweep
reads the whole old iterate before it writes), semi-Lagrangian advection by
bilinear back-trace, and the reference's boundary treatment (sign-flipped
walls per component, zero-gradient outflow on the right wall, averaged
corners, applied in order).

The step is (G, G) tensor arithmetic on the device; ``run`` is a Python
loop over frames.
"""

from __future__ import annotations

import dataclasses

import torch

from tpufem_torch import config as tconfig


@dataclasses.dataclass
class StamConfig:
    size: int = 200
    dt: float = 0.1
    viscosity: float = 1e-4
    diffusion: float = 1e-4
    inflow_radius: int = 100
    inflow_speed: float = 5.0
    obstacle_center: tuple[int, int] | None = None  # default: grid center
    obstacle_base_radius: float = 20.0
    obstacle_squirm_amplitude: float = 2.0
    obstacle_squirm_speed: float = 0.1
    solver_iters: int = 20
    precision: str = "f32"


def _set_boundaries_(b: int, x: torch.Tensor) -> torch.Tensor:
    """:func:`set_boundaries` in place on ``x`` (at least 4 × 4)."""
    if min(x.shape) < 4:
        raise ValueError(f"the Stam grid must be at least 4 × 4, not {tuple(x.shape)}")
    if b == 2:
        torch.neg(x[1, :], out=x[0, :])
        torch.neg(x[-2, :], out=x[-1, :])
    else:
        x[0, :] = x[1, :]
        x[-1, :] = x[-2, :]
    if b == 1:
        torch.neg(x[:, 1], out=x[:, 0])
    else:
        x[:, 0] = x[:, 1]
    x[:, -1] = x[:, -2]  # zero-gradient outflow (right wall)
    # the four corners at once, as strided (2, 2) views: each corner averages
    # its row neighbour (rows 1 and n − 1) and its column neighbour (columns
    # 1 and m − 1), edge cells written above
    n, m = x.shape[0] - 1, x.shape[1] - 1
    torch.mul(x[1:n:n - 2, ::m] + x[::n, 1:m:m - 2], 0.5, out=x[::n, ::m])
    return x


def set_boundaries(b: int, x: torch.Tensor) -> torch.Tensor:
    """The reference's boundary treatment, out of place, each write seeing
    the ones before it: rows 0 and −1 copy (b = 2: negate) their
    neighbours, column 0 likewise (b = 1: negate), column −1 copies, then
    the corners average their two neighbours."""
    return _set_boundaries_(b, x.clone())


def linear_solve(b: int, x: torch.Tensor, x0: torch.Tensor, a: float, c: float, iters: int):
    """``iters`` Jacobi sweeps of x = (x0 + a·Σneighbours)/c: each sweep
    sums the neighbours of the whole interior from the old x into a new
    tensor before it writes any of them."""
    x = x.clone()
    inner = x0[1:-1, 1:-1]
    for _ in range(iters):
        nb = x[1:-1, :-2] + x[1:-1, 2:] + x[:-2, 1:-1] + x[2:, 1:-1]
        torch.div(inner + a * nb, c, out=x[1:-1, 1:-1])
        _set_boundaries_(b, x)
    return x


def diffuse(b: int, x0: torch.Tensor, diff: float, dt: float, size: int, iters: int):
    a = dt * diff * (size - 2) * (size - 2)
    return linear_solve(b, x0, x0, a, 1.0 + 4.0 * a, iters)


def project(vx: torch.Tensor, vy: torch.Tensor, size: int, iters: int):
    div = torch.zeros_like(vx)
    div[1:-1, 1:-1] = (-0.5 * (vx[1:-1, 2:] - vx[1:-1, :-2] + vy[2:, 1:-1] - vy[:-2, 1:-1])
                       / size)
    _set_boundaries_(0, div)
    p = _set_boundaries_(0, torch.zeros_like(vx))
    p = linear_solve(0, p, div, 1.0, 4.0, iters)
    vx, vy = vx.clone(), vy.clone()
    vx[1:-1, 1:-1] += -0.5 * (p[1:-1, 2:] - p[1:-1, :-2]) * size
    vy[1:-1, 1:-1] += -0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) * size
    return _set_boundaries_(1, vx), _set_boundaries_(2, vy)


def _bilinear(d0: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of d0 at (row=y, col=x), the coordinates clamped
    beforehand: the order-1 ``map_coordinates``."""
    size = d0.shape[0]
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp(y0 + 1, 0, size - 1)
    x1 = torch.clamp(x0 + 1, 0, size - 1)
    wy = y - y0
    wx = x - x0
    return (d0[y0, x0] * (1 - wy) * (1 - wx)
            + d0[y0, x1] * (1 - wy) * wx
            + d0[y1, x0] * wy * (1 - wx)
            + d0[y1, x1] * wy * wx)


def advect(b: int, d0: torch.Tensor, vx: torch.Tensor, vy: torch.Tensor, dt: float):
    size = d0.shape[0]
    scale = dt * (size - 2)
    ar = torch.arange(size, dtype=d0.dtype, device=d0.device)
    iy, ix = torch.meshgrid(ar, ar, indexing="ij")
    x = torch.clamp(ix - scale * vx, 0.5, size - 1.5)
    y = torch.clamp(iy - scale * vy, 0.5, size - 1.5)
    return _set_boundaries_(b, _bilinear(d0, y, x))


def obstacle_mask(config: StamConfig, t: torch.Tensor) -> torch.Tensor:
    """The obstacle at time ``t``: the grid's distances from the center are
    float32 at every precision, compared with the radius in ``t``'s dtype."""
    size = config.size
    cx, cy = config.obstacle_center or (size // 2, size // 2)
    radius = config.obstacle_base_radius + config.obstacle_squirm_amplitude * torch.sin(
        t * config.obstacle_squirm_speed)
    ar = torch.arange(size, dtype=torch.float32, device=t.device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    return torch.hypot(xx - cx, yy - cy).to(radius.dtype) <= radius


def initial_state(config: StamConfig = StamConfig(), device=None) -> dict:
    dev = tconfig.device(device)
    dtype = tconfig.dtype(config.precision, bf16=False)
    z = torch.zeros((config.size, config.size), dtype=dtype, device=dev)
    return {"vx": z, "vy": z, "density": z, "t": torch.zeros((), dtype=dtype, device=dev)}


def step(config: StamConfig, state: dict) -> dict:
    """One step in the reference's order."""
    size, dt, iters = config.size, config.dt, config.solver_iters
    vx, vy, density, t = state["vx"], state["vy"], state["density"], state["t"]
    zero = torch.zeros((), dtype=vx.dtype, device=vx.device)

    obstacle = obstacle_mask(config, t)
    vx = torch.where(obstacle, zero, vx)
    vy = torch.where(obstacle, zero, vy)

    vx0 = diffuse(1, vx, config.viscosity, dt, size, iters)
    vy0 = diffuse(2, vy, config.viscosity, dt, size, iters)
    vx0, vy0 = project(vx0, vy0, size, iters)
    vx = advect(1, vx0, vx0, vy0, dt)
    vy = advect(2, vy0, vx0, vy0, dt)
    vx, vy = project(vx, vy, size, iters)

    # the dye and velocity inflow jet
    cy = size // 2
    s, e = max(cy - config.inflow_radius, 0), cy + config.inflow_radius
    vx[s:e, 1:3] = config.inflow_speed  # project's outputs are fresh tensors
    density = density.clone()
    density[s:e, 1:3] = 1.0

    density0 = diffuse(0, density, config.diffusion, dt, size, iters)
    density = advect(0, density0, vx, vy, dt)
    density = torch.where(obstacle, torch.tensor(0.1, dtype=density.dtype,
                                                 device=density.device), density)
    return {"vx": vx, "vy": vy, "density": density, "t": t + dt}


def run(config: StamConfig = StamConfig(), frames: int = 400, state: dict | None = None,
        device=None):
    """``frames`` steps: (state, max speed per frame)."""
    if state is None:
        state = initial_state(config, device)
    speeds = []
    for _ in range(frames):
        state = step(config, state)
        speeds.append(torch.max(torch.hypot(state["vx"], state["vy"])))
    return state, torch.stack(speeds) if speeds else state["vx"].new_zeros(0)
