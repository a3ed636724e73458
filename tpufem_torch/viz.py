"""Host-side rendering of simulation snapshots (matplotlib, Agg backend).

The PyTorch counterpart of ``tpufem.viz``: the simulation emits snapshot
tensors (:func:`run_with_frames`) on any device, and these functions move
them to host NumPy and draw them, so the device never waits on a canvas.
The reference's figures: the mesh viewer (``showerScript.py``), tripcolor
fields, quiver and streamline dashboards
(``scripts/stokes_clean_for_report.py:552-605``), the food-capture frame
(``code/StokesFood.py:507-536``) and offline movies
(``scripts/good_visualization2.py:735-744``).

matplotlib is imported on first use, not with this module: a machine
without it (such as one that only runs the card) can import the package
and the CLI, and only drawing raises ``ImportError``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tpufem_torch.mesh.core import Mesh
from tpufem_torch.metrics import to_host


def _pyplot():
    """matplotlib.pyplot on the Agg backend (headless)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("tpufem_torch.viz draws with matplotlib, which is not installed "
                          "here; render on a host that has it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _triangulation(mesh: Mesh):
    _pyplot()
    import matplotlib.tri as mtri

    return mtri.Triangulation(mesh.coords[:, 0], mesh.coords[:, 1], mesh.tris)


def _axes(ax, figsize=(6, 6)):
    if ax is None:
        _, ax = _pyplot().subplots(figsize=figsize)
    return ax


def plot_mesh(mesh: Mesh, ax=None):
    """Wireframe mesh viewer (showerScript.py equivalent)."""
    ax = _axes(ax)
    ax.triplot(_triangulation(mesh), lw=0.4, color="k")
    ax.set_aspect("equal")
    return ax


def plot_scalar(mesh: Mesh, values, ax=None, cmap="viridis", vmin=None, vmax=None,
                label=None, shading="gouraud"):
    """Nodal scalar field as tripcolor (poisson.py:290-296 style)."""
    ax = _axes(ax)
    tpc = ax.tripcolor(_triangulation(mesh), to_host(values), shading=shading, cmap=cmap,
                       vmin=vmin, vmax=vmax)
    ax.figure.colorbar(tpc, ax=ax, label=label)
    ax.set_aspect("equal")
    return ax


def plot_velocity(mesh: Mesh, u, ax=None, skip=3, scale=10.0, background=None,
                  normalize=True, cmap="plasma", vmin=None, vmax=None):
    """Quiver (+ optional scalar background), StokesColor.py:514-533 style
    (unit-normalized arrows by default, like its ``unit_vectors``)."""
    ax = _axes(ax)
    if background is not None:
        ax.tripcolor(_triangulation(mesh), to_host(background), shading="gouraud", cmap=cmap,
                     vmin=vmin, vmax=vmax)
    arrows = np.array(to_host(u), dtype=np.float64)
    if normalize:
        mag = np.linalg.norm(arrows, axis=1, keepdims=True)
        mag[mag == 0] = 1.0
        arrows = arrows / mag
    sel = np.arange(mesh.n_nodes)[::skip]
    ax.quiver(mesh.coords[sel, 0], mesh.coords[sel, 1], arrows[sel, 0], arrows[sel, 1],
              angles="xy", scale_units="xy", scale=scale, color="k", linewidth=0.6)
    ax.set_aspect("equal")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    return ax


def plot_streamlines(mesh: Mesh, u, ax=None, density=1.2, grid_n=100, interp: str = "linear"):
    """Streamlines through grid interpolation (stokes_clean_for_report.py:
    565-569); ``interp="cubic"`` gives the smoother ``griddata(...,
    'cubic')`` dashboards of ``scripts/good_visualization.py:729-740``."""
    tri = _triangulation(mesh)
    import matplotlib.tri as mtri

    ax = _axes(ax)
    # a writable copy: CubicTriInterpolator renumbers z in place
    u = np.array(to_host(u), dtype=np.float64)
    gx, gy = np.meshgrid(np.linspace(0.01, 0.99, grid_n), np.linspace(0.01, 0.99, grid_n))
    if interp == "cubic":
        def make(f):
            return mtri.CubicTriInterpolator(tri, f, kind="geom")
    else:
        def make(f):
            return mtri.LinearTriInterpolator(tri, f)
    ux = make(u[:, 0])(gx, gy)
    uy = make(u[:, 1])(gx, gy)
    ax.streamplot(gx, gy, ux.filled(0.0), uy.filled(0.0), density=density, color="w")
    ax.set_aspect("equal")
    return ax


def dashboard(mesh: Mesh, u, p, vorticity=None, path=None):
    """Three-panel velocity / pressure / vorticity figure
    (stokes_clean_for_report.py:552-605)."""
    fig, axes = _pyplot().subplots(1, 3, figsize=(18, 5.5), constrained_layout=True)
    speed = np.linalg.norm(to_host(u), axis=1)
    plot_velocity(mesh, u, ax=axes[0], background=speed, cmap="viridis")
    plot_streamlines(mesh, u, ax=axes[0])
    axes[0].set_title("velocity + streamlines")
    plot_scalar(mesh, p, ax=axes[1], cmap="coolwarm", label="p")
    axes[1].set_title("pressure")
    if vorticity is not None:
        plot_scalar(mesh, vorticity, ax=axes[2], cmap="RdBu_r", label="ω")
        axes[2].set_title("vorticity")
    if path:
        fig.savefig(path, dpi=120)
    return fig


def tracer_frame(mesh: Mesh, u, points, status, ax=None, vmax=2.0):
    """Food-capture frame: speed background and status-coloured tracers
    (code/StokesFood.py:507-536)."""
    ax = _axes(ax, (7, 6))
    speed = np.linalg.norm(to_host(u), axis=1)
    plot_scalar(mesh, speed, ax=ax, cmap="viridis", vmin=0, vmax=vmax, label="|u|")
    pts = to_host(points)
    colors = np.where(to_host(status) > 0, "red", "blue")
    ax.scatter(pts[:, 0], pts[:, 1], c=colors, s=12, zorder=5, alpha=0.9)
    ax.set_facecolor("black")
    return ax


def plot_bc_overlay(mesh: Mesh, boundary, ax=None):
    """Boundary-condition debug overlay (the debug block of
    scripts/stokes_report.py:1001-1042): walls, inner body and periodic
    masters and slaves over the mesh wireframe."""
    ax = _axes(ax)
    plot_mesh(mesh, ax=ax)
    c = mesh.coords
    for idx, color, label in ((boundary.walls, "tab:red", "walls (Dirichlet)"),
                              (boundary.inner, "tab:orange", "inner body"),
                              (boundary.masters, "tab:green", "periodic masters"),
                              (boundary.slaves, "tab:blue", "periodic slaves")):
        ax.scatter(c[idx, 0], c[idx, 1], s=14, c=color, label=label)
    ax.legend(loc="upper right", fontsize=7)
    return ax


def _save(fig, ani, path: str, fps: int, dpi: int, writer: str | None) -> str:
    """Write ``ani`` to ``path``: ffmpeg where it is available, else pillow
    (an ``.mp4`` path then becomes ``.gif``)."""
    from matplotlib import animation as manim

    if writer is None:
        writer = "ffmpeg" if manim.writers.is_available("ffmpeg") else "pillow"
        if writer == "pillow" and path.endswith(".mp4"):
            path = path[:-4] + ".gif"
    ani.save(path, writer=writer, fps=fps, dpi=dpi)
    _pyplot().close(fig)
    return path


def animate(mesh: Mesh, frames: Sequence, path: str = "animation.mp4", fps: int = 20,
            dpi: int = 120, cmap: str = "plasma", vmin: float = 0.0, vmax: float = 1.0,
            writer: str | None = None) -> str:
    """Offline scalar-field animation → mp4 or gif
    (good_visualization2.py:735-744); returns the path written."""
    fig, ax = _pyplot().subplots(figsize=(6, 6))
    from matplotlib import animation as manim

    tpc = ax.tripcolor(_triangulation(mesh), to_host(frames[0]), shading="gouraud", cmap=cmap,
                       vmin=vmin, vmax=vmax)
    ax.set_aspect("equal")

    def update(i):
        tpc.set_array(to_host(frames[i]))
        ax.set_title(f"frame {i}")
        return [tpc]

    ani = manim.FuncAnimation(fig, update, frames=len(frames), blit=True)
    return _save(fig, ani, path, fps, dpi, writer)


def animate_tracers(mesh: Mesh, u_frames: Sequence, tracer_frames: Sequence,
                    status_frames: Sequence, path: str = "food.mp4", fps: int = 20,
                    dpi: int = 110, vmax: float = 2.0, writer: str | None = None) -> str:
    """Offline food-run movie: speed background and status-coloured tracers
    a frame (code/StokesFood.py:507-536 as an offline FuncAnimation);
    returns the path written."""
    fig, ax = _pyplot().subplots(figsize=(7, 6))
    from matplotlib import animation as manim

    speed0 = np.linalg.norm(to_host(u_frames[0]), axis=1)
    tpc = ax.tripcolor(_triangulation(mesh), speed0, shading="gouraud", cmap="viridis",
                       vmin=0.0, vmax=vmax)
    fig.colorbar(tpc, ax=ax, label="|u|")
    pts0 = to_host(tracer_frames[0])
    scat = ax.scatter(pts0[:, 0], pts0[:, 1], c="blue", s=12, zorder=5, alpha=0.9)
    ax.set_aspect("equal")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_facecolor("black")

    def update(i):
        tpc.set_array(np.linalg.norm(to_host(u_frames[i]), axis=1))
        status = to_host(status_frames[i])
        scat.set_offsets(to_host(tracer_frames[i]))
        scat.set_color(np.where(status > 0, "red", "blue"))
        ax.set_title(f"frame {i}: eaten {int((status > 0).sum())}/{len(status)}")
        return [tpc, scat]

    ani = manim.FuncAnimation(fig, update, frames=len(tracer_frames), blit=True)
    return _save(fig, ani, path, fps, dpi, writer)


def run_with_frames(problem, steps: int, frame_interval: int,
                    field: str | Sequence[str] = "c"):
    """Run a Stokes problem in chunks of ``frame_interval`` steps and keep
    a host snapshot of ``field`` (a state key, or a tuple of keys: frames is
    then a dict key → list) after each chunk; for the food movie pass
    ("u", "tracers", "tracer_status") and render with
    :func:`animate_tracers`.  Returns (final state, the chunks' metrics,
    frames)."""
    from tpufem_torch.workloads import stokes

    keys = (field,) if isinstance(field, str) else tuple(field)
    state = stokes.initial_state(problem)
    frames = {k: [to_host(state[k])] for k in keys}
    metrics_chunks = []
    done = 0
    while done < steps:
        chunk = min(frame_interval, steps - done)
        state, metrics = stokes.run(problem, steps=chunk, state=state)
        for k in keys:
            frames[k].append(to_host(state[k]))
        metrics_chunks.append(metrics)
        done += chunk
    if isinstance(field, str):
        return state, metrics_chunks, frames[field]
    return state, metrics_chunks, frames
