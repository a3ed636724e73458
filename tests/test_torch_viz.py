"""tpufem_torch.viz: every plot and animation renders to files from tensors
(Agg; an ``.mp4`` request becomes a ``.gif`` without ffmpeg), and the
package, the CLI and ``viz`` itself import on a host without matplotlib."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpufem_torch
from tpufem_torch import bc, viz
from tpufem_torch.ops import calculus
from tpufem_torch.workloads import stokes

torch.set_num_threads(2)

MESH = (12, 16)


@pytest.fixture(scope="module")
def mesh():
    return tpufem_torch.generate_annulus_mesh(*MESH)


@pytest.fixture(scope="module")
def dye_problem(mesh):
    cfg = stokes.StokesConfig(dt=0.01, nu=1.0, transport="dye", pressure_mode="merge")
    return stokes.StokesProblem.build(mesh, cfg, device="cpu")


def test_static_plots(mesh, dye_problem, tmp_path):
    state, _ = stokes.run(dye_problem, steps=5)
    u = state["u"]
    speed = torch.linalg.norm(u, dim=1)
    viz.plot_mesh(mesh).figure.savefig(tmp_path / "mesh.png")
    viz.plot_scalar(mesh, state["c"]).figure.savefig(tmp_path / "c.png")
    viz.plot_velocity(mesh, u, background=speed).figure.savefig(tmp_path / "u.png")
    viz.plot_streamlines(mesh, u, interp="cubic", grid_n=40).figure.savefig(tmp_path / "s.png")
    fig = viz.dashboard(mesh, u, torch.zeros(mesh.n_nodes, dtype=u.dtype),
                        vorticity=calculus.vorticity(mesh, u), path=str(tmp_path / "dash.png"))
    assert fig is not None
    viz.plot_bc_overlay(mesh, bc.ChannelBoundary.build(mesh)).figure.savefig(tmp_path / "bc.png")
    for name in ("mesh", "c", "u", "s", "bc"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000, name
    assert (tmp_path / "dash.png").stat().st_size > 10000


def test_tracer_frame(mesh, tmp_path):
    cfg = stokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers", tracer_density=10)
    state, _ = stokes.run(stokes.StokesProblem.build(mesh, cfg, device="cpu"), steps=3)
    ax = viz.tracer_frame(mesh, state["u"], state["tracers"], state["tracer_status"])
    ax.figure.savefig(tmp_path / "food.png")
    assert (tmp_path / "food.png").stat().st_size > 1000


def test_run_with_frames_and_animate(mesh, dye_problem, tmp_path):
    state, chunks, frames = viz.run_with_frames(dye_problem, steps=6, frame_interval=2, field="c")
    assert len(frames) == 4 and len(chunks) == 3  # the initial state + 3 chunks
    assert all(isinstance(f, np.ndarray) for f in frames)
    want, _ = stokes.run(dye_problem, steps=6)
    np.testing.assert_allclose(frames[-1], want["c"].numpy(), rtol=0, atol=1e-12)
    path = viz.animate(mesh, frames, path=str(tmp_path / "dye.mp4"), fps=5, dpi=40)
    assert os.path.getsize(path) > 1000
    if not path.endswith(".mp4"):
        assert path.endswith(".gif")  # no ffmpeg here: pillow


def test_animate_tracers(mesh, tmp_path):
    cfg = stokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers", tracer_density=10)
    problem = stokes.StokesProblem.build(mesh, cfg, device="cpu")
    _, _, frames = viz.run_with_frames(problem, steps=4, frame_interval=2,
                                       field=("u", "tracers", "tracer_status"))
    assert set(frames) == {"u", "tracers", "tracer_status"} and len(frames["u"]) == 3
    path = viz.animate_tracers(mesh, frames["u"], frames["tracers"], frames["tracer_status"],
                               path=str(tmp_path / "food.gif"), fps=5, dpi=40, writer="pillow")
    assert path.endswith(".gif") and os.path.getsize(path) > 1000


def test_imports_without_matplotlib():
    """The package, the CLI and viz import with matplotlib hidden; drawing
    then raises an ImportError that names it."""
    code = (
        "import sys\n"
        "for name in [m for m in sys.modules if m.startswith('matplotlib')]:\n"
        "    del sys.modules[name]\n"
        "sys.modules['matplotlib'] = None\n"
        "import tpufem_torch, tpufem_torch.cli, tpufem_torch.viz as viz\n"
        "try:\n"
        "    viz.plot_mesh(tpufem_torch.generate_annulus_mesh(12, 16))\n"
        "except ImportError as e:\n"
        "    assert 'matplotlib' in str(e), e\n"
        "    print('refused')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
