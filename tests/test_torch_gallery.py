"""``tpufem_torch.gallery`` against tpufem's ``examples/make_gallery.py``:
the port's quick fields against the same tpufem call sequence on the
(14, 16) annulus (f64, 1e-12 relative), the flagship dye movie's quick
frames, every file the render writes, and the card default."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem
from tpufem import viz as jviz
from tpufem.bench_large import bench_config as jbench_config
from tpufem.ops import calculus as jcalculus
from tpufem.workloads import heat as jheat
from tpufem.workloads import poisson as jpoisson
from tpufem.workloads import stokes as jstokes
from tpufem_torch import gallery
from tpufem_torch import viz as tviz
from tpufem_torch.bench_large import bench_config as tbench_config
from tpufem_torch.mesh import generate_annulus_mesh
from tpufem_torch.ops import calculus as tcalculus
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.solve import grid_cg
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import rel

torch.set_num_threads(2)

RTOL = 1e-12


@functools.lru_cache(maxsize=None)
def tpufem_fields():
    """make_gallery.main(quick=True)'s computations, without the drawing."""
    mesh = tpufem.generate_annulus_mesh(n_side=14, n_circle=16)
    heat_steps, stokes_steps, food_steps, (anim_steps, anim_int) = 30, 20, 15, (8, 4)
    out = {"coords": mesh.coords, "tris": mesh.tris}
    out["poisson_f"] = np.asarray(jpoisson.solve(mesh)[0])
    out["heat_u"] = np.asarray(jheat.run(mesh, jheat.HeatConfig(steps=heat_steps))[0])
    prob = jstokes.StokesProblem.build(mesh, jstokes.StokesConfig(pressure_mode="merge"))
    state, _ = jstokes.run(prob, steps=stokes_steps)
    uu = np.asarray(state["u"])
    out["stokes_u"] = uu
    out["vorticity"] = np.asarray(jcalculus.vorticity(mesh, jnp.asarray(uu)))
    out["stokes_p"] = np.asarray(jstokes.projection_step(prob, state["u"])[1])
    probf = jstokes.StokesProblem.build(
        mesh, jstokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers", pressure_mode="merge"))
    statef, _, food = jviz.run_with_frames(probf, steps=food_steps,
                                           frame_interval=max(1, food_steps // 40),
                                           field=("u", "tracers", "tracer_status"))
    for k in ("u", "tracers", "tracer_status"):
        out[f"food_{k}"] = np.asarray(statef[k])
        out[f"food_frames_{k}"] = np.stack(food[k])
    # lattice tracers on a mesh edge, which tpufem's compiled locator loses
    # and its eager one (and the port's) finds (tests/test_torch_sweep.py)
    pts = jnp.asarray(probf.tracer_init)
    eager = np.asarray(probf.locator.find(pts)[1])
    compiled = np.asarray(jax.jit(lambda p: probf.locator.find(p)[1])(pts))
    out["ties"] = eager & ~compiled
    probd = jstokes.StokesProblem.build(
        mesh, jstokes.StokesConfig(transport="dye", pressure_mode="merge"))
    out["dye_frames"] = np.stack(jviz.run_with_frames(probd, steps=anim_steps,
                                                      frame_interval=anim_int)[2])
    return out


@functools.lru_cache(maxsize=None)
def port_fields():
    return gallery.fields(quick=True, device="cpu")


def tpufem_xl_frames(precision=None):
    """make_gallery.xl_dye_movie(quick=True)'s frames; ``precision``
    overrides bench_config's f32 in both packages alike."""
    mesh = tpufem.generate_annulus_mesh(n_side=14, n_circle=16, pad_hole=False)
    cfg = jbench_config("twolevel", n_nodes=int(mesh.n_nodes), transport="dye", storage="csr")
    if precision:
        cfg = dataclasses.replace(cfg, precision=precision)
    prob = jstokes.StokesProblem.build(mesh, cfg)
    return np.stack(jviz.run_with_frames(prob, steps=8, frame_interval=4)[2])


def test_gallery_sizes_are_make_gallerys():
    assert gallery.STEPS[True] == (30, 20, 15, 8, 4)
    assert gallery.STEPS[False] == (600, 300, 400, 300, 15)
    assert gallery.XL == dict(n_side=640, n_circle=720, steps=600, frame_interval=20)
    assert gallery.XL_QUICK == dict(n_side=14, n_circle=16, steps=8, frame_interval=4)
    mesh = gallery.gallery_mesh(quick=False)
    if tpufem.config.reference_mesh_path("mesh.1") is None:
        assert mesh.n_nodes == tpufem.generate_annulus_mesh().n_nodes


@pytest.mark.parametrize("key", ["poisson_f", "heat_u", "stokes_u", "stokes_p", "vorticity",
                                 "food_u", "dye_frames"])
def test_fields_match_make_gallery(key):
    want, got = tpufem_fields()[key], port_fields()[key]
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.isfinite(got).all()
    if key == "dye_frames":
        for g, w in zip(got, want):
            assert rel(g, w) <= RTOL
    else:
        assert rel(got, want) <= RTOL, key


def test_pressure_gradient_matches_make_gallery():
    """∇p as well as p: the gauge would show only in p."""
    want, got = tpufem_fields(), port_fields()
    mesh = gallery.gallery_mesh(quick=True)
    gp = tcalculus.gradient(mesh, torch.as_tensor(got["stokes_p"])).numpy()
    gw = np.asarray(jcalculus.gradient(tpufem.generate_annulus_mesh(n_side=14, n_circle=16),
                                       jnp.asarray(want["stokes_p"])))
    assert rel(gp, gw) <= RTOL


def test_food_tracers_match_make_gallery():
    want, got = tpufem_fields(), port_fields()
    ties = want["ties"]
    assert ties.sum() <= 2  # the counted lattice-edge ties of this mesh
    for k in ("food_frames_tracers", "food_tracers"):
        assert got[k].shape == want[k].shape
        g, w = got[k][..., ~ties, :], want[k][..., ~ties, :]
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max()
    for k in ("food_frames_tracer_status", "food_tracer_status"):
        np.testing.assert_array_equal(got[k][..., ~ties], want[k][..., ~ties])
    # a tie tracer the port finds can only be eaten where tpufem's stays put
    assert (got["food_tracer_status"][ties] >= want["food_tracer_status"][ties]).all()
    assert len(got["food_frames_u"]) == 16


def port_xl_frames(precision=None):
    """xl_fields(quick=True)'s call sequence, ``precision`` overriding
    bench_config's f32 as in :func:`tpufem_xl_frames`."""
    mesh = generate_annulus_mesh(n_side=14, n_circle=16, pad_hole=False)
    cfg = tbench_config("twolevel", n_nodes=int(mesh.n_nodes), transport="dye", storage="csr")
    if precision:
        cfg = dataclasses.replace(cfg, precision=precision)
    prob = tstokes.StokesProblem.build(mesh, cfg, device="cpu")
    return np.stack(tviz.run_with_frames(prob, steps=8, frame_interval=4)[2])


def test_xl_quick_sequence_matches_xl_dye_movie_at_f64():
    """The movie's quick sequence at f64 in both packages within 1e-12."""
    want, got = tpufem_xl_frames("f64"), port_xl_frames("f64")
    assert got.shape == want.shape == (3, 160) and got.dtype == np.float64
    for g, w in zip(got, want):
        assert rel(g, w) <= RTOL


@pytest.mark.parametrize("reference", ["f64", "f32"])
def test_xl_quick_fields_track_xl_dye_movie(reference):
    """xl_fields(quick=True) is that sequence at bench_config's f32: within
    1e-5 of tpufem's f64 and f32 frames, and its timings are consistent."""
    want = tpufem_xl_frames("f64" if reference == "f64" else None)
    got = gallery.xl_fields(quick=True, device="cpu")
    assert got["xl_dye_frames"].dtype == np.float32
    np.testing.assert_array_equal(got["xl_dye_frames"], port_xl_frames())
    assert rel(got["xl_dye_frames"], want) <= 1e-5
    assert float(got["xl_run_s"]) >= float(got["xl_copy_s"]) >= 0.0


def test_render_writes_every_file(tmp_path):
    """``--render`` of a saved gallery draws every file make_gallery's
    ``main`` writes (a GIF where no ffmpeg is installed), each non-empty."""
    npz = str(tmp_path / "gallery.npz")
    np.savez(npz, **port_fields())
    out = tmp_path / "out"
    written = gallery.main([str(out), "--render", npz])
    produced = set(os.listdir(out))
    for f in ("mesh.png", "poisson.png", "heat.png", "stokes_flow.png", "food.png"):
        assert f in produced, f
    assert any(f.startswith("dye_mixing.") for f in produced)
    assert any(f.startswith("food.") and f != "food.png" for f in produced)
    assert len(written) == len(produced) == 7
    assert all(os.path.getsize(p) > 1000 for p in written)


def test_xl_quick_cli_computes_saves_and_renders(tmp_path):
    before = (fm.fused_step_matvec.launches, grid_cg.viscous_cg.launches,
              grid_cg.pressure_cg.launches)
    written = gallery.main([str(tmp_path), "--xl-quick", "--device", "cpu"])
    assert (fm.fused_step_matvec.launches, grid_cg.viscous_cg.launches,
            grid_cg.pressure_cg.launches) == before  # no kernel on the CPU
    npz, movie = written
    assert npz.endswith("xl_dye.npz") and os.path.basename(movie).startswith("dye_0k.")
    data = np.load(npz)
    assert data["xl_dye_frames"].shape == (3, 160) and int(data["xl_steps"]) == 8
    assert os.path.getsize(movie) > 1000


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gallery.main([str(tmp_path), "--quick"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gallery.xl_fields(quick=True)
