"""tpufem_torch host set-up against tpufem: meshes, mesh files, boundary
sets, locator tables and pressure merge maps must be array-equal."""

import dataclasses

import numpy as np
import pytest
import torch

from tpufem import bc as jbc
from tpufem import transport as jtransport
from tpufem.mesh import generate_rect_mesh as j_rect
from tpufem.mesh import io as jio
from tpufem.solve import pressure as jpressure
from tpufem.workloads import stokes as jstokes
from tpufem_torch import bc as tbc
from tpufem_torch import config as tconfig
from tpufem_torch import transport as ttransport
from tpufem_torch.mesh import generate_rect_mesh as t_rect
from tpufem_torch.mesh import load_mesh as t_load
from tpufem_torch.solve import pressure as tpressure
from tpufem_torch.workloads import stokes as tstokes

from tests._torch_parity import meshes

torch.set_num_threads(2)

MESH_CASES = [(12, 16, False), (20, 24, False), (12, 16, True)]
_FIELDS = ("coords", "tris", "markers", "det", "area", "grads", "valid", "holes")


def _assert_mesh_equal(jm, tm):
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)


@pytest.mark.parametrize("n_side,n_circle,pad_hole", MESH_CASES)
def test_generated_annulus_mesh_equal(n_side, n_circle, pad_hole):
    jm, tm = meshes(n_side, n_circle, pad_hole)
    _assert_mesh_equal(jm, tm)


def test_rect_mesh_equal():
    _assert_mesh_equal(j_rect(7, 5), t_rect(7, 5))


def test_mesh_files_read_back_equal(tmp_path):
    jm, _ = meshes(12, 16)
    stem = str(tmp_path / "annulus")
    jio.write_node(stem + ".node", jm.coords, jm.markers)
    jio.write_ele(stem + ".ele", jm.tris)
    with open(stem + ".poly", "w") as f:  # empty node section, 2 segments, 1 hole
        f.write("0 2 0 1\n2 1\n1 1 2 1\n2 2 3 2\n1\n1 0.5 0.5\n")
    tm = t_load(stem)
    for name in ("coords", "tris", "markers", "det", "area", "grads", "valid"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(tm.segments, [[0, 1], [1, 2]])
    np.testing.assert_array_equal(tm.seg_markers, [1, 2])
    np.testing.assert_array_equal(tm.holes, [[0.5, 0.5]])


@pytest.mark.parametrize("n_side,n_circle,all_walls", [(12, 16, False), (20, 24, False), (12, 16, True)])
def test_channel_boundary_equal(n_side, n_circle, all_walls):
    jm, tm = meshes(n_side, n_circle)
    jb = jbc.ChannelBoundary.build(jm, all_walls=all_walls)
    tb = tbc.ChannelBoundary.build(tm, all_walls=all_walls)
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(tb, f.name), getattr(jb, f.name), err_msg=f.name)
    idx = tb.index_tensors("cpu")
    np.testing.assert_array_equal(idx["slaves"].numpy(), jb.slaves)


@pytest.mark.parametrize("n_side,n_circle,g", [(12, 16, 8), (20, 24, 16), (20, 24, 27)])
def test_grid_locator_tables_equal(n_side, n_circle, g):
    jm, tm = meshes(n_side, n_circle)
    jl = jtransport.GridLocator.build(jm, g=g)
    tl = ttransport.GridLocator.build(tm, g=g)
    np.testing.assert_array_equal(tl.cells, jl.cells)
    np.testing.assert_array_equal(tl.rows.numpy(), jl.rows)
    np.testing.assert_array_equal(tl.origin.numpy(), np.asarray(jl.origin))
    np.testing.assert_array_equal(tl.extent.numpy(), np.asarray(jl.extent))


@pytest.mark.parametrize("n_side,n_circle", [(12, 16), (20, 24)])
def test_auto_locator_choice_equal(n_side, n_circle):
    jm, tm = meshes(n_side, n_circle)
    jl = jstokes._make_locator(jm, jstokes.StokesConfig())
    tl = tstokes._make_locator(tm, tstokes.StokesConfig(), torch.float64, "cpu")
    assert tl.g == jl.g
    np.testing.assert_array_equal(tl.cells, jl.cells)


@pytest.mark.parametrize("n_side,n_circle", [(12, 16), (20, 24)])
def test_pressure_merge_maps_equal(n_side, n_circle):
    jm, _ = meshes(n_side, n_circle)
    b = jbc.ChannelBoundary.build(jm)
    n = jm.n_nodes
    np.testing.assert_array_equal(
        tpressure.owner_map(n, b.masters, b.slaves), jpressure.owner_map(n, b.masters, b.slaves)
    )
    np.testing.assert_array_equal(
        tpressure.merge_map(n, b.masters, b.slaves), jpressure.merge_map(n, b.masters, b.slaves)
    )


def test_tracer_seed_lattice_equal():
    np.testing.assert_array_equal(
        ttransport.init_tracer_grid(15), jtransport.init_tracer_grid(15)
    )


def test_config_dtype_and_device_policy():
    assert tconfig.dtype("f64") is torch.float64
    assert tconfig.dtype("f32") is torch.float32
    assert tconfig.dtype("bf16") is torch.bfloat16
    with pytest.raises(ValueError):
        tconfig.dtype("bf16", bf16=False)
    with pytest.raises(ValueError):
        tconfig.dtype("f16")
    assert tconfig.device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal cannot be shown here")
    for name in (None, "cuda"):  # no default to the CPU: the card or an error
        with pytest.raises(RuntimeError):
            tconfig.device(name)
