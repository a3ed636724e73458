"""The gait campaign (``workloads.sweep``) against tpufem's at reduced
steps on a generated mesh: the same eaten counts at f64, fractions within
0.05 at f32 (the port through K1's wrapper, its plain version on the CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem import transport as jtransport
from tpufem.workloads import stokes as jstokes
from tpufem.workloads import sweep as jsweep
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.workloads import sweep as tsweep

from tests._torch_parity import meshes

torch.set_num_threads(2)

STEPS = 100
MESH = (12, 16)


@functools.lru_cache(maxsize=None)
def jax_sweep(precision):
    jm, _ = meshes(*MESH)
    return jsweep.food_capture_sweep(jm, jsweep.SweepConfig(steps=STEPS, precision=precision))


def compiled_locator_ties() -> int:
    """The sweep's initial tracers that tpufem's compiled locator does not
    find but its eager one (and the port's) does: lattice points on a mesh
    edge, where XLA's compiled rounding puts a barycentric weight of 0 a
    hair below 0 in both triangles.  tpufem's campaign (one compiled
    ``stokes.run`` a gait) leaves such a tracer where it starts, with no
    velocity, for the whole run; the port, like tpufem's eager step, moves
    it.  On (12, 16) two lattice points, (0.0875, 0.0875) and (0.725,
    0.725), are such ties; none goes the other way."""
    jm, _ = meshes(*MESH)
    cfg = jstokes.StokesConfig(transport="tracers", tracer_density=jsweep.SweepConfig().tracer_density)
    loc = jstokes._make_locator(jm, cfg)
    pts = jnp.asarray(jtransport.init_tracer_grid(cfg.tracer_density, exclude_center=cfg.center,
                                                  exclude_radius=0.25))
    eager = np.asarray(loc.find(pts)[1])
    compiled = np.asarray(jax.jit(lambda p: loc.find(p)[1])(pts))
    assert not np.any(compiled & ~eager)
    return int(np.sum(eager & ~compiled))


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_sweep_matches_tpufem(precision):
    want = jax_sweep(precision)
    ties = compiled_locator_ties()
    assert ties == 2
    _, tm = meshes(*MESH)
    before = fm.fused_step_matvec.launches
    got = tsweep.food_capture_sweep(tm, tsweep.SweepConfig(steps=STEPS, precision=precision),
                                    device="cpu")
    assert fm.fused_step_matvec.launches == before  # no kernel on the CPU
    assert list(got) == list(want) == [0.0, -5.0, 5.0]
    for b2, w in want.items():
        g = got[b2]
        assert g["tracers"] == w["tracers"] > 0
        assert 0.0 <= g["consumed_fraction"] <= 1.0 and g["seconds"] > 0
        if precision == "f64":
            # equal, up to the tie tracers tpufem's compiled run leaves behind
            assert w["eaten"] <= g["eaten"] <= w["eaten"] + ties, b2
        else:
            assert abs(g["consumed_fraction"] - w["consumed_fraction"]) <= 0.05, b2
    # the gaits differ: the campaign is not one run three times
    assert len({g["eaten"] for g in got.values()}) > 1


def test_sweep_config_defaults_match_tpufem():
    assert tsweep.SweepConfig() == tsweep.SweepConfig(**vars(jsweep.SweepConfig()))
