"""Squirmer-gait sweep: the food-capture campaign.

The counterpart of ``tpufem.workloads.sweep``.  The reference's headline
results are food-capture percentages across squirmer gaits, each a full
Stokes + tracer run with B2 changed:

    neutral (B1=−2, B2=0), pusher (B1=−2, B2=−5), puller (B1=−2, B2=+5)

:func:`food_capture_sweep` runs the campaign as one call, one gait after
the other on one device.  At f32 each gait is the fused dense step on
kernel K1 (``matvec_impl="pallas"``; tpufem leaves ``"xla"`` there, XLA's
compiled matvec, whose counterpart here, ``torch.addmv``, is K1's plain
version); at f64 the reference's unfused LU path with the ±1e10 penalty.
"""

from __future__ import annotations

import dataclasses
import time

from tpufem_torch.mesh.core import Mesh
from tpufem_torch.workloads import stokes


@dataclasses.dataclass
class SweepConfig:
    b1: float = -2.0
    b2_values: tuple[float, ...] = (0.0, -5.0, 5.0)  # neutral, pusher, puller
    steps: int = 6000
    dt: float = 0.01
    nu: float = 1.0
    tracer_density: int = 25
    precision: str = "f32"
    fused: bool = True


def food_capture_sweep(mesh: Mesh, config: SweepConfig = SweepConfig(), device=None) -> dict:
    """→ {B2: {"eaten", "tracers", "consumed_fraction", "seconds"}}, one run
    of ``config.steps`` steps a gait on ``device`` (see
    :func:`tpufem_torch.config.device`); ``seconds`` is the gait's wall
    time, its build included."""
    f64 = config.precision == "f64"
    results = {}
    for b2 in config.b2_values:
        t0 = time.perf_counter()
        cfg = stokes.StokesConfig(
            dt=config.dt, nu=config.nu, B1=config.b1, B2=b2, transport="tracers",
            tracer_density=config.tracer_density, precision=config.precision,
            pressure_mode="penalty" if f64 else "merge", solver="lu" if f64 else "inverse",
            fused=config.fused and not f64, matvec_impl="xla" if f64 else "pallas",
        )
        problem = stokes.StokesProblem.build(mesh, cfg, device=device)
        n_tracers = problem.tracer_init.shape[0]
        _, metrics = stokes.run(problem, steps=config.steps)
        eaten = int(metrics["eaten"][-1])  # waits for the device
        results[b2] = {
            "eaten": eaten,
            "tracers": n_tracers,
            "consumed_fraction": eaten / n_tracers,
            "seconds": time.perf_counter() - t0,
        }
    return results


def food_capture_sweep_sharded(mesh: Mesh, device_mesh, config: SweepConfig = SweepConfig()) -> dict:
    """The campaign as one sharded program, one gait a ``"data"`` shard:
    not ported yet."""
    raise NotImplementedError(
        "food_capture_sweep_sharded needs ShardedEnsemble, which is not ported to "
        "tpufem_torch yet (ROADMAP Queue 1 item 3 + 12)")
