"""Squirmer-gait sweep: the food-capture campaign.

The counterpart of ``tpufem.workloads.sweep``.  The reference's headline
results are food-capture percentages across squirmer gaits, each a full
Stokes + tracer run with B2 changed:

    neutral (B1=−2, B2=0), pusher (B1=−2, B2=−5), puller (B1=−2, B2=+5)

:func:`food_capture_sweep` runs the campaign as one call, one gait after
the other on one device; :func:`food_capture_sweep_sharded` runs it as one
batched program, one gait a ``"data"`` position of a device mesh.  At f32 each gait is the fused dense step on
kernel K1 (``matvec_impl="pallas"``; tpufem leaves ``"xla"`` there, XLA's
compiled matvec, whose counterpart here, ``torch.addmv``, is K1's plain
version); at f64 the reference's unfused LU path with the ±1e10 penalty.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

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
    """The whole campaign as ONE sharded program: the gaits ride the
    ``"data"`` axis of ``device_mesh`` (one gait a ``"data"`` position,
    ``device_mesh.shape["data"] == len(b2_values)``), the inverse products
    its ``"space"`` axis.  A :class:`~tpufem_torch.parallel.spmd.ShardedEnsemble`
    of merged-pressure inverse steps in the configuration's precision, run
    by :func:`~tpufem_torch.parallel.spmd.run_sharded`: on one card one
    batch program for all gaits.  → {B2: {"eaten", "tracers",
    "consumed_fraction"}}."""
    from tpufem_torch.parallel.spmd import ShardedEnsemble, run_sharded

    b2s = np.asarray(config.b2_values)
    if device_mesh.shape["data"] != len(b2s):
        raise ValueError(f"one gait a 'data' position: build the device mesh with "
                         f"data={len(b2s)}, not {device_mesh.shape['data']}")
    cfg = stokes.StokesConfig(
        dt=config.dt, nu=config.nu, B1=config.b1, transport="tracers",
        tracer_density=config.tracer_density, precision=config.precision,
        pressure_mode="merge", solver="inverse",
    )
    ens = ShardedEnsemble.build(mesh, device_mesh, np.full(len(b2s), config.b1), b2s, config=cfg)
    _, eaten_series = run_sharded(ens, config.steps)
    n_tracers = ens.problem.tracer_init.shape[0]
    eaten = eaten_series[-1].cpu().numpy()  # waits for the device
    return {
        float(b2): {
            "eaten": int(eaten[i]),
            "tracers": n_tracers,
            "consumed_fraction": float(eaten[i]) / n_tracers,
        }
        for i, b2 in enumerate(b2s)
    }
