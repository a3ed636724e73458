"""GPU twin of the repo-root ``bench.py``: the squirmer Stokes + ~10k-tracer
food-capture run on the dense fused path, with kernel K1 doing each step.

Same configuration and mesh as ``bench.py`` (``mesh_fine.1`` when the
reference meshes are present, else ``generate_annulus_mesh(33, 48)``), run
for 1000 steps twice on one CUDA device:

* cold: the first run, which includes K1's ``nvcc`` build (unless it is
  cached under ``tpufem_torch/_build/``) and every first launch;
* warm: the second run of the same problem.

Run it with ``python -m tpufem_torch.bench``.  It prints one JSON line with
both rates, the tracer count, the card's name and power limit, and a
device-time breakdown of a further 50 steps under ``torch.profiler``.
There is no CPU fallback: without a CUDA device it fails.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from tpufem_torch import config as tconfig
from tpufem_torch.mesh import generate_annulus_mesh, load_mesh
from tpufem_torch.workloads import stokes

BENCH_STEPS = 1000
PROFILE_STEPS = 50
TRACER_DENSITY = 115  # 115×115 lattice minus the cylinder: ~10k tracers


def bench_mesh(name: str = "mesh_fine.1", fallback=(33, 48)):
    """The reference mesh ``name`` when present, else the generated stand-in."""
    stem = tconfig.reference_mesh_path(name)
    if stem is not None:
        return load_mesh(stem)
    return generate_annulus_mesh(n_side=fallback[0], n_circle=fallback[1])


def bench_config(**overrides) -> stokes.StokesConfig:
    """``bench.py``'s configuration, with the matvec on kernel K1."""
    kw = dict(
        dt=0.01, nu=1.0, transport="tracers", tracer_density=TRACER_DENSITY,
        solver="inverse", precision="f32", pressure_mode="merge", fused=True,
        matvec_impl="pallas",
    )
    kw.update(overrides)
    return stokes.StokesConfig(**kw)


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def timed_run(problem: stokes.StokesProblem, steps: int):
    """One ``run`` of ``steps`` steps from the initial state, synchronised:
    → (steps/s, state, metrics)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = stokes.run(problem, steps=steps)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0), state, metrics


def profile_steps(problem: stokes.StokesProblem, steps: int, top: int = 8,
                  state: dict | None = None) -> dict:
    """Device kernels of one ``steps``-step run (from ``state``, default the
    initial state) under ``torch.profiler``: kernel launches and device ms
    per step, and the ``top`` kernels by device time.  Profiling slows the
    host, so no wall time is taken here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stokes.run(problem, steps=steps, state=state)
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us() / 1e3
    launches = sum(n for n, _ in by_name.values())
    busy_ms = sum(ms for _, ms in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "kernels_per_step": launches / steps,
        "device_ms_per_step": busy_ms / steps,
        "top": [{"name": name[:80], "per_step": n / steps, "ms_per_step": ms / steps}
                for name, (n, ms) in ranked],
    }


def main() -> None:
    dev = tconfig.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = bench_mesh()
    problem = stokes.StokesProblem.build(mesh, bench_config(), device=dev)
    cold, _, _ = timed_run(problem, BENCH_STEPS)
    warm, state, metrics = timed_run(problem, BENCH_STEPS)
    u = state["u"]
    if not bool(torch.isfinite(u).all()):
        raise RuntimeError("bench run diverged")
    n_tracers = problem.tracer_init.shape[0]
    prof = profile_steps(problem, PROFILE_STEPS)
    prof["device_busy_share"] = prof["device_ms_per_step"] * warm / 1e3
    print(json.dumps({
        "metric": (f"Stokes+tracer steps/sec ({mesh.n_nodes} nodes, {BENCH_STEPS} steps, "
                   f"{n_tracers} tracers, f32 fused path, K1 CUDA kernel)"),
        "cold_steps_per_s": cold,
        "warm_steps_per_s": warm,
        "unit": "steps/sec",
        "tracers": n_tracers,
        "captured_fraction": float(metrics["eaten"][-1]) / n_tracers,
        "device": torch.cuda.get_device_name(dev),
        "card": card(),
        "profile": prof,
    }))


if __name__ == "__main__":
    main()
