"""The gallery: the reference's committed figures and movies from port runs.

The counterpart of tpufem's ``examples/make_gallery.py``, with the same
figures, sizes, step counts, configurations and file names, split in two:

* **compute** (:func:`fields`, :func:`xl_fields`): every run on the device,
  in ``make_gallery``'s call sequence; returns host arrays and frames,
  which ``main`` saves as one ``.npz``;
* **render** (:func:`render`): host only, through :mod:`tpufem_torch.viz`;
  it needs matplotlib.

::

    python -m tpufem_torch.gallery [outdir] [--quick | --xl | --xl-quick]
        [--device cuda|cpu]
    python -m tpufem_torch.gallery [outdir] --render OUTDIR/gallery.npz

writes ``mesh.png``, ``poisson.png``, ``heat.png``, ``stokes_flow.png``,
``food.png``, the food and dye-mixing movies (``.mp4`` where ffmpeg is
installed, else ``.gif``), or with ``--xl`` the flagship semi-Lagrangian
dye movie at 409,600 nodes (``dye_409k``).  The computing run always saves
its ``.npz`` and renders only where matplotlib imports; it prints which
one happened, and ``--render`` draws saved frames on another host.  The
default device is CUDA, which must exist; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch import viz
from tpufem_torch.mesh import Mesh, generate_annulus_mesh, load_mesh, mesh_from_arrays
from tpufem_torch.metrics import to_host

# make_gallery's step counts: (heat, stokes, food, dye movie, dye frame interval)
STEPS = {False: (600, 300, 400, 300, 15), True: (30, 20, 15, 8, 4)}
QUICK_MESH = (14, 16)
XL = dict(n_side=640, n_circle=720, steps=600, frame_interval=20)
XL_QUICK = dict(n_side=14, n_circle=16, steps=8, frame_interval=4)


def gallery_mesh(quick: bool = False) -> Mesh:
    """The reference's ``mesh.1`` where its checkout is present, else the
    generated annulus; the (14, 16) annulus under ``quick``."""
    if quick:
        return generate_annulus_mesh(n_side=QUICK_MESH[0], n_circle=QUICK_MESH[1])
    stem = tconfig.reference_mesh_path("mesh.1")
    return load_mesh(stem) if stem else generate_annulus_mesh()


def fields(mesh: Mesh | None = None, quick: bool = False, device=None) -> dict:
    """Every field and frame of the gallery (make_gallery's ``main``, f64):
    Poisson f, heat u, the Stokes u, p and vorticity, the food run's last
    state and frames, and the dye-mixing frames, as host arrays."""
    from tpufem_torch.ops import calculus
    from tpufem_torch.workloads import heat, poisson, stokes

    dev = tconfig.device(device)
    mesh = gallery_mesh(quick) if mesh is None else mesh
    heat_steps, stokes_steps, food_steps, anim_steps, anim_int = STEPS[quick]
    out = {"coords": mesh.coords, "tris": mesh.tris}

    f, _ = poisson.solve(mesh, device=dev)
    out["poisson_f"] = to_host(f)
    u, _ = heat.run(mesh, heat.HeatConfig(steps=heat_steps), device=dev)
    out["heat_u"] = to_host(u)

    prob = stokes.StokesProblem.build(mesh, stokes.StokesConfig(pressure_mode="merge"),
                                      device=dev)
    state, _ = stokes.run(prob, steps=stokes_steps)
    out["stokes_u"] = to_host(state["u"])
    out["vorticity"] = to_host(calculus.vorticity(mesh, state["u"]))
    # the pressure of one more projection step
    _, p, _, _ = stokes.projection_step(prob, state["u"])
    out["stokes_p"] = to_host(p)

    probf = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers", pressure_mode="merge"),
        device=dev)
    statef, _, food = viz.run_with_frames(probf, steps=food_steps,
                                          frame_interval=max(1, food_steps // 40),
                                          field=("u", "tracers", "tracer_status"))
    for k in ("u", "tracers", "tracer_status"):
        out[f"food_{k}"] = to_host(statef[k])
        out[f"food_frames_{k}"] = np.stack(food[k])

    probd = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(transport="dye", pressure_mode="merge"), device=dev)
    _, _, dye = viz.run_with_frames(probd, steps=anim_steps, frame_interval=anim_int)
    out["dye_frames"] = np.stack(dye)
    return out


def xl_problem(n_side: int = XL["n_side"], n_circle: int = XL["n_circle"],
               quick: bool = False, device=None):
    """The flagship movie's problem: ``bench_config(transport="dye")`` on the
    pad_hole annulus, ``"auto"`` storage (the grid path on CUDA at f32);
    under ``quick`` the compacted annulus on CSR.  → (problem, host build
    seconds, the locator's build included)."""
    from tpufem_torch.bench_large import bench_config
    from tpufem_torch.workloads import stokes

    dev = tconfig.device(device)
    t0 = time.perf_counter()
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=not quick)
    cfg = bench_config("twolevel", n_nodes=int(mesh.n_nodes), transport="dye",
                       storage="csr" if quick else "auto")
    problem = stokes.StokesProblem.build(mesh, cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return problem, time.perf_counter() - t0


def xl_run(problem, steps: int, frame_interval: int) -> dict:
    """The movie's run: the dye in chunks of ``frame_interval`` steps with
    a host frame after each, as ``viz.run_with_frames`` → the frames and
    its timings: wall seconds of the run (synchronised), of which the
    frames' host copies took ``copy_s`` (each timed after the device
    finished its chunk)."""
    from tpufem_torch.workloads import stokes

    def sync():
        if problem.device.type == "cuda":
            torch.cuda.synchronize(problem.device)

    def snapshot(state):
        nonlocal copy_s
        sync()
        t0 = time.perf_counter()
        frames.append(to_host(state["c"]))
        copy_s += time.perf_counter() - t0

    sync()
    t0 = time.perf_counter()
    copy_s, frames, metrics, done = 0.0, [], [], 0
    state = stokes.initial_state(problem)
    snapshot(state)
    while done < steps:
        chunk = min(frame_interval, steps - done)
        state, m = stokes.run(problem, steps=chunk, state=state)
        snapshot(state)
        metrics.append(m)
        done += chunk
    sync()
    return {"frames": frames, "state": state, "metrics": metrics,
            "run_s": time.perf_counter() - t0, "copy_s": copy_s}


def xl_fields(n_side: int = XL["n_side"], n_circle: int = XL["n_circle"],
              steps: int = XL["steps"], frame_interval: int = XL["frame_interval"],
              quick: bool = False, device=None) -> dict:
    """The flagship semi-Lagrangian dye movie's frames (make_gallery's
    ``xl_dye_movie``; ``quick``: its smoke sizes), as host arrays, with the
    run's timings."""
    if quick:
        n_side, n_circle = XL_QUICK["n_side"], XL_QUICK["n_circle"]
        steps, frame_interval = XL_QUICK["steps"], XL_QUICK["frame_interval"]
    problem, build_s = xl_problem(n_side, n_circle, quick, device)
    run = xl_run(problem, steps, frame_interval)
    mesh = problem.mesh
    return {"xl_coords": mesh.coords, "xl_tris": mesh.tris, "xl_quick": np.asarray(quick),
            "xl_dye_frames": np.stack(run["frames"]), "xl_steps": np.asarray(steps),
            "xl_build_s": np.asarray(build_s), "xl_run_s": np.asarray(run["run_s"]),
            "xl_copy_s": np.asarray(run["copy_s"])}


def render(data, outdir: str) -> list[str]:
    """Draw every figure and movie whose arrays ``data`` holds (a dict, or a
    loaded ``.npz``) into ``outdir``, as make_gallery does; returns the
    paths written.  Host only; needs matplotlib."""
    os.makedirs(outdir, exist_ok=True)
    written = []
    if "coords" in data:
        mesh = mesh_from_arrays(data["coords"], data["tris"])
        ax = viz.plot_mesh(mesh)
        ax.figure.savefig(f"{outdir}/mesh.png", dpi=110)
        for key, name, label, title in (
                ("poisson_f", "poisson", "f(x, y)", "FEM Poisson, periodic x + Dirichlet"),
                ("heat_u", "heat", "u", "Implicit heat equation, 600 steps")):
            ax = viz.plot_scalar(mesh, data[key], label=label)
            ax.set_title(title)
            ax.figure.savefig(f"{outdir}/{name}.png", dpi=110)
        viz.dashboard(mesh, data["stokes_u"], data["stokes_p"], vorticity=data["vorticity"],
                      path=f"{outdir}/stokes_flow.png")
        ax = viz.tracer_frame(mesh, data["food_u"], data["food_tracers"],
                              data["food_tracer_status"])
        ax.set_title("Squirmer food capture")
        ax.figure.savefig(f"{outdir}/food.png", dpi=110)
        written += [f"{outdir}/{n}.png" for n in ("mesh", "poisson", "heat", "stokes_flow",
                                                   "food")]
        written.append(viz.animate_tracers(
            mesh, data["food_frames_u"], data["food_frames_tracers"],
            data["food_frames_tracer_status"], path=f"{outdir}/food.mp4", fps=8))
        written.append(viz.animate(mesh, data["dye_frames"],
                                   path=f"{outdir}/dye_mixing.mp4", fps=8))
        import matplotlib.pyplot as plt

        plt.close("all")
    if "xl_coords" in data:
        mesh = mesh_from_arrays(data["xl_coords"], data["xl_tris"])
        quick = bool(data["xl_quick"])
        written.append(viz.animate(mesh, data["xl_dye_frames"],
                                   path=f"{outdir}/dye_{mesh.n_nodes // 1000}k.mp4", fps=8,
                                   dpi=40 if quick else 72))
    return written


def can_render() -> bool:
    """Whether matplotlib imports here (the renderer needs it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(prog="python -m tpufem_torch.gallery")
    parser.add_argument("outdir", nargs="?", default="gallery_torch")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true", help="make_gallery's smoke sizes")
    mode.add_argument("--xl", action="store_true",
                      help="the flagship dye movie at 409,600 nodes (600 steps)")
    mode.add_argument("--xl-quick", action="store_true", help="the flagship movie's smoke size")
    mode.add_argument("--render", metavar="NPZ", default=None,
                      help="draw the frames a computing run saved, and compute nothing")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.render:
        written = render(np.load(args.render), args.outdir)
        print(f"rendered {len(written)} files from {args.render} into {args.outdir}/")
        return written
    os.makedirs(args.outdir, exist_ok=True)
    if args.xl or args.xl_quick:
        data = xl_fields(quick=args.xl_quick, device=args.device)
        path = f"{args.outdir}/xl_dye.npz"
        print(f"xl dye: {len(data['xl_dye_frames'])} frames of {len(data['xl_coords'])} nodes, "
              f"{int(data['xl_steps'])} steps; build {float(data['xl_build_s']):.2f} s, run "
              f"{float(data['xl_run_s']):.2f} s (frame copies {float(data['xl_copy_s']):.2f} s)")
    else:
        data = fields(quick=args.quick, device=args.device)
        path = f"{args.outdir}/gallery.npz"
    np.savez(path, **data)
    if not can_render():
        print(f"saved {path}; not rendered: matplotlib is not installed here (render it with "
              f"python -m tpufem_torch.gallery OUTDIR --render {path} on a host that has it)")
        return [path]
    written = render(data, args.outdir)
    print(f"saved {path}; rendered {len(written)} files into {args.outdir}/: "
          f"{', '.join(os.path.basename(w) for w in written)}")
    return [path] + written


if __name__ == "__main__":
    main()
