"""Command-line entry points: one subcommand per workload, as ``tpufem.cli``.

    python -m tpufem_torch poisson --mesh mesh2.1 --out out/
    python -m tpufem_torch heat    --mesh mesh2.1 --steps 600
    python -m tpufem_torch stokes  --mesh mesh.1 --transport dye --b2 5 --steps 1000
    python -m tpufem_torch food    --mesh mesh_fine.1 --steps 1000 --precision f32
    python -m tpufem_torch report  --mesh mesh5.1 --steps 500
    python -m tpufem_torch ns      --mesh mesh2.1 --steps 1000
    python -m tpufem_torch monolithic --mesh mesh.1
    python -m tpufem_torch taylorhood --mesh mesh2.2 [--sparse] [--steps N]
    python -m tpufem_torch stam    --frames 400
    python -m tpufem_torch ad      --mesh mesh2.1
    python -m tpufem_torch graph   --mesh mesh.1
    python -m tpufem_torch sweep   --mesh mesh.1
    python -m tpufem_torch converge --study self|th|ns
    python -m tpufem_torch bench [--large --sizes 160k ...]

The same subcommands, flags, defaults and JSON lines as tpufem's CLI, with
two differences: ``food --precision f32`` takes the gait campaign's fused
step (kernel K1), and ``taylorhood`` builds the P2 mesh of a P1 one on
every path.  Every run is on the card unless ``--device`` (before the
subcommand) names another torch device, e.g. ``python -m tpufem_torch
--device cpu poisson``.

``--mesh`` takes a reference mesh stem (resolved through
``TPUFEM_REFERENCE_DIR``), a path stem of Triangle ``.node``/``.ele`` files,
or ``generated``.  ``--out DIR`` writes the metrics JSONL, the final state
(``save_state`` npz) and a PNG of the final field; the PNG needs matplotlib
on the host.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from tpufem_torch.metrics import to_host


def _resolve_mesh(spec: str):
    import tpufem_torch
    from tpufem_torch import config as cfg

    if spec == "generated":
        return tpufem_torch.generate_annulus_mesh()
    stem = cfg.reference_mesh_path(spec)
    if stem is None and os.path.exists(spec + ".node"):
        stem = spec
    if stem is None:
        raise SystemExit(f"mesh {spec!r} not found (bundled name, path stem, or 'generated')")
    return tpufem_torch.load_mesh(stem)


def _common(sub, mesh_default="mesh.1"):
    sub.add_argument("--mesh", default=mesh_default)
    sub.add_argument("--out", default=None, help="output directory")
    sub.add_argument("--steps", type=int, default=None)
    sub.add_argument("--verbose", action="store_true",
                     help="print reference-style per-step lines after the run")


def _speed(u) -> np.ndarray:
    return np.linalg.norm(to_host(u), axis=1)


def _finish(args, name, state_or_field, metrics=None, mesh=None, field=None):
    out = args.out
    if metrics is not None:
        from tpufem_torch.metrics import summarize

        if getattr(args, "verbose", False):
            from tpufem_torch.metrics import print_reference_style

            print_reference_style(metrics, every=max(1, len(next(iter(metrics.values()))) // 50))
        print(json.dumps({name: summarize(metrics)}, indent=None, default=float))
    if out:
        os.makedirs(out, exist_ok=True)
        if metrics is not None:
            from tpufem_torch.metrics import write_jsonl

            write_jsonl(os.path.join(out, f"{name}_metrics.jsonl"), metrics)
        if isinstance(state_or_field, dict):
            from tpufem_torch.checkpoint import save_state

            save_state(os.path.join(out, f"{name}_state.npz"), state_or_field)
        if mesh is not None and field is not None:
            from tpufem_torch import viz

            ax = viz.plot_scalar(mesh, field)
            ax.figure.savefig(os.path.join(out, f"{name}.png"), dpi=120)
        print(f"outputs written to {out}/")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tpufem_torch")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card, cuda)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    for name in ("poisson", "heat", "stokes", "food", "report", "ns",
                 "monolithic", "taylorhood", "ad", "graph"):
        s = sub.add_parser(name)
        _common(s)
        if name == "taylorhood":
            s.add_argument("--sparse", action="store_true",
                           help="Uzawa-CG sparse path (any mesh size; P2 built in-process "
                                "if needed)")
        if name in ("stokes", "food"):
            s.add_argument("--b1", type=float, default=-2.0)
            s.add_argument("--b2", type=float, default=0.0)
            s.add_argument("--precision", default="f64", choices=["f64", "f32"])
            s.add_argument("--transport", default=None)
    s = sub.add_parser("sweep")
    _common(s)
    s = sub.add_parser("stam")
    s.add_argument("--frames", type=int, default=400)
    s.add_argument("--size", type=int, default=200)
    s.add_argument("--out", default=None)
    s = sub.add_parser("converge")
    s.add_argument("--study", default="self", choices=["self", "th", "ns"])
    s.add_argument("--sizes", default=None)
    s.add_argument("--steps0", type=int, default=None)
    s.add_argument("--storage", default="auto")
    s.add_argument("--out", default=None)
    s = sub.add_parser("bench")
    s.add_argument("--large", action="store_true",
                   help="large-mesh scaling sweep (tpufem_torch.bench_large)")
    s.add_argument("--steps", type=int, default=50)
    s.add_argument("--sizes", default=None)
    s.add_argument("--precond", default="twolevel")
    s.add_argument("--bench-out", default=None)
    s.add_argument("--bench-transport", default=None,
                   help="large sweep transport: none | tracers | dye")
    s.add_argument("--bench-storage", default=None,
                   help="large sweep cg_storage: auto | grid | stencil | banded | csr")
    s.add_argument("--bench-mesh", default=None,
                   help="imported mesh stem (e.g. mesh_fine.1) for --large")
    s.add_argument("--no-pad-hole", action="store_true")
    s.add_argument("--th", action="store_true",
                   help="--large: sparse Taylor–Hood timed run + same-mesh P1/P1 divergence "
                        "comparison")
    s.add_argument("--ns", action="store_true",
                   help="--large: matrix-free Navier–Stokes scaling rows")
    s.add_argument("--poisson", action="store_true",
                   help="--large: matrix-free steady Poisson rows")
    s.add_argument("--heat", action="store_true",
                   help="--large: matrix-free implicit-Euler heat rows")
    s.add_argument("--n-side", type=int, default=96, help="--large --th mesh resolution")
    s.add_argument("--hbm-io", default=None,
                   help="--large: tpufem's TPU kernel layout; accepted, changes nothing here")
    s.add_argument("--bench-precision", default=None,
                   help="--large --th/--ns precision override (f32 | f64)")
    s.add_argument("--engine", default=None,
                   help="--large --th engine: csr | grid (kernels K2/K3)")
    return parser


def _bench_large_argv(args) -> list[str]:
    """``bench --large``'s flags as ``tpufem_torch.bench_large.main`` takes
    them (``--hbm-io`` is a TPU layout: dropped)."""
    argv = ["--steps", str(args.steps), "--precond", args.precond]
    for flag, value in (("--sizes", args.sizes), ("--out", args.bench_out),
                        ("--transport", args.bench_transport),
                        ("--storage", args.bench_storage), ("--mesh", args.bench_mesh),
                        ("--precision", args.bench_precision), ("--engine", args.engine)):
        if value:
            argv += [flag, value]
    if args.no_pad_hole:
        argv += ["--no-pad-hole"]
    if args.th:
        argv += ["--th", "--n-side", str(args.n_side)]
    for flag in ("ns", "poisson", "heat"):
        if getattr(args, flag):
            argv += [f"--{flag}"]
    return argv


def _stokes_config(args):
    from tpufem_torch.workloads import stokes

    f64 = args.precision == "f64"
    dense = dict(pressure_mode="penalty" if f64 else "merge", solver="lu" if f64 else "inverse")
    if args.cmd == "stokes":
        return stokes.StokesConfig(B1=args.b1, B2=args.b2, precision=args.precision,
                                   transport=args.transport or "dye", **dense)
    # food at f32 takes the gait campaign's fused step, on kernel K1
    return stokes.StokesConfig(dt=0.01, nu=1.0, B1=args.b1, B2=args.b2, transport="tracers",
                               precision=args.precision, fused=not f64,
                               matvec_impl="xla" if f64 else "pallas", **dense)


def _taylorhood(args, mesh, dev):
    from tpufem_torch.mesh.p2 import p2_refine
    from tpufem_torch.workloads import navier_stokes as ns

    # a P1 mesh gets its P2 connectivity in-process
    m2 = mesh if mesh.tris_p2 is not None else p2_refine(
        mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    if args.sparse:
        from tpufem_torch.workloads import th_sparse

        steps = args.steps or 200
        prob = th_sparse.SparseTHProblem.build(m2, th_sparse.SparseTHConfig(steps=steps),
                                               device=dev)
        u, p, metrics = th_sparse.run(prob, host_loop=True)
        print(json.dumps({"taylorhood_sparse": {
            "n2": int(prob.n2), "n1": int(prob.n1), "steps": steps,
            "max_u": float(u.abs().max()),
            "div_weak_max": float(metrics["div_weak_max"].reshape(-1)[-1]),
            "final_div_max": float(metrics["final_div_max"].reshape(-1)[-1]),
        }}))
    elif args.steps:  # transient θ-scheme run
        prob = ns.TransientTHProblem.build(m2, ns.TransientTHConfig(steps=args.steps), device=dev)
        u, p, metrics = ns.run_transient_th(prob)
        print(json.dumps({"taylorhood": {"steps": args.steps, "max_u": float(u.abs().max()),
                                         "div_max": float(metrics["div_max"][-1])}}))
    else:
        u, p, res = ns.solve_taylor_hood(m2, device=dev)
        print(json.dumps({"taylorhood": {"residual": float(res),
                                         "max_u": float(u.abs().max())}}))
    _finish(args, "taylorhood", None, mesh=m2, field=_speed(u))


def main(argv=None):
    args = _parser().parse_args(argv)
    from tpufem_torch import config as tconfig

    if args.cmd == "converge":
        from tpufem_torch import convergence

        conv_argv = ["--study", args.study, "--storage", args.storage]
        if args.sizes:
            conv_argv += ["--sizes", args.sizes]
        if args.steps0:
            conv_argv += ["--steps0", str(args.steps0)]
        if args.out:
            conv_argv += ["--out", args.out]
        if args.device:
            conv_argv += ["--device", args.device]
        return convergence.main(conv_argv)

    if args.cmd == "bench":
        if args.large:
            from tpufem_torch import bench_large

            bench_large.main(_bench_large_argv(args))
            return
        from tpufem_torch import bench

        bench.main()
        return

    dev = tconfig.device(args.device)

    if args.cmd == "stam":
        from tpufem_torch.workloads import stam_grid

        cfg = stam_grid.StamConfig(size=args.size)
        state, max_speed = stam_grid.run(cfg, frames=args.frames, device=dev)
        print(json.dumps({"stam": {"frames": args.frames,
                                   "final_max_speed": float(to_host(max_speed)[-1])}}))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.save(os.path.join(args.out, "stam_density.npy"), to_host(state["density"]))
        return

    mesh = _resolve_mesh(args.mesh)

    if args.cmd == "poisson":
        from tpufem_torch.workloads import poisson

        f, res = poisson.solve(mesh, device=dev)
        print(json.dumps({"poisson": {"residual": float(res)}}))
        _finish(args, "poisson", None, mesh=mesh, field=f)
    elif args.cmd == "heat":
        from tpufem_torch.workloads import heat

        u, maxu = heat.run(mesh, heat.HeatConfig(steps=args.steps or 600), device=dev)
        _finish(args, "heat", None, metrics={"max_u": maxu}, mesh=mesh, field=u)
    elif args.cmd in ("stokes", "food", "report"):
        from tpufem_torch.workloads import stokes

        if args.cmd == "report":
            cfg = stokes.StokesConfig(variant="report", bc_kind="rotating", dt=1e-5,
                                      ramp_steps=200, pressure_smoothing=0.01,
                                      double_projection=False)
        else:
            cfg = _stokes_config(args)
        problem = stokes.StokesProblem.build(mesh, cfg, device=dev)
        state, metrics = stokes.run(problem, steps=args.steps or 1000)
        field = state["c"] if "c" in state else _speed(state["u"])
        _finish(args, args.cmd, state, metrics=metrics, mesh=mesh, field=field)
    elif args.cmd == "ns":
        from tpufem_torch.workloads import navier_stokes as ns

        problem = ns.NSProblem.build(mesh, ns.NSConfig(), device=dev)
        u, metrics = ns.run(problem, steps=args.steps or 1000)
        _finish(args, "ns", None, metrics=metrics, mesh=mesh, field=_speed(u))
    elif args.cmd == "monolithic":
        from tpufem_torch.workloads import navier_stokes as ns

        u, p, res = ns.solve_monolithic(mesh, device=dev)
        print(json.dumps({"monolithic": {"residual": float(res),
                                         "max_u": float(u.abs().max())}}))
        _finish(args, "monolithic", None, mesh=mesh, field=p)
    elif args.cmd == "taylorhood":
        _taylorhood(args, mesh, dev)
    elif args.cmd == "ad":
        from tpufem_torch.workloads import advection_diffusion as ad

        problem = ad.ADProblem.build(mesh, ad.ADConfig(steps=args.steps or 1000), device=dev)
        f, maxf = ad.run(problem)
        _finish(args, "ad", None, metrics={"max_f": maxf}, mesh=mesh, field=f)
    elif args.cmd == "sweep":
        from tpufem_torch.workloads import sweep as sweep_mod

        cfg = sweep_mod.SweepConfig(steps=args.steps) if args.steps else sweep_mod.SweepConfig()
        res = sweep_mod.food_capture_sweep(mesh, cfg, device=dev)
        print(json.dumps({"sweep": {str(b2): round(100 * r["consumed_fraction"], 1)
                                    for b2, r in res.items()}}))
    elif args.cmd == "graph":
        from tpufem_torch.workloads import graph_average

        f, res = graph_average.solve(mesh, device=dev)
        print(json.dumps({"graph": {"residual": float(res)}}))
        _finish(args, "graph", None, mesh=mesh, field=f)


if __name__ == "__main__":
    main()
