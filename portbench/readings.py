"""The readings the limits of ``checks/<workload>.json`` are set from.

    python3 portbench/readings.py --workload NAME --seeds 1 2 3 ... \
        [--control-seeds 4 5 6] [--seconds 3] [--fault frozen|altered]

One process builds the program once and, for each seed, makes that seed's
start states, runs the cell's set-up and a window of ``--seconds``, and
lets the reference judge a seeded sample of its frames, as a run does.  It
then does the same with the precision control in the program's place
(the workload's ``Control``).  ``--fault`` plants one of the faults of
``steppers`` in the program.  Each reading is one JSON line on standard
output: the numbers over all units, and each unit's own under ``units``.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def window(stepper, pool, traffic, seed, seconds):
    """Set-up and a window of ``seconds`` → the kept units."""
    from portbench import harness

    win = harness.Window(stepper, pool, traffic, seed)
    win.set_up()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or not win.sample.kept:
        win.frame()
    return win.sample.kept


def readings(cell, steps, mesh, seeds, stepper, seconds, label, device):
    import torch

    from portbench import check

    reference = steps.reference(mesh, cell.config, device)
    for seed in seeds:
        pool = [{k: torch.as_tensor(v, device=device).to(stepper.dtype) for k, v in s.items()}
                for s in steps.starts(mesh, cell.config, cell.traffic, seed)]
        host = [{k: v.double().cpu().numpy() for k, v in s.items()} for s in pool]
        t0 = time.perf_counter()
        units = window(stepper, pool, cell.traffic, seed, seconds)
        each = [check.judge([u], host, reference, cell.traffic, stepper, steps.compare)
                for u in units]
        worst = {k: max(e[k] for e in each) for k in each[0]}
        print(json.dumps({"workload": cell.name, "stepper": label, "seed": seed,
                          "seconds": time.perf_counter() - t0, **worst, "units": each}),
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=("frozen", "altered"), default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import spec
    from portbench.steppers import Frozen

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(ROOT, args.workload)
    steps = spec.stepper(ROOT, cell.workload)
    mesh = steps.mesh(cell.config)
    if args.seeds:
        program = steps.Program(mesh, cell.config, device)
        label = "program"
        if args.fault == "frozen":
            program, label = Frozen(program), "frozen"
        elif args.fault == "altered":
            program = steps.altered_answer(program, mesh, cell.traffic["frame_field"])
            label = "altered"
        readings(cell, steps, mesh, args.seeds, program, args.seconds, label, device)
        program.close()
        torch.cuda.empty_cache()
    if args.control_seeds:
        control = steps.Control(mesh, cell.config, device)
        readings(cell, steps, mesh, args.control_seeds, control, args.seconds, "control", device)


if __name__ == "__main__":
    main()
