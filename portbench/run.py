"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, with ``breakdown``), ``device`` and ``checks``, each
number the comparison with the reference yielded beside its limit, which
the last lines of standard error repeat.  The run fails, with no result,
without enough CUDA devices, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufem")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness, spec

    cell = spec.cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
