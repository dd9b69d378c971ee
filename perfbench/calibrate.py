"""Readings for the limits of ``correct``: one cell over many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed it runs the cell as ``run.py`` does (a window of ``--seconds``,
long enough to complete the mix's calls) and reads the compared numbers of
the program and of the control (the reference in float8 in the program's
place, over the same prompts and served tokens). One JSON line a seed on
standard output; the limits in ``perfbench/limits/<cell>.json`` are set
from these readings (PERF.md gives them).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seeds, seconds: float, device="cuda", control_seeds=None):
    """Yield one dict a seed: the program's compared numbers, the control's (on the first
    ``control_seeds`` seeds, all by default) and the run's set-up."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        control = control_seeds is None or i < control_seeds
        result = harness.run_cell(ROOT, cell, seed, seconds, False, device, t0, control=control)
        result.setdefault("control", {k: v["value"] for k, v in result["checks"].items()})
        yield {"cell": cell, "seed": seed, "correct": result["correct"],
               **result.get("control", {}), "kernel_build": result["kernel_build"],
               "setup_s": result["metrics"].get("setup_s", {}).get("value"), "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=None, help="read the control on the first n seeds only")
    args = parser.parse_args(argv)
    for line in readings(args.workload, args.seeds, args.seconds, control_seeds=args.control_seeds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
