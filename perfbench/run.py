"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result (one JSON object);
the numbers compared for ``correct`` and their limits are the last lines
of standard error. Without a CUDA device, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here: before torch and the program are imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"  # fixed paths inside the checkout: only a checkout's first run builds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no cell named {args.workload!r}: {sorted(cells)}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark may not import JAX or the JAX package", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
