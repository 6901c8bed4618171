#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card(s) of this machine:

    python3 hopper_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It sets up (weights from the seed, inputs,
kernels from the checkout's build/ cache, one warm-up), measures the cell's
end-to-end metrics over a window of S seconds (--trace 0) or reads its
per-layer metrics from a traced window (--trace 1), frees the program,
checks what the window produced against the plain reference, and prints as
its last line one JSON object: correct, attempted, failed, metrics, device,
(breakdown,) checks. The numbers compared are also the last lines of
standard error, each with its limit. The card's nvidia-smi name and power
limit go on an earlier line.

Exit codes: 0 with a result; 2 without the cards the cell needs; 3 if a JAX
module or the JAX package was loaded. Caches stay under build/ of the
checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "hopper_bench"


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from hopper_bench.harness import guard, spec

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    guard.require_cards(cell.chips)
    from hopper_bench.harness.runner import result_line, run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = guard.banned_modules()
    if found:
        print(f"hopper_bench: loaded modules that no run may load: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(guard.power_limit_line(), flush=True)
    print("setup phases (s): " + json.dumps(result.setup_phases), file=sys.stderr)
    print("request ms (min, median, max): " + json.dumps(result.request_ms), file=sys.stderr)
    for name, (value, limit) in result.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(cell, result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
