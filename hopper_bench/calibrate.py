#!/usr/bin/env python3
"""Read the two readings that a cell's limits are set between, on the card:

    python3 hopper_bench/calibrate.py --workload NAME --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault half_batch --fault-seeds 4,5,6]...

For each seed of --seeds, the program at the cell's own size, judged by the
check of a run (the lower reading is the largest over them); for each of
--control-seeds, the control, the reference in bfloat16 in the program's
place (the upper reading is the smallest); for each --fault, on each seed
of the --fault-seeds that follows it, the program with that fault planted
(the FAULTS of the cell's driver, harness/drivers/<kind>.py). All in one
process; one JSON line per reading. Needs a card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", action="append", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from hopper_bench.harness import guard, spec
    from hopper_bench.harness.control import control_readings, program_readings

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    guard.require_cards(cell.chips)
    if len(args.fault) != len(args.fault_seeds):
        ap.error("give each --fault its --fault-seeds")
    runs = [("program", s) for s in args.seeds.split(",") if s]
    runs += [("control", s) for s in args.control_seeds.split(",") if s]
    for fault, seeds in zip(args.fault, args.fault_seeds):
        runs += [(fault, s) for s in seeds.split(",") if s]
    for what, seed in runs:
        t0 = time.perf_counter()
        if what == "control":
            numbers = control_readings(cell, int(seed), "cuda")
        else:
            numbers = program_readings(cell, int(seed), "cuda",
                                       fault=None if what == "program" else what)
        print(json.dumps({"workload": cell.name, "reading": what, "seed": int(seed),
                          "numbers": numbers, "s": time.perf_counter() - t0}), flush=True)
    print(guard.power_limit_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
