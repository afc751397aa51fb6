"""The readings the correctness limits are set from, on the card at a
cell's own size, many seeds in one process: for each seed the numbers
the program's run compares (after a short window at the cell's load)
and the numbers of the control, the plain reference in the nearest
lower precision in the program's place (bfloat16 for the simulator,
TF32 for the float32 learner with TF32 off)::

    python3 benchmark/calibrate.py --workload grid3x3-random-32k \\
        --seeds 11,12,13 --seconds 3

One JSON line a seed, then a summary line: each number's largest
program reading and smallest control reading.  The benchmark's own runs
never run the control.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def readings(cell, seed: int, seconds: float, device="cuda") -> dict:
    """One seed's program and control readings, with the seconds of the
    window and of the reference's check: the cell's own run (the
    driver's ``run``, with its control added)."""
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, seed, seconds, False, time.perf_counter(),
                     device, control=True)
    got = out.readings
    return {"seed": seed, "steps": out.attempted,
            "window_s": got["window_s"], "check_s": got["check_s"],
            "program": {k: v for k, (v, _) in out.checks.items()},
            "control": {k: v for k, (v, _) in got["control"].items()},
            "limits": {k: lim for k, (_, lim) in out.checks.items()},
            "coverage": out.coverage}


def main(argv=None):
    from benchmark import harness
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, seed, args.seconds, args.device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"]
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "program_max": {k: max(r["program"][k] for r in rows) for k in names},
        "control_min": {k: min(r["control"][k] for r in rows)
                        for k in names}}), flush=True)


if __name__ == "__main__":
    main()
