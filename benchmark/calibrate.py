"""The readings that a cell's limits are set from: the numbers that decide
`correct`, for the program and for its control, over several seeds in
one process. The benchmark's own runs never run the control.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--control | --fault <name>] [--seconds 3] [--out chiprun_out/calibrate.jsonl]

Each seed: the cell's set-up (with `--control`, the control in the
program's place; with `--fault`, one of the entry's `FAULTS` planted in
the program), a short window at the cell's own load, then the
comparison with the reference. One JSON line per seed.
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import device  # noqa: E402
from harness.cell import load_cell  # noqa: E402


def readings(workload: str, seed: int, control: bool, seconds: float,
             fault: str = None) -> dict:
    """One seed's numbers: {name: value}, with the window's calls."""
    cell = load_cell(workload, seed, seconds)
    entry = cell.entry
    with entry.FAULTS[fault]() if fault else contextlib.nullcontext():
        prog = entry.setup(cell, control=control)
        prog.warm_up()
        calls, t0 = 0, time.perf_counter()
        while calls < 2 or time.perf_counter() - t0 < seconds:
            prog.call(calls)
            calls += 1
    out = {name: value for name, value, _ in prog.check()}
    out["calls"] = calls
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, help="a name in the entry's FAULTS")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device.cache_dirs()
    missing = device.cards_missing(1)
    if missing:
        print(missing, file=sys.stderr)
        return 3
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(args.workload, seed, args.control, args.seconds, args.fault)
        row = {"workload": args.workload, "seed": seed, "control": args.control,
               "fault": args.fault,
               "seconds": time.perf_counter() - t, **r}
        rows.append(row)
        print(json.dumps(row), flush=True)
        device.free_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
