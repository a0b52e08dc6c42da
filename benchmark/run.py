"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, seeded weights and data, warm-up of
the cell's own shapes) is timed from the start of this process to the
first timed call; it includes the kernel library's nvcc build on a
checkout's first run, which is also logged apart. The window is a closed
loop of the cell's entry for `--seconds`. `--trace 1` runs that window
twice, first as it is, for the rate that the `mfu.*` metrics divide by,
then under `torch.profiler`, and reports the cell's per-layer metrics in
place of its end-to-end ones.
After the window the program is freed and the plain reference decides
`correct`. The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error.

Exit codes: 0 with a result; 2 for a bad argument or a missing file;
3 without the cards the cell needs; 4 when JAX or the JAX package was
loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import device  # noqa: E402
from harness.cell import load_cell  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def closed_loop(prog, seconds: float, first: int = 0) -> dict:
    """Calls the entry back to back, from call number `first`, until
    `seconds` have passed; every call that started is waited for and
    counted in the window."""
    work, failed, n, ends = 0, 0, first, []
    t0 = time.perf_counter()
    while True:
        try:
            work += prog.call(n)
        except Exception as e:   # an answer that never comes: counted, and not correct
            failed += 1
            log(f"call {n} failed: {type(e).__name__}: {e}")
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            return {"calls": n - first, "failed": failed, "work": work, "seconds": ends[-1],
                    "ends": ends}


def quarters(ends: list) -> str:
    """Calls a second in each quarter of the window, and the call times'
    quartiles in ms: whether a run drifts or jitters."""
    import statistics

    span = ends[-1]
    rates = [sum(1 for t in ends if q * span / 4 < t <= (q + 1) * span / 4) / (span / 4)
             for q in range(4)]
    gaps = [b - a for a, b in zip([0.0] + ends, ends)]
    qs = statistics.quantiles(gaps, n=4) if len(gaps) > 1 else gaps * 3
    return (f"calls/s by quarter {' '.join(f'{r:.2f}' for r in rates)}; call ms "
            f"quartiles {' '.join(f'{1e3 * q:.3f}' for q in qs)}, max {1e3 * max(gaps):.3f}")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def guard_jax(where: str) -> bool:
    bad = device.forbidden_modules()
    if bad:
        log(f"JAX or the JAX package is loaded {where}: {', '.join(bad)}")
    return not bad


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload, args.seed, args.seconds)
        entry = cell.entry
    except (KeyError, FileNotFoundError, OSError, ValueError) as e:
        log(f"cannot load workload {args.workload!r}: {type(e).__name__}: {e}")
        return 2
    device.cache_dirs()
    t_torch = time.perf_counter()
    missing = device.cards_missing(cell.chips)
    if missing:
        log(missing)
        return 3
    from harness import program

    t_cuda = time.perf_counter()
    where = program.outside_checkout()
    if where:
        log(where)
        return 2
    t = time.perf_counter()
    build_s = program.build_seconds()
    log(f"set-up: imports {t - T0:.3f} s (torch and the harness {t_torch - T0:.3f}, the "
        f"card's driver {t_cuda - t_torch:.3f}, the program {t - t_cuda:.3f}), kernel "
        f"library {time.perf_counter() - t:.3f} s (nvcc build {build_s:.3f} s)")
    result = measure(cell, entry, bool(args.trace))
    if result is None:
        return 4
    log(f"card: {device.card_line()}")
    for name, c in result["checks"].items():
        v, lim = float(c["value"]), c["limit"]
        log(f"check {name}: {c['value']!r} (limit {lim!r}){'' if v <= lim else '  FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


def measure(cell, entry, trace: bool, t0: float = T0):
    """Set-up, the window, the reference: the result's object, or None
    where JAX or the JAX package was loaded."""
    import torch

    from harness import program

    t = time.perf_counter()
    prog = entry.setup(cell)
    device.sync(cell.device)
    log(f"set-up: weights and data {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    prog.warm_up()
    device.sync(cell.device)
    log(f"set-up: warm-up {time.perf_counter() - t:.3f} s")
    on_card = cell.device != "cpu"
    if on_card:
        for d in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(d)
    before = program.counters()
    setup_s = time.perf_counter() - t0

    wins = []
    if trace:
        from harness import trace as tracing

        # the same window untraced first: the profiler slows the host's side
        # of a call (a training step by a tenth or more), so rates come from
        # this one and device times from the traced one
        wins.append(closed_loop(prog, cell.seconds))
        device.sync(cell.device)
        mark = program.counters()
        with tracing.traced() as raw:
            wins.append(closed_loop(prog, cell.seconds, first=wins[0]["calls"]))
    else:
        mark = before
        wins.append(closed_loop(prog, cell.seconds))
    device.sync(cell.device)
    peak = device.memory_peak(cell.chips) if on_card else 0
    launches, shapes, _ = program.counted_since(mark)
    plain = program.counted_since(before)[2]
    if not guard_jax("after the window"):
        return None
    win = wins[-1]
    works = [{entry.UNITS: w["work"], "calls": w["calls"], "seconds": w["seconds"]}
             for w in wins]
    for name, w in zip(("untraced window", "traced window") if trace else ("window",), wins):
        log(f"{name}: {w['calls']} calls, {w['work']} {entry.UNITS}, {w['seconds']:.4f} s, "
            f"{w['failed']} failed")
        log(f"{name}: {quarters(w['ends'])}")
    log(f"launches over the last window: {json.dumps(launches, sort_keys=True)}")
    if trace:
        ms = [1e3 * w["seconds"] / w["calls"] for w in wins]
        log(f"profiler: a call takes {ms[1]:.4f} ms traced against {ms[0]:.4f} ms untraced "
            f"({ms[1] / ms[0]:.4f}x)")

    metrics, extra = {}, {}
    if trace:
        readings, breakdown, note = tracing.reduce(raw, cell, win["seconds"], launches,
                                                   shapes, works[1], works[0])
        log(note)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(readings) if readings.capture_ok else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": readings.busy_s, "window_s": readings.window_s}
    else:
        e2e = entry.end_to_end(works[0], win["seconds"])
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    checks = prog.check() + [(f"plain_dispatches.{k}", float(v), 0.0)
                             for k, v in sorted(plain.items())]
    if not guard_jax("after the reference"):
        return None
    dev = (device.device_fields(cell.chips, peak) if on_card else
           {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    dev.update(extra)
    failed = sum(w["failed"] for w in wins)
    result = {"correct": failed == 0 and all(v <= lim for _, v, lim in checks),
              "attempted": sum(w["calls"] for w in wins), "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for name, v, lim in checks}
    return result


if __name__ == "__main__":
    sys.exit(main())
