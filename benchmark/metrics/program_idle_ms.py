"""Device idle a call that falls inside the program, read by every
`program_idle_ms.<cells>` metric: the gaps between the union of the
traced device operations during which the calling thread was inside one
of the program's root spans (`host_ms.py` names them), in ms over the
window's calls. The rest of the idle belongs to the caller. The profiler
slows a call's host side (a training step 1.14-1.35x), and with it this
idle, as it does `device_idle`.

`r.ops` count from the window's first device operation and the spans in
ns on the profiler's clock, so an offset lays the operations on the
spans. It is found from the spans that wait on the device: a copy from
the device to the host ends a few us before the host call that waits
for it returns, so each such span holds one, and the copies come in the
order of the spans. On the H100 kineto's device times move against
every host clock within one session: by a few hundred us over seconds
in one, in steps of 6 and 11 ms in another, not at all in a third. So
no one offset holds a window, and no offset carries over from one call
to the next: the n-th waiting span pairs with the n-th device-to-host
copy, and the offset at each is the largest that keeps its copy inside
it. Each device operation takes the offset of the next paired copy.
Where the copies are not one to a waiting span (a few spans at the
window's end may lack theirs: kineto once lost a window's last copy),
where the first pair would not let the window's first device operation
start inside the first root span that launched it, or where waiting
spans that follow each other within `CLOSE_S` pair with copies at
offsets that disagree (a copy missed), the two clocks do not agree and
the reader returns None, as `harness/trace.py` leaves out a capture that
lost events. The offsets' range, the width of the offsets that would
do, and the idle by the innermost span go to the log."""
import bisect
import os
import statistics
import sys
import threading

from harness.cell import load_module

host = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_ms.py"),
                   "metric_host_ms")

# a device-to-host copy, as kineto names it: into pageable memory (a
# tensor's `.cpu()`) or pinned memory (`.item()`), the host waiting on both
COPY = ("Memcpy DtoH",)
# s of clock noise allowed between two offsets that should agree
SLACK_S = 50e-6
# waiting spans this close (s) hold their copies on one clock: a call's
# two downloads in the search cell
CLOSE_S = 100e-6
# waiting spans at a window's end that may lack their copy, and close
# pairs that may disagree (a clock step between them): 2 and a hundredth
UNPAIRED = 2


def align(records, ops):
    """(copy ends, [(offset, width)]) laying `ops` ([(name, start_s,
    end_s)]) on the spans' clock, `seconds(records)`: at each copy the
    largest offset that keeps it inside its waiting span, and how far
    below it the least such lies; an operation takes the offset of the
    first copy that ends at or after it. None where the clocks do not
    agree."""
    to_s = seconds(records)
    waits = sorted((to_s(r.start_ns), to_s(r.end_ns)) for r in records if r.waits)
    copies = sorted((s, e) for n, s, e in ops if all(p in n for p in COPY))
    root = min((to_s(r.start_ns), to_s(r.end_ns)) for r in records if r.parent is None)
    if not copies or not 0 <= len(waits) - len(copies) <= UNPAIRED:
        return None
    pairs = [(s - cs, e - ce) for (s, e), (cs, ce) in zip(waits, copies)]
    lo, hi = pairs[0]
    if any(a > b for a, b in pairs) or hi < root[0] - SLACK_S or lo > root[1] + SLACK_S:
        return None
    close = [(a, b) for a, b, w, v in zip(pairs, pairs[1:], waits, waits[1:])
             if v[0] - w[1] < CLOSE_S]
    if sum(max(a[0], b[0]) > min(a[1], b[1]) + SLACK_S for a, b in close) > (
            UNPAIRED + 0.01 * len(close)):
        return None
    return [ce for _, ce in copies[:len(pairs)]], [(hi, hi - lo) for lo, hi in pairs]


def seconds(records):
    """ns on the profiler's clock -> s from the first span's start."""
    base = min(r.start_ns for r in records)
    return lambda ns: (ns - base) / 1e9


def laid(ops, ends, offsets) -> list:
    """[(start, end)] of `ops` on the spans' clock."""
    out = []
    for _, s, e in ops:
        o = offsets[min(bisect.bisect_left(ends, e), len(ends) - 1)][0]
        out.append((s + o, e + o))
    return out


def read(r):
    records = host.program_spans()
    me = threading.get_native_id()
    records = [s for s in records or () if s.thread == me]
    calls = r.work["calls"]
    if not records or not calls:
        return None
    got = align(records, r.ops)
    if got is None:
        log(f"program_idle_ms: the device's clock does not follow the spans': the "
            f"{sum(1 for n, _, _ in r.ops if all(p in n for p in COPY))} device-to-host copies "
            f"do not pair with the {sum(s.waits for s in records)} waiting spans")
        return None
    ends, offsets = got
    from reverso_tpu_torch.utils import profiling

    base = min(s.start_ns for s in records)
    ns = [(base + round(1e9 * s), base + round(1e9 * e)) for s, e in laid(r.ops, ends, offsets)]
    idle = profiling.idle_by_span(ns, records, (min(ns)[0], max(e for _, e in ns)))
    # one thread's spans, each child inside its root: the idle inside a root
    # is that of every span
    value = sum(v for n, v in idle.items() if n != profiling.OUTSIDE) / 1e6 / calls
    offs, widths = [o for o, _ in offsets], [w for _, w in offsets]
    log(f"program_idle_ms: {value:.4f} ms a call; {len(offsets)} waiting spans paired, "
        f"offsets {1e3 * min(offs):.6f} to {1e3 * max(offs):.6f} ms (a range of "
        f"{1e6 * (max(offs) - min(offs)):.3f} us); the offsets that would do span "
        f"{1e6 * min(widths):.3f} us at the least, {1e6 * statistics.median(widths):.3f} us at "
        f"the median; idle ms a call by the innermost span: " +
        ", ".join(f"{n} {v / 1e6 / calls:.4f}" for n, v in
                  sorted(idle.items(), key=lambda x: -x[1])))
    return value


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
