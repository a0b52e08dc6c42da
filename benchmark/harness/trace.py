"""The traced window: `torch.profiler` over the same closed loop, reduced
to what the per-layer readers need.

Device operations are the profiler's CUDA events (kernels, copies,
sets). The window is the closed loop's, by the host's clock. As
`chip_smoke.py::profiled` does, the capture is held against the window
by CUDA events: a session that lost device events reads short, and then
nothing is read from it.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

import torch

# the captured device events' extent over the window's by CUDA events
CAPTURE_RANGE = (0.8, 1.1)
# host events looked back through to name an idle gap
SCAN_BACK = 4096


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the cell, the traced window, the
    device operations in it, and the program's counters over it."""
    cell: object
    window_s: float
    busy_s: float
    ops: list                 # [(name, start_s, end_s)] device operations, window-relative
    launches: dict            # kernels.launches over the window
    shape_launches: dict      # kernels.shape_launches over the window
    work: dict                # the entry's counts over the window (images, queries, steps)
    untraced: dict            # the same counts and "seconds" of the untraced window before it
    capture_ok: bool

    def kernel_s(self, *patterns: str) -> float:
        """Device seconds of the operations whose name holds any pattern."""
        return sum(e - s for n, s, e in self.ops if any(p in n for p in patterns))

    def shape_count(self, kernel: str) -> dict:
        """{shape: launches} of one `shape_launches` kernel."""
        return {k[1]: v for k, v in self.shape_launches.items() if k[0] == kernel}


def _union(intervals):
    busy, end = 0.0, float("-inf")
    for b, e in sorted(intervals):
        busy += max(0.0, e - max(b, end))
        end = max(end, e)
    return busy


@contextlib.contextmanager
def traced():
    """Profile the body's device work; yields a dict that holds, after the
    body, the raw kineto events under "events" and the body's span by
    CUDA events under "call_ms". Only the card's activity is traced (its
    kernels, copies and the runtime calls that start them): recording
    every host op as well slowed a training step 2.2x and so inflated the
    idle share it was meant to read."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        yield out
        stop.record()
        torch.cuda.synchronize()
    out["call_ms"] = start.elapsed_time(stop)
    out["events"] = prof.profiler.kineto_results.events()


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def reduce(raw: dict, cell, window_s: float, launches: dict, shape_launches: dict,
           work: dict, untraced: dict):
    """(Readings, breakdown, capture note) of one traced window of
    `window_s` seconds by the host's clock, with the counts and seconds
    of the untraced window that ran before it."""
    from torch.autograd import DeviceType

    events = raw["events"]
    dev, host = [], []
    for e in events:
        if _annotation(e):
            continue      # a span's range mirrored over the kernels inside it
        (dev if e.device_type() == DeviceType.CUDA else host).append(
            (e.name(), e.start_ns(), e.end_ns()))
    t0 = min((s for _, s, _ in dev), default=0)
    dev = [(n, (s - t0) / 1e9, (t - t0) / 1e9) for n, s, t in dev]
    host = [((s - t0) / 1e9, (t - t0) / 1e9, n) for n, s, t in host]
    busy_s = _union((s, t) for _, s, t in dev)
    extent_ms = max((t for _, _, t in dev), default=0.0) * 1e3
    ratio = extent_ms / raw["call_ms"] if raw["call_ms"] else 0.0
    ok = bool(dev) and CAPTURE_RANGE[0] <= ratio <= CAPTURE_RANGE[1]
    note = (f"capture: device events span {extent_ms:.3f} ms against the window's "
            f"{raw['call_ms']:.3f} ms by CUDA events ({ratio:.4f}x; held to "
            f"{CAPTURE_RANGE[0]}-{CAPTURE_RANGE[1]}x)")
    r = Readings(cell, window_s, busy_s, dev, launches, shape_launches, work, untraced, ok)
    return r, breakdown(dev, host), note


def breakdown(dev, host, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    time between them by what the host was doing: each gap goes to the
    innermost host event (a runtime call: a launch, a copy, a wait) open
    at its middle, else to the operation that ended it ("before ...")."""
    by_op = collections.Counter()
    for n, s, t in dev:
        by_op[n] += t - s
    gaps, end = [], None
    for n, s, t in sorted(dev, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append((end, s, n))
        end = t if end is None else max(end, t)
    host.sort()
    starts = [h[0] for h in host]
    by_host = collections.Counter()
    for g0, g1, nxt in gaps:
        mid = (g0 + g1) / 2
        label = f"before {nxt[:80]}"
        i = bisect.bisect_right(starts, mid)
        # the latest-starting host event still open at `mid` is the
        # innermost; looking back a bounded way keeps this linear
        for s, t, n in reversed(host[max(0, i - SCAN_BACK):i]):
            if t >= mid:
                label = n
                break
        by_host[label] += g1 - g0
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in by_host.most_common(top)]}
