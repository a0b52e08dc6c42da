"""Per-stage timers and a metrics struct, the program's spans, and the
torch.profiler trace that lays them on the card's timeline.

Spans (`span`) mark where the program's own code runs inside its entry
points. They record only while a `torch.profiler` session captures
(`torch.autograd.profiler._is_profiler_enabled`, one flag read); else
`span` returns one shared no-op object. A span adds no device sync, no
CUDA event and no `record_function`: it reads the host clock twice and
appends one `Span` to a bounded buffer (`spans`, `clear_spans`; a full
buffer counts `spans_dropped`). Its clock, `time.time_ns`, is the one
kineto's host timestamps are on. Its device timestamps move against it
on an H100 (by up to ~0.3 ms over seconds, or in steps of several ms,
within one session), so `trace` lays them by `on_host_clock`.
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# records the buffer holds; one search request records 7
MAX_SPANS = 1 << 19
# the label of device idle during which no program span is open
OUTSIDE = "outside the program"

clock_ns = time.time_ns


class Span(NamedTuple):
    """One span: `start_ns` and `end_ns` on the profiler's clock; `parent`
    the id of the span it opened inside, None for a root; `call` the id
    of its root (every span under one root shares it); `thread` the
    native thread id; `waits` whether it blocks on the device."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int
    thread: int
    waits: bool


_records: list = []          # plain tuples, as `Span` holds them
_lock = threading.Lock()
_ids = itertools.count(1)
_open = threading.local()    # .stack: the open spans; .thread: the native id
spans_dropped = 0


def spans() -> list:
    """The spans recorded since the last `clear_spans`, in the order they
    ended."""
    return [Span._make(r) for r in list(_records)]


def clear_spans() -> None:
    global spans_dropped
    with _lock:
        _records.clear()
        spans_dropped = 0


def _record(r: tuple) -> None:
    # an append is atomic; threads racing at the bound may pass it by a few
    if len(_records) < MAX_SPANS:
        _records.append(r)
    else:
        global spans_dropped
        with _lock:
            spans_dropped += 1


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """A recording span. What it touches is kept to plain Python: a
    syscall (the native thread id) costs ~9 us on the card's host, so the
    id is read once a thread."""
    __slots__ = ("name", "waits", "id", "parent", "call", "start", "stack")

    def __init__(self, name: str, waits: bool):
        self.name, self.waits = name, waits

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
            _open.thread = threading.get_native_id()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.call = top.call if top is not None else self.id
        self.stack = stack
        stack.append(self)
        self.start = clock_ns()
        return self

    def __exit__(self, *exc):
        end = clock_ns()
        self.stack.pop()
        _record((self.name, self.start, end, self.id, self.parent, self.call, _open.thread,
                 self.waits))
        return False


def span(name: str, *, waits: bool = False):
    """A context manager that records the body as span `name` while a
    profiler captures, and does nothing otherwise. `waits` marks a body
    that blocks on the device (a copy to the host, a sync)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, waits)


def idle_by_span(busy: Iterable, records: Iterable, window: tuple) -> Dict[str, int]:
    """Device idle in `window` (start, end) by the innermost program span
    open across it: {span name or OUTSIDE: ns}. `busy` holds the device
    operations' (start, end), `records` the spans, all on one clock. Idle
    is the window less the union of `busy`; each stretch of it goes to the
    latest-started span open over that stretch, on any thread."""
    lo, hi = window
    idle, end = [], lo
    for s, e in sorted(busy):
        if s > end:
            idle.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        idle.append((end, hi))
    idle = [(s, e) for s, e in idle if e > s]

    # the window cut at every span boundary, each piece with the innermost
    # span open over it
    edges = sorted([(r.start_ns, 1, r) for r in records] + [(r.end_ns, 0, r) for r in records],
                   key=lambda x: x[:2])
    pieces, open_, t = [], {}, lo
    for at, opens, r in edges:
        at = min(max(at, lo), hi)
        if at > t:
            inner = max(open_.values(), key=lambda o: (o.start_ns, o.id), default=None)
            pieces.append((t, at, OUTSIDE if inner is None else inner.name))
            t = at
        if opens:
            open_[r.id] = r
        else:
            open_.pop(r.id, None)
    if hi > t:
        pieces.append((t, hi, OUTSIDE))

    out: Dict[str, int] = defaultdict(int)
    j = 0
    for s, e in idle:
        while pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            out[name] += min(b, e) - max(a, s)
            k += 1
    return dict(out)


def on_host_clock(events) -> list:
    """(start, end) ns of the kineto events' device operations on the host's
    clock: each moves by the offset of the next device-to-host copy into
    pageable memory, whose runtime call (same correlation id) returns as
    the copy ends; with no such copy, by none."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    calls = {e.correlation_id(): e.end_ns() for e in events
             if e.device_type() != DeviceType.CUDA and e.correlation_id()}
    marks = sorted((e.end_ns(), calls[e.correlation_id()] - e.end_ns()) for e in dev
                   if "DtoH" in e.name() and "Pageable" in e.name()
                   and e.correlation_id() in calls)
    ends = [m[0] for m in marks]
    out = []
    for e in dev:
        o = marks[min(bisect.bisect_left(ends, e.end_ns()), len(marks) - 1)][1] if marks else 0
        out.append((e.start_ns() + o, e.end_ns() + o))
    return out


@dataclass
class Metrics:
    """Accumulated per-stage wall time and counters."""
    seconds: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def add(self, stage: str, dt: float, n: int = 1) -> None:
        self.seconds[stage] += dt
        self.counts[stage] += n

    def rate(self, stage: str) -> float:
        dt = self.seconds.get(stage, 0.0)
        return self.counts.get(stage, 0) / dt if dt > 0 else 0.0


class StageTimer:
    """Context-manager stage timer feeding a Metrics struct; each stage is
    also the span `build.<stage>`.

    Syncing on device work is the CALLER's responsibility: CUDA launches
    are asynchronous, so a stage must end in a host copy of its output
    (`.cpu()` / `np.asarray`) or `torch.cuda.synchronize()` to measure the
    work rather than its enqueue.
    """

    def __init__(self, metrics: Metrics | None = None):
        self.metrics = metrics or Metrics()

    @contextlib.contextmanager
    def stage(self, name: str, n: int = 1) -> Iterator[None]:
        t0 = time.perf_counter()
        with span(f"build.{name}"):
            yield
        self.metrics.add(name, time.perf_counter() - t0, n)


@contextlib.contextmanager
def trace(dirname: str | None) -> Iterator[None]:
    """torch.profiler trace scope writing `<dirname>/trace.json` (Chrome
    trace format): the card's activity (the CPU's where there is no card)
    and the program's spans on one timeline, then device idle by the
    innermost span on stderr. No-op if dirname is None. Only the device
    is traced: recording every host op as well slows a training step
    about 2x."""
    if dirname is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA if card else ProfilerActivity.CPU]) as prof:
        start = clock_ns()      # the body's window: the profiler's start and stop take seconds
        yield
        stop = clock_ns()
    records = spans()
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": r.name, "pid": pid, "tid": r.thread,
         "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"id": r.id, "parent": r.parent, "call": r.call, "waits": r.waits}}
        for r in records)
    with open(path, "w") as f:
        json.dump(doc, f)
    busy = on_host_clock(prof.profiler.kineto_results.events())
    idle = idle_by_span(busy, records, (start, stop))
    total = stop - start
    print(f"device idle by program span ({len(busy)} device operations, {len(records)} spans, "
          f"{spans_dropped} dropped; window {total / 1e6:.3f} ms):", file=sys.stderr)
    for name, ns in sorted(idle.items(), key=lambda x: -x[1]):
        print(f"  {name}: {ns / 1e6:.3f} ms ({100.0 * ns / max(total, 1):.1f}%)", file=sys.stderr)
