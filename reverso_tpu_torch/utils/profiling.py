"""Per-stage timers and a metrics struct, plus torch.profiler trace hooks
for device timeline capture."""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator

import torch


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

    def to_json(self) -> str:
        return json.dumps({
            "seconds": dict(self.seconds),
            "counts": dict(self.counts),
            "rates": {k: self.rate(k) for k in self.seconds},
        }, indent=2)


class StageTimer:
    """Context-manager stage timer feeding a Metrics struct.

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
        yield
        self.metrics.add(name, time.perf_counter() - t0, n)


@contextlib.contextmanager
def trace(dirname: str | None) -> Iterator[None]:
    """torch.profiler trace scope writing `<dirname>/trace.json` (Chrome
    trace format, CPU plus CUDA activity when a card is present); no-op if
    dirname is None."""
    if dirname is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(dirname, exist_ok=True)
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
