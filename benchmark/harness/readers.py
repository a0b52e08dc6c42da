"""What the per-layer readers under `metrics/` share: the idle share and
the device's busy time a call, a whole step's share of the peak, and a
kernel's share of its roofline, each from a traced window's `Readings`.
A reader that finds nothing to read returns None, and the metric is left
out of the result."""
from __future__ import annotations

from counts import kernels


def idle(r):
    """% of the window in which no operation ran on the card."""
    if r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def busy_ms(r):
    """Milliseconds in which an operation ran on the card, a call of the
    traced window: the device's side of a call, which the profiler leaves
    as it is where it slows the host's."""
    if r.busy_s <= 0 or not r.work["calls"]:
        return None
    return 1e3 * r.busy_s / r.work["calls"]


def mfu(r, flops_per_unit: float, units: str):
    """% of the card's bf16 peak that the untraced window's work is, at
    `flops_per_unit` operations a unit of `units`: the window's rate by the
    host's clock, so that the profiler's cost does not enter it."""
    w = r.untraced
    if w["seconds"] <= 0 or not w[units] or flops_per_unit <= 0:
        return None
    return 100.0 * w[units] * flops_per_unit / w["seconds"] / kernels.PEAK_OPS_S["bfloat16"]


def roofline(r, counter: str, patterns: tuple, least_ms):
    """% of a kernel's device time that its least time is: the least time
    of every launch counted under `counter` (by shape: `least_ms(shape)`)
    over the device time of the operations whose names hold a pattern."""
    launches = r.shape_count(counter)
    spent = r.kernel_s(*patterns)
    if not launches or spent <= 0:
        return None
    least = sum(n * least_ms(shape) for shape, n in launches.items()) / 1e3
    return 100.0 * least / spent


def dtype_of(name: str) -> tuple:
    """(itemsize, peak key) of a dtype as the program's counters name it."""
    return (4, "float32_split") if "float32" in name else (2, "bfloat16")
