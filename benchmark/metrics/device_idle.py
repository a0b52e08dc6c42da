"""Idle share of the card over the traced window, read by every
`device_idle.<cells>` metric: one minus the union of the device's
operations over the window. For cells whose calls the profiler barely
slows (embedding, search); a training step's host side it slows by a
tenth or more, so training reads `device_busy_ms.train` instead."""
from harness import readers


def read(r):
    return readers.idle(r)
