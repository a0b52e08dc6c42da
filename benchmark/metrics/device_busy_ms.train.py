"""The card's busy time a training step: the union of the device's
operations over the traced window, over its steps. The profiler slows
the host's side of a step, and with it the idle share, but not the
device's side; this against `train_step_ms` says how much of a step the
host adds."""
from harness import readers


def read(r):
    return readers.busy_ms(r)
