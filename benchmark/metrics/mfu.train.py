"""The training window's share of the card's bf16 peak: each step's two
views forward and backward (`counts/model.py`), at the untraced window's
rate."""
from counts import model
from harness import readers


def read(r):
    return readers.mfu(r, model.train_step_flops(r.cell.config, r.cell.traffic["batch"]),
                       "steps")
