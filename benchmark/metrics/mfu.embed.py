"""The embedding window's share of the card's bf16 peak: the tower's
operations for every image embedded (`counts/model.py`) at the untraced
window's rate."""
from counts import model
from harness import readers


def read(r):
    return readers.mfu(r, model.tower_flops(r.cell.config), "images")
