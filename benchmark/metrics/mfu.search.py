"""The search window's share of the card's bf16 peak: one dot of every
query with every stored row, at the untraced window's rate. The scan is
bound by bytes, so this stays far under 100%; it bounds whatever kernel
serves the scan, as `k1_roofline.search` bounds K1 alone."""
from counts import model
from harness import readers


def read(r):
    t = r.cell.traffic
    return readers.mfu(r, model.scan_flops(1, t["rows"], r.cell.config["embed_dim"]), "queries")
