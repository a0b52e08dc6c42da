"""Cells of the manifest at a size a CPU test run holds: the published
configuration's layout at small widths and depth, small traffic."""
import copy

from harness.cell import load_cell

SMALL = dict(image_size=56, patch_size=14, width=128, depth=3, num_heads=4, embed_dim=64)
TRAFFIC = {"embed": dict(batch=4, pool=3, check_batches=2),
           "search": dict(rows=6000, centers=64, queries=16, pool=4, check_requests=3),
           "train": dict(batch=4, pool=4)}


def cell(workload: str, seed: int = 2 ** 31 + 7, dtype: str = "float32", seconds: float = 0.5,
         **traffic):
    c = copy.copy(load_cell(workload, seed, seconds))
    c.device = "cpu"
    c.config = dict(c.config, dtype=dtype, **SMALL)
    if "attn_pool_heads" in c.config:
        c.config["attn_pool_heads"] = SMALL["num_heads"]
    c.traffic = dict(c.traffic, **TRAFFIC[c.traffic["entry"]], **traffic)
    return c
