"""Operations of the vision tower counted from its configuration: what a
model step has to compute, whatever kernels compute it."""
from __future__ import annotations


def seq_len(cfg: dict) -> int:
    grid = cfg["image_size"] // cfg["patch_size"]
    return grid * grid + (1 if cfg["use_cls_token"] else 0)


def hidden(cfg: dict) -> int:
    return int(cfg["width"] * cfg["mlp_ratio"])


def tower_flops(cfg: dict) -> float:
    """Multiply-adds x 2 of one image's forward: the patch embedding, per
    block the q, k, v and output projections, the scores and the weighted
    sum of every head, the MLP; then the pool (the attention probe's
    projections and its one query's attention, or nothing for a class
    token) and the output projection."""
    w, p, s = cfg["width"], cfg["patch_size"], seq_len(cfg)
    patches = (cfg["image_size"] // p) ** 2
    flops = 2 * patches * 3 * p * p * w
    per_block = 4 * 2 * s * w * w + 2 * 2 * s * s * w + 2 * 2 * s * w * hidden(cfg)
    flops += cfg["depth"] * per_block
    if cfg["pool_type"] == "attn":
        flops += 2 * w * w + 2 * 2 * s * w * w + 2 * 2 * s * w + 2 * w * w
    return flops + 2 * w * cfg["embed_dim"]


def train_step_flops(cfg: dict, batch: int) -> float:
    """A training step over two views of `batch` images: each view's
    forward and a backward at twice the forward's operations."""
    return 3 * 2 * batch * tower_flops(cfg)


def scan_flops(queries: int, rows: int, dim: int) -> float:
    """An exact scan: one dot of every query with every row."""
    return 2 * queries * rows * dim
