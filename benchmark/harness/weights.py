"""Seeded weights and inputs, made on the card in a few large calls.

The same seed gives the same tensors, whichever side asks: the program
is handed them through its state dict, and the reference makes them
again after the window from the seed alone."""
from __future__ import annotations

import numpy as np
import torch

# the seeded pixels are preprocessed as CLIP and PE preprocess a photo:
# values in [0, 1], then the per-channel mean and std
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# stream tags, so that the weights, the images and the rows of one seed
# are drawn from unrelated generators
WEIGHTS, IMAGES, ROWS, QUERIES, VIEWS = 1, 2, 3, 4, 5


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for (seed, stream); any seed up to 2**62."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (1 << 63))


def tower_params(shapes: dict, seed: int, device, layer_scale: float = 0.1) -> dict:
    """fp32 tensors by name from one normal draw: kernels N(0, 1 / fan_in),
    biases and the token embeddings N(0, 0.02^2), LayerNorm weights 1 +
    N(0, 0.1^2) and biases N(0, 0.02^2), LayerScale `layer_scale` +
    N(0, 0.02^2). Every value is drawn, so no zero bias or unit scale
    hides a term the program could leave out."""
    total = sum(int(np.prod(s)) for s, _ in shapes.values())
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device), device=device)
    out, lo = {}, 0
    for name, (shape, kind) in shapes.items():
        n = int(np.prod(shape))
        t = flat[lo:lo + n].view(shape)
        lo += n
        if kind.startswith("fan_in:"):
            t.mul_(float(kind.split(":")[1]) ** -0.5)
        elif kind == "norm_w":
            t.mul_(0.1).add_(1.0)
        elif kind == "gamma":
            t.mul_(0.02).add_(layer_scale)
        else:
            t.mul_(0.02)
        out[name] = t
    return out


def seeded_tower(cell, device) -> dict:
    """The cell's tower parameters, named as the program's state dict and
    the reference name them, from the cell's seed."""
    from reference import vit

    cfg = cell.config
    return tower_params(vit.param_shapes(cfg), cell.seed, device, cfg["layer_scale_init"] or 0.0)


def images(n: int, size: int, seed: int, stream: int, device) -> torch.Tensor:
    """[n, size, size, 3] preprocessed fp32 pixels from uniform [0, 1]."""
    g = generator(seed, stream, device)
    x = torch.rand((n, size, size, 3), generator=g, device=device)
    mean = torch.tensor(IMAGE_MEAN, device=device)
    std = torch.tensor(IMAGE_STD, device=device)
    return x.sub_(mean).div_(std)


def clustered_rows(n: int, d: int, centers: int, noise: float, seed: int, device,
                   chunk: int = 1 << 17):
    """Chunks of `n` unit rows: one of `centers` seeded unit centres plus
    N(0, noise^2 / d) per coordinate, normalised (`chip_smoke.py`'s
    `capacity_data`, drawn on the card). Yields (lo, [m, d] fp32)."""
    g = generator(seed, ROWS, device)
    c = torch.randn((centers, d), generator=g, device=device)
    c /= c.norm(dim=1, keepdim=True)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        pick = torch.randint(0, centers, (m,), generator=g, device=device)
        x = c[pick] + torch.randn((m, d), generator=g, device=device) * (noise / d ** 0.5)
        yield lo, x / x.norm(dim=1, keepdim=True)
