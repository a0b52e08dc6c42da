"""Embedding a folder: a closed loop of one caller, each call
`PerceptionEncoder.encode_image` on a batch of preprocessed pixels on
the host, as `ingest/pipeline.py::build_database`'s embed stage makes it.

Traffic keys: `batch` (images a call), `pool` (distinct seeded batches,
cycled), `check_batches` (calls of the window compared with the
reference, a uniform sample drawn from the seed).

`correct`: every sampled call's embeddings against the plain fp32 tower
(`reference/vit.py`) on the same seeded weights and pixels;
`embed_gap` is the largest L2 distance between the program's unit
embedding and the reference's. The control is the reference in the
program's place with every product's operands rounded to fp8 (e4m3, one
scale a tensor), one precision step below the configuration's bfloat16.
(The program's own int8 path, `quant="int8"`, quantizes only the MLPs,
whose output LayerScale shrinks, and reads about as far from the
reference as bfloat16 does: it cannot separate.)
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from harness import device, program, weights
from harness.sample import Sample
from reference import vit as ref

UNITS = "images"


class Control:
    """The reference in the program's place, its products in fp8."""

    def __init__(self, cell, params):
        ref.plain_fp32()
        self.tower = ref.Tower(cell.config, params, mm=ref.lowp(torch.float8_e4m3fn))

    def encode_image(self, images):
        return reference_embed(self.tower, images).cpu().numpy()


class Embed:
    def __init__(self, cell, control: bool = False):
        from reverso_tpu_torch.models.pe import PerceptionEncoder

        cfg, t = cell.config, cell.traffic
        self.cell, self.batch = cell, t["batch"]
        dev = torch.device(cell.device)
        params = weights.seeded_tower(cell, dev)
        if control:
            self.enc = Control(cell, params)
        else:
            # built on the card: the module's parameters are made there and
            # the seeded ones copied in, with no trip through the host
            with torch.device(dev):
                self.enc = PerceptionEncoder(program.model_config(cfg), family=cfg["family"],
                                             params=params, device=dev)
        del params
        x = weights.images(t["pool"] * self.batch, cfg["image_size"], cell.seed,
                           weights.IMAGES, dev)
        self.pool = x.cpu().numpy().reshape(t["pool"], self.batch, *x.shape[1:])
        del x
        self.outs = Sample(t["check_batches"], cell.seed)

    def warm_up(self) -> None:
        for j in range(2):
            self.enc.encode_image(self.pool[j % len(self.pool)])

    def call(self, i: int) -> int:
        j = i % len(self.pool)
        self.outs.offer((j, self.enc.encode_image(self.pool[j])))
        return self.batch

    def check(self) -> list:
        """(name, value, limit) of the comparison with the reference."""
        cell, outs = self.cell, self.outs.items
        del self.enc
        device.free_cache()
        gap = max(float(np.max(g)) for g in reference_gaps(cell, self.pool, outs))
        return [("embed_gap", gap, cell.limits["embed_gap"])]


@torch.no_grad()
def reference_embed(tower, images, chunk: int = 16):
    """Unit embeddings of host images by the reference, `chunk` images at a
    time (the plain attention holds [chunk, heads, S, S] scores)."""
    dev = next(iter(tower.p.values())).device
    x = torch.from_numpy(np.asarray(images, np.float32))
    return torch.cat([ref.unit(tower.embed(x[lo:lo + chunk].to(dev)))
                      for lo in range(0, len(x), chunk)])


def reference_gaps(cell, pool, outs):
    """For each (pool index, program output), the L2 distance of every
    image's unit embedding from the reference's."""
    ref.plain_fp32()
    tower = ref.Tower(cell.config, weights.seeded_tower(cell, torch.device(cell.device)))
    for j, got in outs:
        want = reference_embed(tower, pool[j])
        yield (torch.from_numpy(got).to(want.device) - want).norm(dim=1).cpu().numpy()


@contextlib.contextmanager
def altered_answer():
    """Fault: one image's embedding of every batch altered where the
    program produces it (its components rotated by one)."""
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    produce = PerceptionEncoder.encode_image

    def altered(self, images, **kw):
        out = produce(self, images, **kw)
        out[0] = np.roll(out[0], 1)
        return out

    PerceptionEncoder.encode_image = altered
    try:
        yield
    finally:
        PerceptionEncoder.encode_image = produce


# faults a run of this entry can have, planted in the program
FAULTS = {"altered_answer": altered_answer}


def setup(cell, control: bool = False) -> Embed:
    return Embed(cell, control)


def end_to_end(work: dict, seconds: float) -> dict:
    return {"embed_img_per_s": work[UNITS] / seconds}
