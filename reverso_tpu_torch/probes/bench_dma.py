"""P1: the device-memory read rate of a TMA ring against ring depth, copies
a stage and CTAs an SM (the port of `scripts/bench_dma.py`).

Streams a [N, 1024] bf16 array through a ring of `n_bufs` shared-memory
stages of `tile` rows, each stage fetched as `streams` TMA copies of `sub`
= tile / streams rows, and max-reduces the first 8 rows of every copy
(`csrc/probe_dma.cu`). Its best rate is the measured read rate that
`chip_smoke.py`'s measured bounds divide by.

The TPU's tiles (1024-4096 rows, 2-8 MB) do not fit in a CTA's 227 KB of
shared memory: the sweep runs stages of 8-64 rows (16-128 KB), rings of 2-8
stages, 1-4 copies a stage and 1-2 CTAs an SM, and prints a configuration
whose ring does not fit as skipped (a 128 KB stage never does: a ring
holds two), as the script prints a failed one.

    python -m reverso_tpu_torch.probes.bench_dma [--rows N]
"""
from __future__ import annotations

import argparse
import itertools

import torch

from .. import kernels
from . import device_of, timed_ms

D = 1024
ROWS = 1024 * 1024
SMEM_MAX = 232448          # shared memory a CTA may use (227 KB)
SMEM_SM = 233472           # an SM's, 1 KB of it reserved a CTA
# (tile rows, n_bufs, streams, CTAs an SM): the sweep
SWEEP = tuple(itertools.product((8, 16, 32, 48, 64), (2, 4, 8), (1, 2, 4), (1, 2)))
# the row chip_smoke.py reports: the script's first configuration, (1024, 4,
# 1), at 1/64 of its tile (32 KB stages, four deep, one copy a stage)
DEFAULT = (16, 4, 1, 1)


def smem_bytes(tile: int, n_bufs: int, d: int = D) -> int:
    """Shared memory of one CTA: the ring (1 KB aligned) and its barriers
    (`csrc/probe_dma.cu::smem_bytes`)."""
    return 1024 + n_bufs * tile * d * 2 + 16 * 8


def fits(tile: int, n_bufs: int, streams: int, ctas_per_sm: int = 1, d: int = D) -> bool:
    """Whether a configuration's ring fits: one CTA's shared memory under
    227 KB, and `ctas_per_sm` of them (1 KB reserved each) on one SM."""
    smem = smem_bytes(tile, n_bufs, d)
    return (tile % streams == 0 and tile // streams <= 256 and 2 <= n_bufs <= 8
            and smem <= SMEM_MAX and ctas_per_sm * (smem + 1024) <= SMEM_SM)


def stream_max_ref(db: torch.Tensor, tile: int, streams: int) -> torch.Tensor:
    """Plain version: [min(8, sub), d] fp32, the max over every sub-tile of
    `sub` = tile / streams rows of its first 8 rows, over the whole tiles."""
    n_tiles = db.shape[0] // tile
    sub = tile // streams
    return db[:n_tiles * tile].view(-1, sub, db.shape[1])[:, :8].amax(0).float()


def stream_max(db: torch.Tensor, tile: int, n_bufs: int, streams: int,
               ctas_per_sm: int = 1) -> torch.Tensor:
    """P1's function; CPU tensors run `stream_max_ref`, CUDA tensors launch
    `rv_probe_dma` (d % 256 == 0, d <= 1024)."""
    n, d = db.shape
    if db.dtype != torch.bfloat16 or tile < 1 or streams < 1 or tile % streams != 0 \
            or n < tile:
        raise ValueError(f"stream_max: bf16 [N, d] rows, whole tiles of `streams` "
                         f"copies; got {db.dtype} {tuple(db.shape)}, tile {tile}, "
                         f"streams {streams}")
    if db.device.type == "cpu":
        return stream_max_ref(db, tile, streams)
    kernels.require_cuda("stream_max", db)
    out = torch.full((min(8, tile // streams), d), float("-inf"), dtype=torch.float32,
                     device=db.device)
    with torch.cuda.device(db.device):
        status = kernels.lib().rv_probe_dma(db.data_ptr(), n // tile, tile, n_bufs, streams, d,
                                            ctas_per_sm, out.data_ptr(),
                                            kernels.stream_ptr(db.device))
    kernels.check("stream_max", status)
    kernels.launches["probe_dma"] += 1
    return out


def seeded_rows(n_rows: int, d: int, device, generator: torch.Generator) -> torch.Tensor:
    return torch.randn((n_rows, d), generator=generator, device=device_of(device),
                       dtype=torch.bfloat16)


def bench(n_rows: int, tile: int, n_bufs: int, streams: int, ctas_per_sm: int = 1, *,
          device, generator: torch.Generator, db=None, iters: int = 10) -> dict:
    """One configuration on seeded rows (or `db`): its output, its error
    against the plain version (exact: a max), and on the card its time, GB/s
    and `torch.amax(db, 0)`'s time over the same bytes."""
    dev = device_of(device)
    if db is None:
        db = seeded_rows(n_rows, D, dev, generator)
    out = stream_max(db, tile, n_bufs, streams, ctas_per_sm)
    res = {"config": (tile, n_bufs, streams, ctas_per_sm), "out": out,
           "stage_kb": tile * db.shape[1] * 2 // 1024}
    if dev.type == "cpu":
        return res
    plain = stream_max_ref(db, tile, streams)
    res["max_abs_err"] = float((out - plain).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError(f"stream_max {res['config']}: max abs err {res['max_abs_err']} "
                             "against the plain version (must be exact)")
    nbytes = (db.shape[0] // tile) * tile * db.shape[1] * 2
    res["ms"] = timed_ms(lambda: stream_max(db, tile, n_bufs, streams, ctas_per_sm), iters)
    res["gb_s"] = nbytes / res["ms"] / 1e6
    return res


def library_ms(db: torch.Tensor, iters: int = 10) -> float:
    """`torch.amax(db, 0)`: one PyTorch call that reads the same bytes."""
    return timed_ms(lambda: torch.amax(db, 0), iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    a = ap.parse_args(argv)
    dev = device_of("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    db = seeded_rows(a.rows, D, dev, gen)
    best = None
    for tile, bufs, streams, ctas in SWEEP:
        name = (f"tile={tile:3d} rows ({tile * D * 2 // 1024:3d} KB) bufs={bufs} "
                f"streams={streams} ctas/SM={ctas}")
        if not fits(tile, bufs, streams, ctas):
            print(f"{name}: skipped ({ctas} x {smem_bytes(tile, bufs) // 1024} KB of shared "
                  "memory do not fit an SM)", flush=True)
            continue
        r = bench(a.rows, tile, bufs, streams, ctas, device=dev, generator=gen, db=db)
        print(f"{name}: {r['ms']:7.4f} ms  {r['gb_s']:6.0f} GB/s", flush=True)
        best = r if best is None or r["gb_s"] > best["gb_s"] else best
    lib = library_ms(db)
    print(f"torch.amax(db, 0): {lib:7.4f} ms  {a.rows * D * 2 / lib / 1e6:6.0f} GB/s; best "
          f"{best['config']} {best['gb_s']:.0f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
