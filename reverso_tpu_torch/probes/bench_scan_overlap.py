"""P3: the top-k scan's TMA + wgmma pipeline without its k-select (the port
of `scripts/bench_scan_overlap.py`).

Scores Q bf16 queries against [N, d] bf16 rows at K1's own geometry
(`csrc/probe_scan.cu`: 128-query blocks, 128-row tiles, one wave of row
splits) and reduces the scores in one of three variants:

  unroll : out[q, c] = max over tiles t of q . row[t * TILE + c], [Q, TILE]
           with TILE = 128, the rows of K1's tile; scores kept in registers
  stage  : each query's max over all rows, [Q], the scores staged in shared
           memory two tiles at a time and reduced there (what a select reads)
  wide   : stage plus the TPU kernel's three extraction passes, [Q]

The TPU's `dyn` variant (a ring slot indexed at run time) has no meaning on
this card, where every ring stage is. K1 at the same shape (k = 10) is
timed beside them: its time less unroll's is the select's cost. Each
variant is checked on the script's queries (the first Q rows) and on
queries drawn apart from the rows: a query's max over the rows is then its
own self-dot, in the first tiles, for the former, and anywhere for the
latter, where a kernel that drops a tile, a row split or a pair of staged
tiles shows.

    python -m reverso_tpu_torch.probes.bench_scan_overlap
"""
from __future__ import annotations

import argparse

import torch

from .. import kernels
from . import device_of, reassociation_tol, timed_ms

N, D, Q = 1024 * 1024, 1024, 256
TILE = 128
# variant -> the kernel's (csrc/probe_scan.cu::kUnroll, kStage, kWide)
VARIANTS = {"unroll": 0, "stage": 1, "wide": 2}
# K1's ring depth at Q = 256, k = 10 (csrc/topk_stream.cu::scan_wg::stages_at):
# unroll runs at it; stage and wide at as many stages as fit beside their
# 128 KB of staged scores (three)
K1_STAGES = 5


def scan_ref(db: torch.Tensor, q: torch.Tensor, variant: str, tile: int = TILE) -> torch.Tensor:
    """Plain version: the fp32 scores q @ db.T, then the max over tiles
    (unroll: [Q, tile], rows past the last whole tile at -inf) or over rows
    (stage, wide: [Q])."""
    if variant not in VARIANTS:
        raise ValueError(f"scan: variant {variant!r} not in {sorted(VARIANTS)}")
    s = q.float() @ db.float().T
    if variant != "unroll":
        return s.amax(1)
    pad = -s.shape[1] % tile
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    return s.view(s.shape[0], -1, tile).amax(1)


def scan(db: torch.Tensor, q: torch.Tensor, variant: str):
    """P3's function; CPU tensors run `scan_ref`, CUDA tensors launch
    `rv_probe_scan` (bf16, d % 8 == 0, 16-byte aligned bases) with a ring
    of K1's depth for unroll and of as many stages as fit otherwise."""
    if variant not in VARIANTS:
        raise ValueError(f"scan: variant {variant!r} not in {sorted(VARIANTS)}")
    if db.dtype != torch.bfloat16 or q.dtype != torch.bfloat16 or db.ndim != 2 \
            or q.ndim != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"scan: bf16 db [N, d] and q [Q, d]; got {db.dtype} "
                         f"{tuple(db.shape)}, {q.dtype} {tuple(q.shape)}")
    if db.device.type == "cpu":
        return scan_ref(db, q, variant)
    kernels.require_cuda("scan", db, q)
    n, d = db.shape
    nq = q.shape[0]
    shape = (nq, TILE) if variant == "unroll" else (nq,)
    out = torch.full(shape, float("-inf"), dtype=torch.float32, device=db.device)
    stages = K1_STAGES if variant == "unroll" else 0
    with torch.cuda.device(db.device):
        status = kernels.lib().rv_probe_scan(db.data_ptr(), q.data_ptr(), n, d, nq,
                                             VARIANTS[variant], stages, out.data_ptr(),
                                             kernels.stream_ptr(db.device))
    kernels.check("scan", status)
    kernels.launches["probe_scan"] += 1
    return out


def seeded(n: int, d: int, nq: int, device, generator: torch.Generator) -> tuple:
    """Seeded rows and the script's queries, the first Q rows."""
    db = torch.randn((n, d), generator=generator, device=device_of(device),
                     dtype=torch.bfloat16)
    return db, db[:nq]


def queries(nq: int, d: int, device, generator: torch.Generator) -> torch.Tensor:
    """Seeded queries drawn apart from the rows."""
    return torch.randn((nq, d), generator=generator, device=device_of(device),
                       dtype=torch.bfloat16)


def check(db: torch.Tensor, q: torch.Tensor, variant: str, out=None) -> float:
    """The kernel's output (`out`, or a launch) against `scan_ref`: returns
    the max abs error, raising past `reassociation_tol`."""
    out = scan(db, q, variant) if out is None else out
    err = float((out - scan_ref(db, q, variant)).abs().max())
    tol = reassociation_tol(q, db)
    if not err <= tol:
        raise AssertionError(f"scan {variant}: max abs err {err} > {tol}")
    return err


def bench(variant: str, n: int = N, d: int = D, nq: int = Q, *, device,
          generator: torch.Generator, db=None, q=None) -> dict:
    """One variant on seeded rows (or `db`, `q`): the output; on the card
    its distance from the plain version on those queries and on queries
    drawn apart (`check`), its time on the former and the rows' effective
    read rate."""
    dev = device_of(device)
    if db is None:
        db, q = seeded(n, d, nq, dev, generator)
    out = scan(db, q, variant)
    res = {"variant": variant, "out": out}
    if dev.type == "cpu":
        return res
    apart = queries(q.shape[0], db.shape[1], dev, generator)
    res["max_abs_err"] = max(check(db, q, variant, out), check(db, apart, variant))
    res["ms"] = timed_ms(lambda: scan(db, q, variant))
    res["gb_s"] = db.numel() * 2 / res["ms"] / 1e6
    return res


def k1_ms(db: torch.Tensor, q: torch.Tensor, k: int = 10, iters: int = 5) -> float:
    """K1 (`ops/topk.py::cosine_topk`) over the same rows and queries."""
    from ..ops.topk import cosine_topk
    return timed_ms(lambda: cosine_topk(db, q, k), iters)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    db, q = seeded(N, D, Q, dev, gen)
    for v in VARIANTS:
        r = bench(v, device=dev, generator=gen, db=db, q=q)
        print(f"{v:7s}: {r['ms']:7.4f} ms scan+matmul ({r['gb_s']:5.0f} GB/s effective; "
              f"max abs err {r['max_abs_err']:.3g})", flush=True)
    print(f"K1 (k = 10): {k1_ms(db, q):7.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
