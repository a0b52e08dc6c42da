"""P4: a TMA load of 512 rows at a data-dependent offset, then their scores
against 8 resident queries (the port of `scripts/proto_dyn_dma.py`), the
primitive of K11's gather of a probed cluster.

For each of `reps` offsets read from a device int32 array, the rows
mat[off : off + 512] of a [262,144, 1024] int8 or bf16 matrix are loaded
and scored against q [8, 1024]: out [reps, 8, 512] fp32
(`csrc/probe_dyn_dma.cu`). Checked at the script's offsets (0, 1, 7, 31,
33, 517 and n - 515): int8 exactly (s32 sums below 2^24), bf16 within
fp32 reassociation. Then timed at 512 aligned (multiples of 512) and
unaligned offsets, interleaved, in two forms: one CTA walking the reps in
order (the TPU's form: time a load-and-product) and a grid of one CTA an
SM (the rate). The script's random offsets overlap (512 blocks of 512 rows
cover about 63% of the rows), so the grid is timed too at offsets of
blocks that do not overlap, aligned and unaligned: there every byte it
loads is a distinct byte of device memory; and at offsets inside the first
L2_ROWS rows, which L2 holds: the rate of loads from L2.

    python -m reverso_tpu_torch.probes.proto_dyn_dma
"""
from __future__ import annotations

import argparse

import torch

from .. import kernels
from . import device_of, reassociation_tol, timed_ms

N, D, ROWS, NQ = 262144, 1024, 512, 8
REPS = 512
L2_ROWS = 12288     # 24 MB of bf16 rows, 12 MB of int8: within an H100's 50 MB L2
DTYPES = (torch.int8, torch.bfloat16)


def offsets(n: int, rows: int = ROWS) -> tuple:
    """The script's awkward offsets."""
    return (0, 1, 7, 31, 33, 517, n - rows - 3)


def distinct_offsets(n: int, shift: int, device, generator: torch.Generator,
                     rows: int = ROWS) -> torch.Tensor:
    """Offsets of blocks of `rows` rows that do not overlap, in a seeded
    order: b * rows + shift for every whole block past the shift."""
    blocks = (n - shift) // rows
    return (torch.randperm(blocks, generator=generator, device=device_of(device)) * rows
            + shift).int()


def distinct_rows(offs: torch.Tensor, rows: int = ROWS) -> int:
    """The rows that the blocks at `offs` cover together."""
    s = offs.long().sort().values
    return int((s[1:] - s[:-1]).clamp(max=rows).sum()) + rows if s.numel() else 0


def dyn_dma_ref(offs: torch.Tensor, q: torch.Tensor, mat: torch.Tensor,
                rows: int = ROWS) -> torch.Tensor:
    """Plain version: out[r, i, j] = q[i] . mat[offs[r] + j] in fp32 (int8:
    in float64, exact, then fp32: every sum is an integer below 2^24)."""
    wide = torch.float64 if mat.dtype == torch.int8 else torch.float32
    out = []
    for off in offs.tolist():
        out.append((q.to(wide) @ mat[off:off + rows].to(wide).T).float())
    return torch.stack(out)


def dyn_dma_tol(q: torch.Tensor, mat: torch.Tensor) -> float:
    """The kernel's allowed distance from `dyn_dma_ref`: 0 in int8, fp32
    reassociation (`reassociation_tol`) in bf16."""
    return 0.0 if mat.dtype == torch.int8 else reassociation_tol(q, mat)


def dyn_dma(offs: torch.Tensor, q: torch.Tensor, mat: torch.Tensor, grid: int = 0):
    """P4's function (rows = 512); CPU tensors run `dyn_dma_ref`, CUDA
    tensors launch `rv_probe_dyn_dma` on `grid` CTAs (0: one an SM; 1: the
    TPU's one core). Offsets must lie in [0, n - 512]."""
    n, d = mat.shape
    if mat.dtype not in (torch.int8, torch.bfloat16) or q.dtype != mat.dtype \
            or q.shape != (NQ, d) or offs.dtype != torch.int32 or offs.ndim != 1 \
            or n < ROWS or grid < 0:
        raise ValueError(f"dyn_dma: int8 or bf16 mat [n >= {ROWS}, d] and q [{NQ}, d], int32 "
                         f"offsets; got {mat.dtype} {tuple(mat.shape)}, {q.dtype} "
                         f"{tuple(q.shape)}, {offs.dtype} {tuple(offs.shape)}")
    if mat.device.type == "cpu":
        return dyn_dma_ref(offs, q, mat)
    kernels.require_cuda("dyn_dma", offs, q, mat)
    out = torch.empty((offs.shape[0], NQ, ROWS), dtype=torch.float32, device=mat.device)
    code = kernels.INT8 if mat.dtype == torch.int8 else kernels.DTYPE_CODES[torch.bfloat16]
    with torch.cuda.device(mat.device):
        status = kernels.lib().rv_probe_dyn_dma(mat.data_ptr(), q.data_ptr(), offs.data_ptr(),
                                                n, d, offs.shape[0], code, grid,
                                                out.data_ptr(), kernels.stream_ptr(mat.device))
    kernels.check("dyn_dma", status)
    kernels.launches["probe_dyn_dma"] += 1
    return out


def seeded(dtype: torch.dtype, n: int, d: int, device, generator: torch.Generator) -> tuple:
    """The script's data: int8 in [-127, 127] or standard normal bf16."""
    dev = device_of(device)
    if dtype == torch.int8:
        return tuple(torch.randint(-127, 128, shape, generator=generator, device=dev,
                                   dtype=torch.int8) for shape in ((n, d), (NQ, d)))
    return tuple(torch.randn(shape, generator=generator, device=dev, dtype=dtype)
                 for shape in ((n, d), (NQ, d)))


def check(offs: torch.Tensor, q: torch.Tensor, mat: torch.Tensor, grid: int = 0) -> float:
    """The kernel against the plain version at `offs`, in chunks of 64 reps;
    returns the max abs error, raising past `dyn_dma_tol`."""
    out = dyn_dma(offs, q, mat, grid)
    tol, err = dyn_dma_tol(q, mat), 0.0
    for c in range(0, offs.shape[0], 64):
        err = max(err, float((out[c:c + 64] - dyn_dma_ref(offs[c:c + 64], q, mat))
                             .abs().max()))
    if not err <= tol:
        raise AssertionError(f"dyn_dma {mat.dtype} grid {grid}: max abs err {err} > {tol}")
    return err


def bench(dtype: torch.dtype, n: int = N, d: int = D, *, device,
          generator: torch.Generator) -> dict:
    """The script's checks and timings on seeded data: the output at the
    awkward offsets (both forms) and their errors, then aligned and
    unaligned offsets timed in turns, per load-and-product (one CTA) and as
    a rate (the grid; over the bytes loaded, and over the distinct bytes),
    each checked too; then the grid at blocks that do not overlap and at
    offsets inside the first L2_ROWS rows."""
    dev = device_of(device)
    mat, q = seeded(dtype, n, d, dev, generator)
    awkward = torch.tensor(offsets(n), dtype=torch.int32, device=dev)
    res = {"dtype": str(dtype).replace("torch.", ""), "out": dyn_dma(awkward, q, mat),
           "offsets": offsets(n)}
    if dev.type == "cpu":
        return res
    res["max_abs_err"] = max(check(awkward, q, mat, grid) for grid in (0, 1))
    aligned = torch.randint(0, (n - ROWS) // 512, (REPS,), generator=generator, device=dev,
                            dtype=torch.int32) * 512
    unaligned = torch.randint(0, n - ROWS, (REPS,), generator=generator, device=dev,
                              dtype=torch.int32)
    row_bytes = d * mat.element_size()
    nbytes = REPS * ROWS * row_bytes
    for offs in (aligned, unaligned):
        res["max_abs_err"] = max(res["max_abs_err"], check(offs, q, mat))
    for name, offs in (("aligned", aligned), ("unaligned", unaligned),
                       ("aligned2", aligned), ("unaligned2", unaligned)):
        one = timed_ms(lambda: dyn_dma(offs, q, mat, 1), 3)
        grid = timed_ms(lambda: dyn_dma(offs, q, mat, 0), 10)
        res[name] = {"us_per_load_dot": one * 1e3 / REPS, "one_cta_gb_s": nbytes / one / 1e6,
                     "grid_ms": grid, "grid_gb_s": nbytes / grid / 1e6,
                     "grid_distinct_gb_s": distinct_rows(offs) * row_bytes / grid / 1e6}
    in_l2 = torch.randint(0, min(n, L2_ROWS) - ROWS, (REPS,), generator=generator,
                          device=dev, dtype=torch.int32)
    for name, offs in (("distinct_aligned", distinct_offsets(n, 0, dev, generator)),
                       ("distinct_unaligned", distinct_offsets(n, 7, dev, generator)),
                       ("in_l2", in_l2)):
        res["max_abs_err"] = max(res["max_abs_err"], check(offs, q, mat))
        grid = timed_ms(lambda: dyn_dma(offs, q, mat, 0), 10)
        res[name] = {"reps": offs.numel(), "grid_ms": grid,
                     "grid_gb_s": offs.numel() * ROWS * row_bytes / grid / 1e6}
    return res


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for dtype in DTYPES:
        r = bench(dtype, device=dev, generator=gen)
        for off in r["offsets"]:
            print(f"{r['dtype']} off={off}: checked (max abs err over all "
                  f"{r['max_abs_err']:.3g})", flush=True)
        for name in ("aligned", "unaligned", "aligned2", "unaligned2"):
            t = r[name]
            print(f"{r['dtype']} {name}: {t['us_per_load_dot']:7.2f} us/dma-dot one CTA "
                  f"({t['one_cta_gb_s']:.0f} GB/s); grid {t['grid_ms']:.4f} ms "
                  f"({t['grid_gb_s']:.0f} GB/s loaded, {t['grid_distinct_gb_s']:.0f} GB/s "
                  f"distinct)", flush=True)
        for name in ("distinct_aligned", "distinct_unaligned", "in_l2"):
            t = r[name]
            print(f"{r['dtype']} {name} ({t['reps']} blocks): grid {t['grid_ms']:.4f} ms "
                  f"({t['grid_gb_s']:.0f} GB/s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
