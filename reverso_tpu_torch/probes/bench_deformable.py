"""P5: the per-lane row gather under K8, and K8 at GroundingDINO's encoder
shapes (the port of `scripts/bench_deformable.py`).

The gather micro: out[i, j] = the sum over it < 64 of tab[(idx[i, j] + it)
mod n, j], tab [n, 128] fp32 and idx [n, 128] int32, summed from 0 in the
order of it (`csrc/probe_gather.cu`): thread j of a row reads column j, so
a warp's lanes hit 32 banks. At the script's n = 8 and 256 and at 448, the
table in shared memory; at 13,294 rows (the encoder's value map at 800 px,
K8's gather source) in device memory behind L2. Reported in ns per
gathered row of 128 lanes, and, from a second run at 4096 steps, the
marginal ns a row once the table is loaded. On the TPU only n <= 8
compiled (`bench_deformable.py:137-141`).

K8 (`ops/deformable.py::ms_deform_attn`) is timed at the script's SHAPES,
B = 1, H = 8, D = 32, P = 4, in fp32 and bf16: the counterpart of the
script's `bench_xla`.

    python -m reverso_tpu_torch.probes.bench_deformable [--micro-only]
"""
from __future__ import annotations

import argparse

import torch

from .. import kernels
from . import device_of, timed_ms

# GroundingDINO-tiny encoder shapes at 800 px
SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))
LV = sum(h * w for h, w in SHAPES)     # 13294
B, H, D, P = 1, 8, 32, 4
LQ = LV
LANES, ITERS = 128, 64
SMEM_ROWS = 453          # rows of a [n, 128] fp32 table in 227 KB of shared memory
GATHER_ROWS = (8, 256, 448, LV)
LONG_ITERS = 4096        # the second run: the marginal cost of a gathered row


def gather_ref(tab: torch.Tensor, idx: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Plain version: acc = 0; acc += gather(tab, (idx + it) mod n) for it
    in order, fp32."""
    n = tab.shape[0]
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=tab.device)
    for it in range(iters):
        acc = acc + torch.gather(tab, 0, (idx + it) % n).float()
    return acc


def gather(tab: torch.Tensor, idx: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """P5's function of tab [n, 128] fp32 and idx [n, 128] int32; CPU
    tensors run `gather_ref`, CUDA tensors launch `rv_probe_gather`, the
    table in shared memory where it fits (n <= 453) and in device memory
    otherwise."""
    n = tab.shape[0]
    if tab.dtype != torch.float32 or idx.dtype != torch.int32 or tab.shape != (n, LANES) \
            or idx.shape != (n, LANES) or iters < 0:
        raise ValueError(f"gather: tab [n, {LANES}] fp32 and idx [n, {LANES}] int32; got "
                         f"{tab.dtype} {tuple(tab.shape)}, {idx.dtype} {tuple(idx.shape)}")
    if tab.device.type == "cpu":
        return gather_ref(tab, idx, iters)
    kernels.require_cuda("gather", tab, idx)
    out = torch.empty((n, LANES), dtype=torch.float32, device=tab.device)
    with torch.cuda.device(tab.device):
        status = kernels.lib().rv_probe_gather(tab.data_ptr(), idx.data_ptr(), n, iters,
                                               int(n <= SMEM_ROWS), out.data_ptr(),
                                               kernels.stream_ptr(tab.device))
    kernels.check("gather", status)
    kernels.launches["probe_gather"] += 1
    return out


def seeded(n: int, device, generator: torch.Generator) -> tuple:
    """The script's table (standard normal) and indices in [0, n)."""
    dev = device_of(device)
    tab = torch.randn((n, LANES), generator=generator, device=dev, dtype=torch.float32)
    idx = torch.randint(0, n, (n, LANES), generator=generator, device=dev, dtype=torch.int32)
    return tab, idx


def bench_gather(n: int, *, device, generator: torch.Generator) -> dict:
    """One table size on seeded data: the output, its error against the plain
    version (exact: the same adds in the same order) and on the card its
    time, ns per gathered row and the marginal ns a row at LONG_ITERS."""
    dev = device_of(device)
    tab, idx = seeded(n, dev, generator)
    out = gather(tab, idx)
    res = {"n": n, "out": out, "in_smem": n <= SMEM_ROWS}
    if dev.type == "cpu":
        return res
    res["max_abs_err"] = float((out - gather_ref(tab, idx)).abs().max())
    if res["max_abs_err"] != 0.0:
        raise AssertionError(f"gather n={n}: max abs err {res['max_abs_err']} (must be exact)")
    res["ms"] = timed_ms(lambda: gather(tab, idx), 10)
    res["ns_per_row"] = res["ms"] * 1e6 / (n * ITERS)
    long_ms = timed_ms(lambda: gather(tab, idx, LONG_ITERS), 3)
    res["marginal_ns_per_row"] = (long_ms - res["ms"]) * 1e6 / (n * (LONG_ITERS - ITERS))
    return res


def k8_inputs(dtype: torch.dtype, device, generator: torch.Generator) -> tuple:
    """The script's K8 inputs: value [B, LV, H, D], locations in [0, 1) and
    weights in [0, 1)."""
    dev = device_of(device)
    value = torch.randn((B, LV, H, D), generator=generator, device=dev).to(dtype)
    loc = torch.rand((B, LQ, H, len(SHAPES), P, 2), generator=generator, device=dev).to(dtype)
    w = torch.rand((B, LQ, H, len(SHAPES), P), generator=generator, device=dev).to(dtype)
    return value, loc, w


def k8_ms(dtype: torch.dtype, *, device, generator: torch.Generator) -> float:
    """K8 on the card at the script's shapes, ms a layer."""
    from ..ops.deformable import ms_deform_attn
    value, loc, w = k8_inputs(dtype, device, generator)
    return timed_ms(lambda: ms_deform_attn(value, SHAPES, loc, w), 10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--micro-only", action="store_true")
    a = ap.parse_args(argv)
    dev = device_of("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for n in GATHER_ROWS:
        r = bench_gather(n, device=dev, generator=gen)
        print(f"gather n={n:6d} float32 ({'shared memory' if r['in_smem'] else 'L2'}): "
              f"{r['ms']:8.4f} ms for {n * ITERS} gathered rows x{LANES} lanes -> "
              f"{r['ns_per_row']:7.3f} ns/row ({r['marginal_ns_per_row']:.3f} ns/row at "
              f"{LONG_ITERS} steps)", flush=True)
    if a.micro_only:
        return 0
    for dtype in (torch.float32, torch.bfloat16):
        print(f"K8 {str(dtype).replace('torch.', ''):8s}: "
              f"{k8_ms(dtype, device=dev, generator=gen):8.4f} ms/layer", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
