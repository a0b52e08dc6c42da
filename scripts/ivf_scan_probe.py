#!/usr/bin/env python3
"""Variants of the IVF probed scan (K11: `reverso_tpu_torch/csrc/ivf_scan.cu`
on `topk_stream.cu`'s wgmma scan) timed on one card.

    python3 scripts/ivf_scan_probe.py [variant ...]

Builds `topk_stream.cu`, `ivf_scan.cu` and `fused_mlp.cu` (the split pass
for fp32 queries) into one library per source variant (all nvcc runs at
once, in a temporary directory), then, one process per variant, runs
`ivf_probe_scan` over 1,000,000 x 1024 unit rows in 1,024 random
clusters (`chip_smoke.py::ivf_layout`, 30% of the rows masked) at the
paths' shapes: bf16 Q = 1, 32 and 64 at nprobe 16, every cluster at
Q = 64 (beside K1 over the same rows), int8 Q = 64 at k = 20, fp32 Q = 64
and 1. Each result is held against `ivf_probe_scan_ref` (int8 bit for
bit, bf16 and fp32 within 1e-4 under the tie-margin rule; every cluster
against the exact scan), timed by CUDA events after a device sleep
(`chip_smoke.py::cuda_ms`, 10 calls), and profiled once
(`torch.profiler`: each kernel's device time: the plan's three, the
gather, the scan, the merge). Also the host time to enqueue a call.

Variants: "shipped"; "no_seed" builds the scan without its first-tile
gate seed (every score of a slice's first tile passes the gate); the
query-block variants keep the shipped library and change only
`ivf_geometry`'s block: "block_q" sizes it to Q (the widest block that
holds Q, as K1 does), "block_8" and "block_16" fix it. Prints the card
and one JSON line per variant. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("topk_stream.cu", "ivf_scan.cu", "fused_mlp.cu")
# source variant -> {file: {text: its replacement}}
EDITS = {"shipped": {},
         "no_seed": {"topk_stream.cu": {"if (t == 0 && k <= 32) {": "if (t == 0 && k <= 0) {"}}}
BLOCKS = {"block_q": None, "block_8": 8, "block_16": 16}   # geometry variants
VARIANTS = list(EDITS) + list(BLOCKS)
ENTRIES = ("rv_ivf_scan", "rv_ivf_plan", "rv_topk_stream", "rv_split_parts")


def start_build(name: str, work: str):
    """Copies csrc/ into work/name, applies the variant's edits, starts nvcc."""
    from reverso_tpu_torch import kernels
    csrc = os.path.join(work, name)
    shutil.copytree(kernels.CSRC, csrc)
    for src, edits in EDITS[name].items():
        path = os.path.join(csrc, src)
        text = open(path).read()
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"{old!r} not in {src}")
            text = text.replace(old, new)
        open(path, "w").write(text)
    lib = os.path.join(csrc, "libprobe.so")
    cmd = [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", *kernels.NVCC_FLAGS, "-shared",
           "-o", lib, *[os.path.join(csrc, src) for src in SOURCES]]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def device_ms(torch, fn) -> dict:
    """Device time of each kernel of one call, by name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if dt and e.key and not e.key.startswith("aten::"):
            name = e.key.split("(")[0].split("<")[0].replace("void ", "").split("::")[-1]
            out[name] = round(out.get(name, 0.0) + dt / 1e3, 4)
    return out


def run_variant(name: str, lib_path: str) -> dict:
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, ivf_bound, ivf_layout, topk_agree
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops import ivf_scan as iv
    from reverso_tpu_torch.ops.topk import (WG_ROWS, cosine_topk, cosine_topk_ref,
                                            int8_query_digits, quantize_db_int8, wg_m_tiles,
                                            wg_width)

    lib = ctypes.CDLL(lib_path)
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = kernels._SIGNATURES[entry], ctypes.c_int
    kernels._lib = lib   # the wrappers launch this variant
    if name in BLOCKS:   # the shipped rule for the splits, at another query block
        def geometry(qn, nprobe, k, cmax, m, *, wg, sms):
            n_block = BLOCKS[name] or iv.wg_plan(qn, k, wg, ivf=True)[0]
            tile = WG_ROWS * wg_m_tiles(wg_width(n_block, wg))
            tiles = max(1, -(-cmax // tile))
            rps = max(1, min(qn * nprobe // sms, tiles)) * tile
            return n_block, rps, max(1, -(-cmax // rps))

        iv.ivf_geometry = geometry
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d, n_cl = 1_000_000, 1024, 1024
    x = torch.randn(n, d, generator=gen, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    qf = x[torch.arange(64, device="cuda") * 3001].clone()
    qf += 0.05 * torch.randn(qf.shape, generator=gen, device="cuda")
    qf /= qf.norm(dim=1, keepdim=True)
    mask = (torch.rand(n, generator=gen, device="cuda") >= 0.3).to(torch.uint8)
    offsets, counts, base, cnt = ivf_layout(torch, gen, n, n_cl, 64, 16)
    every = torch.arange(n_cl, device="cuda")[None].expand(64, n_cl)
    base_all, cnt_all = offsets[every].int().contiguous(), counts[every].int().contiguous()
    cmax = int(counts.max())
    xb, qb = x.to(torch.bfloat16), qf.to(torch.bfloat16)
    v8, scale = quantize_db_int8(x)
    q_hi, q_lo, c2 = int8_query_digits(qf)
    i8 = (v8, qf, torch.stack([q_hi, q_lo]), c2 * scale)
    shapes = (("bf16 Q=1", (xb, qb[:1], None, None), 1, 10, "bfloat16"),
              ("bf16 Q=32", (xb, qb[:32], None, None), 32, 10, "bfloat16"),
              ("bf16 Q=64", (xb, qb, None, None), 64, 10, "bfloat16"),
              ("int8 Q=64 k=20", i8, 64, 20, "int8"),
              ("fp32 Q=64", (x, qf, None, None), 64, 10, "float32_split"),
              ("fp32 Q=1", (x, qf[:1], None, None), 1, 10, "float32_split"))
    out = dict(variant=name, cmax=cmax)
    for label, args, q, k, dtype in shapes:
        kw = dict(k=k, cmax=cmax, int8=dtype == "int8", mask_sorted=mask)
        call = lambda: iv.ivf_probe_scan(*args, base[:q], cnt[:q], **kw)
        s, pos = call()
        rs, rpos = iv.ivf_probe_scan_ref(*args, base[:q], cnt[:q], **kw)
        if dtype == "int8":
            torch.cuda.synchronize()
            if not (torch.equal(s, rs) and torch.equal(pos, rpos)):
                raise AssertionError(f"{label}: differs from the plain version")
        else:
            topk_agree(rs, rpos, s, pos, 1e-4, label)
        item = {"bfloat16": 2, "int8": 1, "float32_split": 4}[dtype]
        b = ivf_bound(torch, base[:q], cnt[:q], d, item, 2 if dtype == "int8" else 1, dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        host = (time.perf_counter() - t0) * 100
        out[label] = dict(ms=cuda_ms(call, iters=10), bound_ms=b[0], host_ms=host,
                          kernels=device_ms(torch, call),
                          geometry=iv.ivf_geometry(q, 16, k, cmax, n, wg=iv._wg_mode(args[0],
                                                   dtype == "int8"), sms=132))
    call = lambda: iv.ivf_probe_scan(xb, qb, None, None, base_all, cnt_all, k=10, cmax=cmax,
                                     int8=False)
    s, pos = call()
    rs, ri = cosine_topk_ref(xb, qb, 10)
    topk_agree(rs, ri, s, pos, 1e-4, "every cluster")
    out["bf16 Q=64 every cluster"] = dict(
        ms=cuda_ms(call, iters=10), k1_ms=cuda_ms(lambda: cosine_topk(xb, qb, 10), iters=10),
        bound_ms=ivf_bound(torch, base_all, cnt_all, d, 2, 1, "bfloat16")[0],
        kernels=device_ms(torch, call))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ivf_scan_probe: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    names = sys.argv[1:] or VARIANTS
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        print(f"ivf_scan_probe: unknown variants {unknown}; known {VARIANTS}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="ivf_scan_probe_")
    rc = 0
    try:
        sources = sorted({"shipped" if v in BLOCKS else v for v in names})
        builds = {v: start_build(v, work) for v in sources}
        libs = {}
        for v, (lib, proc) in builds.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                print(f"{v}: nvcc failed ({proc.returncode})\n{err[-6000:]}", flush=True)
                rc = 1
            else:
                libs[v] = lib
        for v in names:
            lib = libs.get("shipped" if v in BLOCKS else v)
            if lib is None:
                continue
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", v,
                                   lib], capture_output=True, text=True)
            if proc.returncode != 0:
                print(f"{v}: failed ({proc.returncode})\n{proc.stderr[-6000:]}", flush=True)
                rc = 1
            else:
                print(proc.stdout.strip().splitlines()[-1], flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
