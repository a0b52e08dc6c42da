#!/usr/bin/env python3
"""Variants of the multi-scale deformable attention kernel
(`reverso_tpu_torch/csrc/ms_deform.cu`, K8) timed on one card.

    python3 scripts/ms_deform_probe.py [variant ...]

Compiles `ms_deform.cu` alone once per variant (all nvcc runs at once,
each into its own library in a temporary directory, with ptxas's register
counts printed), then, one process per variant, runs
`ops/deformable.py::ms_deform_attn` on that library at GroundingDINO-tiny's
shapes (levels 100x100 ... 13x13, H = 8, D = 32, L = P = 4): the encoder
(B = 4, Lq = 13,294) on locations drawn uniformly over the map and on
locations clustered around each query's own cell (the encoder's pattern),
and the decoder (B = 4, Lq = 900), in fp32 and bf16. Each is held
against the plain version (1e-5 in fp32, 2e-2 in bf16) and timed by CUDA
events after a device sleep (`chip_smoke.py::cuda_ms`, 20 calls). A
variant edits the source text: "no_loads" sums zeros in place of the
corner rows (what the kernel costs without its gathers; it breaks the
result, so it is not held), "one_query" and "four_queries" give each
warp one and four queries at every shape (the kernel picks by the grid's
size), "four_warps" makes a CTA 4 warps. Prints the card and one JSON
line per variant. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> {source text: its replacement}
VARIANTS = {
    "shipped": {},
    "no_loads": {"Vec<T, V>::load(vb + (size_t)p * row + (size_t)vec * V, f);":
                 "for (int e = 0; e < V; ++e) f[e] = 0.f;"},
    "one_query": {"const int qpw = tiles >= 8LL * sms ? MSD_QPW : 1;": "const int qpw = 1;"},
    "four_queries": {"const int qpw = tiles >= 8LL * sms ? MSD_QPW : 1;": "const int qpw = MSD_QPW;"},
    "four_warps": {"constexpr int MSD_WARPS = 8;": "constexpr int MSD_WARPS = 4;"},
}
EXACT = set(VARIANTS) - {"no_loads"}
SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def start_build(name: str, work: str):
    """Copies csrc/ into work/name, applies the variant's edits, starts nvcc."""
    from reverso_tpu_torch import kernels
    csrc = os.path.join(work, name)
    shutil.copytree(kernels.CSRC, csrc)
    path = os.path.join(csrc, "ms_deform.cu")
    text = open(path).read()
    for old, new in VARIANTS[name].items():
        if old not in text:
            raise RuntimeError(f"{old!r} not in ms_deform.cu")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(csrc, "libprobe.so")
    cmd = [nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, path]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_registers(log: str) -> dict:
    """Registers of each instantiation: {"<dtype> V=<v>": n}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN2rv16ms_deform_kernelI(\w+?)Li(\d+)E", line)
        if m:
            fn = f"{'bf16' if 'bfloat16' in m.group(1) else 'fp32'} V={m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out[fn] = int(m.group(1))
            fn = None
    return out


def clustered(torch, gen, b, lq, h, n_l, p, spread=0.02):
    """Locations around each query's own cell centre in every level (query i
    is position i of the flattened levels)."""
    pts = []
    for hl, wl in SHAPES:
        yy, xx = torch.meshgrid(torch.arange(hl, device="cuda"), torch.arange(wl, device="cuda"),
                                indexing="ij")
        pts.append(torch.stack([(xx.flatten() + 0.5) / wl, (yy.flatten() + 0.5) / hl], -1))
    ref = torch.cat(pts)[torch.arange(lq, device="cuda") % sum(a * c for a, c in SHAPES)]
    noise = torch.randn(b, lq, h, n_l, p, 2, generator=gen, device="cuda") * spread
    return ref[None, :, None, None, None, :] + noise


def run_variant(name: str, lib_path: str) -> dict:
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_ref

    lib = ctypes.CDLL(lib_path)
    fn = lib.rv_ms_deform
    fn.argtypes, fn.restype = kernels._SIGNATURES["rv_ms_deform"], ctypes.c_int
    kernels._lib = lib   # the wrapper launches this variant
    gen = torch.Generator(device="cuda").manual_seed(0)
    lv = sum(a * c for a, c in SHAPES)
    h, d, n_l, p = 8, 32, 4, 4
    out = dict(variant=name)
    for label, b, lq in (("encoder_uniform", 4, 13294), ("encoder_clustered", 4, 13294),
                         ("decoder_uniform", 4, 900)):
        loc = (clustered(torch, gen, b, lq, h, n_l, p) if "clustered" in label
               else torch.rand(b, lq, h, n_l, p, 2, generator=gen, device="cuda"))
        wt = torch.rand(b, lq, h, n_l, p, generator=gen, device="cuda")
        wt = wt / wt.sum(dim=(-2, -1), keepdim=True)
        for dt in (torch.float32, torch.bfloat16):
            value = torch.randn(b, lv, h, d, generator=gen, device="cuda").to(dt)
            got = ms_deform_attn(value, SHAPES, loc, wt)
            err = float((got.float() - ms_deform_attn_ref(value, SHAPES, loc, wt).float())
                        .abs().max())
            tol = 1e-5 if dt == torch.float32 else 2e-2
            if name in EXACT and err > tol:
                raise AssertionError(f"{name} {label} {dt}: max abs err {err}")
            key = f"{label}_{'fp32' if dt == torch.float32 else 'bf16'}"
            out[key] = dict(ms=cuda_ms(lambda: ms_deform_attn(value, SHAPES, loc, wt), iters=20),
                            max_abs_err=err)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ms_deform_probe: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"ms_deform_probe: unknown variants {unknown}; known {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="ms_deform_probe_")
    rc = 0
    try:
        builds = {name: start_build(name, work) for name in names}
        libs = {}
        for name, (lib, proc) in builds.items():
            log_out, log_err = proc.communicate()
            if proc.returncode != 0:
                print(f"{name}: nvcc failed ({proc.returncode})\n{log_err[-6000:]}", flush=True)
                rc = 1
                continue
            print(f"{name}: registers {json.dumps(ptxas_registers(log_out + log_err))}",
                  flush=True)
            libs[name] = lib
        for name, lib in libs.items():   # one process each: a hang is cut at its timeout
            try:
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant",
                                       name, lib], capture_output=True, text=True, timeout=120)
            except subprocess.TimeoutExpired:
                print(f"{name}: timed out", flush=True)
                rc = 1
                continue
            lines = proc.stdout.strip().splitlines()
            print(lines[-1] if proc.returncode == 0 and lines
                  else f"{name}: failed ({proc.returncode})\n{proc.stderr[-3000:]}", flush=True)
            rc |= proc.returncode
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
