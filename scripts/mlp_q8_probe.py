#!/usr/bin/env python3
"""Variants of the int8 MLP's kernels (`reverso_tpu_torch/csrc/fused_mlp.cu`,
K5: the row quantizer and the two s8 wgmma + TMA GEMMs) timed on one card.

    python3 scripts/mlp_q8_probe.py [variant ...]

Compiles `fused_mlp.cu` alone once per variant (all nvcc runs at once,
each into its own library in a temporary directory, with ptxas's
register and spill counts of the int8 kernels printed), then, one
process per variant, runs `ops/fused_mlp.py::fused_mlp_int8` on that
library at PE-L14's widths (1024 -> 4096 -> 1024, bf16, gelu) for T =
577, 4616 and 36,928 (one image, B = 8, B = 64), counts the elements
that differ from the plain version (`mlp_int8_plain`; 0 for every
variant that keeps the contract), and times the call by CUDA events after
a device sleep (`chip_smoke.py::cuda_ms`, 20 calls) and each of its three
kernels by `torch.profiler` (device time over 10 calls). A variant edits
the source text: "no_act" leaves the activation out (GEMM 1's epilogue
cost; it breaks the contract, so its differences are expected),
"g2_narrow" and "g2_wide" run GEMM 2 on 128 x 64 and 128 x 128 tiles at
every T (the launcher picks by the grid's size). Prints the card and one
JSON line per variant. Needs a CUDA card and nvcc.
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
    "no_act": {"float q8_act(float x, int act) {\n":
               "float q8_act(float x, int act) {\n    return x;\n"},
    "g2_narrow": {"if (wide_tiles >= sms)": "if (false)"},
    "g2_wide": {"if (wide_tiles >= sms)": "if (true)"},
}
# variants whose results must equal the plain version's
EXACT = set(VARIANTS) - {"no_act"}
SHAPES = (577, 4616, 36928)


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def start_build(name: str, work: str):
    """Copies csrc/ into work/name, applies the variant's edits, starts nvcc."""
    from reverso_tpu_torch import kernels
    csrc = os.path.join(work, name)
    shutil.copytree(kernels.CSRC, csrc)
    path = os.path.join(csrc, "fused_mlp.cu")
    text = open(path).read()
    for old, new in VARIANTS[name].items():
        if old not in text:
            raise RuntimeError(f"{old!r} not in fused_mlp.cu")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(csrc, "libprobe.so")
    cmd = [nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, path]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each int8 kernel instantiation."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1) if "mlp_q8" in m.group(1) else None
            continue
        if fn:
            key = re.sub(r"^_ZN2rv6mlp_q8\d+", "", fn)[:48]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(key, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out.setdefault(key, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def kernel_ms(torch, fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel `fn` launches, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(q8_\w+?)_kernel", ev.name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + ev.time_range.elapsed_us() / 1e3 / calls
    return {k: round(v, 4) for k, v in out.items()}


def run_variant(name: str, lib_path: str) -> dict:
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import bound, cuda_ms
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.fused_mlp import (fused_mlp_int8, mlp_int8_plain,
                                                 quantize_mlp_weights)

    lib = ctypes.CDLL(lib_path)
    fn = lib.rv_fused_mlp_int8
    fn.argtypes, fn.restype = kernels._SIGNATURES["rv_fused_mlp_int8"], ctypes.c_int
    kernels._lib = lib   # the wrapper launches this variant
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    w, hid = 1024, 4096

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf16)

    qw = quantize_mlp_weights(randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.02),
                              randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.02), bf16)
    out = dict(variant=name)
    for t in SHAPES:
        x = randn(t, w)
        y = fused_mlp_int8(x, qw)
        ref = mlp_int8_plain(x, qw, "gelu")
        torch.cuda.synchronize()
        differ = int((y != ref).sum())
        if name in EXACT and differ:
            raise AssertionError(f"{name} T={t}: {differ} elements differ from the plain version")
        out[f"T{t}"] = dict(
            differing=differ, ms=cuda_ms(lambda: fused_mlp_int8(x, qw), iters=20),
            kernel_ms=kernel_ms(torch, lambda: fused_mlp_int8(x, qw)),
            bound_ms=bound(2 * t * w * 2 + 2 * w * hid + (hid + w) * 8, 4 * t * w * hid,
                           "int8")[0])
        del x, y, ref
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mlp_q8_probe: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"mlp_q8_probe: unknown variants {unknown}; known {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="mlp_q8_probe_")
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
            print(f"{name}: ptxas {json.dumps(ptxas_usage(log_out + log_err))}", flush=True)
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
