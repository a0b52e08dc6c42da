#!/usr/bin/env python3
"""Variants of the wgmma top-k scan (`reverso_tpu_torch/csrc/topk_stream.cu`,
`scan_wg`: K1, K2 on bf16 and fp32 rows, K10, K9 and K12) timed on one card.

    python3 scripts/topk_scan_probe.py [variant ...]

Compiles `topk_stream.cu` (with `fused_mlp.cu`, for the split pass that
makes fp32 queries' parts) once per variant (all nvcc runs at once,
each into its own library in a temporary directory, with ptxas's
register and spill counts of the scan's instantiations printed, by query
block N and mode), then, one process per variant, runs `cosine_topk`,
`binary_topk`, `cosine_topk_int8_exact` and `topk_int8_rows` on that
library over 1,000,000 x 1024 unit rows at the shapes the paths and the
Q = 256 rows use, holds the variants that keep the results against the
plain versions (scores within 1e-4, bf16, and 2e-4, binary, ids where the
margins are clear; int8 ids and scores bit for bit) and times each call by
CUDA events after a device sleep (`chip_smoke.py::cuda_ms`, 10 calls).
Also K1 and K2 on fp32 rows (the split mode) at Q = 64 and 256.
A variant edits the source text. "no_qstream" loads the query operand
only into the ring's first stages and reuses it (what re-reading the
queries from L2 for every row tile costs); "no_gate" compares every
score with its query's k-th but never admits one (the products, the
loads and the gate's compares); "no_qstream_gate" makes both edits (the
query stream's cost to the products alone). Those three break the
results; the others are held against the plain versions too:
"bin_one_buffer" unpacks the binary fragments into one buffer at
N = 128 too (no overlap of a step's unpack with the last step's
products); "mt1" gives each warpgroup one m64 tile (128-row tiles) at
every N, where two (256-row tiles) ship up to N = 64; "n256" lets
the query block grow to 256 (one block at Q = 256, so the rows are read
once, but the accumulator takes 128 registers); "i8_n128" lets the int8
modes' blocks grow to 128 queries (the rows read twice at Q = 256 in
place of four times; K9's accumulator n256, 128 registers; K12's select
over twice the lists a CTA); "f32_n64" caps the fp32 mode's blocks at 64
queries (two m64 tiles a warpgroup, the rows read four times at
Q = 256); "f32_no_setmaxnreg" runs the fp32 mode with the other modes'
producer warp (no register hand-over to the consumers); "kserial0" and "kserial128" move the
threshold between a thread's serial insert and a warp merge (48 list
shifts ship); "stages4" caps the ring
at 4 stages (8 ship); "profile" defines RV_SCAN_PROFILE, and CTA 0 of
each launch prints its clock64() cycles in the products, the gate, the
select rounds and their barrier waits. Prints the card and one JSON
line per variant (and the profile's lines). Needs a CUDA card and nvcc.
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
    "no_qstream": {
        "mbar_expect_tx(&full[s], (copy ? 0 : A_BYTES) + QB);":
        "const bool qload = j < stages;\n"
        "                    mbar_expect_tx(&full[s], (copy ? 0 : A_BYTES) + (qload ? QB : 0));",
        "tma_load_2d(st + A_BYTES, &qmap, &full[s], ks * KS, q0);":
        "if (qload) tma_load_2d(st + A_BYTES, &qmap, &full[s], ks * KS, q0);",
        "tma_load_3d(st + A_BYTES + p * N * 64, &qmap, &full[s], ks * KS, q0, p);":
        "if (qload) tma_load_3d(st + A_BYTES + p * N * 64, &qmap, &full[s], ks * KS, q0, p);",
        "if (MODE == kModeI8)   // the lo digits, rows Q .. 2Q - 1 of the map":
        "if (MODE == kModeI8 && qload)"},
    "no_gate": {"if (__ballot_sync(FULL, p[0] || p[1] || p[2] || p[3]) == 0u) continue;":
                "if (__ballot_sync(FULL, p[0] || p[1] || p[2] || p[3]) != 7u) continue;"},
    "no_qstream_gate": {},   # both edits, filled in below
    "bin_one_buffer": {"if constexpr (MT == 1 && N <= 128) {": "if constexpr (MT == 0) {"},
    "mt1": {"return w <= 64 ? 2 : 1;": "return 1;"},
    "stages4": {"constexpr int kMaxStages = 8;": "constexpr int kMaxStages = 4;"},
    "n256": {"constexpr int kNMax = 128;": "constexpr int kNMax = 256;",
             "RV_WG_CASE(128)\n": "RV_WG_CASE(128) RV_WG_CASE(256)\n"},
    "i8_n128": {"constexpr int kNMaxI8 = 64;": "constexpr int kNMaxI8 = 128;"},
    "f32_no_setmaxnreg": {"return mode == kModeF32 ? 3 * kWgThreads : kThreads;": "return kThreads;",
                          "            setmaxnreg_dec<kF32ProducerRegs>();\n": "",
                          "    if constexpr (F32) setmaxnreg_inc<": "    if constexpr (false) setmaxnreg_inc<"},
    "f32_n64": {"return mode == kModeI8 || mode == kModeI8Rows ? kNMaxI8 : kNMax;":
                "return mode == kModeI8 || mode == kModeI8Rows || mode == kModeF32 ? kNMaxI8 : kNMax;"},
    "kserial0": {"constexpr int kSerial = 48;": "constexpr int kSerial = 0;"},
    "kserial128": {"constexpr int kSerial = 48;": "constexpr int kSerial = 128;"},
    "profile": {'#include "hopper.cuh"': '#define RV_SCAN_PROFILE\n#include "hopper.cuh"'},
}
VARIANTS["no_qstream_gate"] = {**VARIANTS["no_qstream"], **VARIANTS["no_gate"]}
EXACT = {"shipped", "bin_one_buffer", "profile", "n256", "stages4", "mt1", "i8_n128",
         "kserial0", "kserial128", "f32_n64", "f32_no_setmaxnreg"}
# (label, kind, Q, k, masked): K1 at the direct-embed path's Q = 1 and 64 and
# the Q = 256 row, K2 at the capacity path's Q = 64 and the Q = 256 row, K10
# at the capacity path's Q = 64 and the Q = 256 row, K9 at the capacity
# path's Q = 64 (masked) and the Q = 256 row, K12 at the two-stage search's
# Q = 256, k_fetch = 40, K1 and K2 on fp32 rows at the float32 store's Q = 64
# and the Q = 256 row
SHAPES = (("K1 Q=1 k=10", "bf16", 1, 10, False), ("K1 Q=64 k=5", "bf16", 64, 5, False),
          ("K1 Q=256 k=10", "bf16", 256, 10, False), ("K2 Q=64 k=10", "bf16", 64, 10, True),
          ("K2 Q=256 k=10", "bf16", 256, 10, True), ("K10 Q=64 k=30", "binary", 64, 30, False),
          ("K10 Q=256 k=30", "binary", 256, 30, False), ("K9 Q=64 k=10", "int8", 64, 10, True),
          ("K9 Q=256 k=10", "int8", 256, 10, False), ("K12 Q=256 k=40", "int8_rows", 256, 40, False),
          ("K1 fp32 Q=64 k=10", "f32", 64, 10, False), ("K1 fp32 Q=256 k=10", "f32", 256, 10, False),
          ("K2 fp32 Q=64 k=10", "f32", 64, 10, True))
MODES = {"0": "bf16", "1": "bin", "2": "int8", "3": "int8 rows", "4": "f32"}   # scan_wg::kMode*


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def start_build(name: str, work: str):
    """Copies csrc/ into work/name, applies the variant's edits, starts nvcc."""
    from reverso_tpu_torch import kernels
    csrc = os.path.join(work, name)
    shutil.copytree(kernels.CSRC, csrc)
    path = os.path.join(csrc, "topk_stream.cu")
    text = open(path).read()
    for old, new in VARIANTS[name].items():
        if old not in text:
            raise RuntimeError(f"{old!r} not in topk_stream.cu")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(csrc, "libprobe.so")
    # fused_mlp.cu, as it is, for the split pass that makes fp32 queries' parts
    cmd = [nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, path,
           os.path.join(csrc, "fused_mlp.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each scan instantiation (N, mode)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1) if "topk_scan_wg" in m.group(1) else None
            continue
        if fn:
            t = re.search(r"ILi(\d+)ELi(\d)EE", fn)
            key = f"N={t.group(1)} {MODES[t.group(2)]}" if t else fn[-40:]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(key, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out.setdefault(key, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def run_variant(name: str, lib_path: str) -> dict:
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import bound, cuda_ms, topk_agree
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.binary import binary_topk, binary_topk_ref, pack_signs
    from reverso_tpu_torch.ops.topk import (cosine_topk, cosine_topk_int8_exact,
                                            cosine_topk_int8_ref, cosine_topk_ref,
                                            quantize_db_int8)
    from reverso_tpu_torch.ops.topk_int8 import (quantize_queries, quantize_rows,
                                                 topk_int8_rows, topk_int8_rows_ref)

    lib = ctypes.CDLL(lib_path)
    for entry in ("rv_topk_stream", "rv_topk_int8_rows", "rv_split_parts"):
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = kernels._SIGNATURES[entry], ctypes.c_int
    kernels._lib = lib   # the wrappers launch this variant
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = 1_000_000, 1024
    x = torch.randn(n, d, generator=gen, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    db = x.to(torch.bfloat16)
    packed = torch.cat([pack_signs(x[lo:lo + 65536]) for lo in range(0, n, 65536)])
    v8, scale = quantize_db_int8(x)             # K9's rows, one global scale
    r8, rsc = quantize_rows(x)                  # K12's rows, a scale each
    db32 = x                                    # the float32 store's rows
    qf = db[torch.arange(256, device="cuda") * 3001].float()
    qf += 0.05 * torch.randn(qf.shape, generator=gen, device="cuda")
    qf /= qf.norm(dim=1, keepdim=True)
    folder3 = torch.arange(n, device="cuda") % 10 == 3   # the capacity path's 10%
    out = dict(variant=name)
    for label, kind, q, k, masked in SHAPES:
        qs = qf[:q]
        m = folder3 if masked else None
        if kind == "f32":
            call = lambda: cosine_topk(db32, qs, k, row_mask=m)
            ref = lambda: cosine_topk_ref(db32, qs, k, row_mask=m)
            tol, b = 1e-4, bound(n * d * 4 + (n if masked else 0) + q * d * 4 + q * k * 8,
                                 2 * q * n * d, "float32_split")
        elif kind == "bf16":
            qb = qs.to(torch.bfloat16)
            call = lambda: cosine_topk(db, qb, k, row_mask=m)
            ref = lambda: cosine_topk_ref(db, qb, k, row_mask=m)
            tol, b = 1e-4, bound(n * d * 2 + (n if masked else 0) + q * d * 2 + q * k * 8,
                                 2 * q * n * d, "bfloat16")
        elif kind == "binary":
            call = lambda: binary_topk(packed, qs, k, d, row_mask=m)
            ref = lambda: binary_topk_ref(packed, qs, k, d, row_mask=m)
            tol, b = 2e-4, bound(n * d // 8 + q * d * 2 + q * k * 8, 2 * q * n * d, "bfloat16")
        elif kind == "int8":
            call = lambda: cosine_topk_int8_exact(v8, scale, qs, k, row_mask=m)
            ref = lambda: cosine_topk_int8_ref(v8, scale, qs, k, row_mask=m)
            tol, b = 0.0, bound(n * d + (n if masked else 0) + 2 * q * d + q * k * 8,
                                2 * 2 * q * n * d, "int8")
        else:
            q8, qsc = quantize_queries(qs)
            call = lambda: topk_int8_rows(r8, rsc, q8, qsc, k)
            ref = lambda: topk_int8_rows_ref(r8, rsc, q8, qsc, k)
            tol, b = 0.0, bound(n * d + n * 4 + q * d + q * 4 + q * k * 8, 2 * q * n * d,
                                "int8")
        s, i = call()
        err = None
        if name in EXACT:
            rs, ri = ref()
            if tol == 0.0:   # int8: bit for bit
                if not (torch.equal(i, ri) and torch.equal(s, rs)):
                    raise AssertionError(f"{label}: differs from the plain version")
            else:
                topk_agree(rs, ri, s, i, tol)
            fin = torch.isfinite(rs)
            err = float((torch.where(fin, s, 0) - torch.where(fin, rs, 0)).abs().max())
        torch.cuda.synchronize()
        out[label] = dict(ms=cuda_ms(call, iters=10), bound_ms=b[0], bound_by=b[1],
                          max_abs_err=err)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_scan_probe: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"topk_scan_probe: unknown variants {unknown}; known {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="topk_scan_probe_")
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
            for line in sorted(set(x for x in (log_out + log_err).splitlines()
                                   if "C7515" in x or "C7510" in x)):   # wgmma serialized
                print(f"{name}: {line.strip()[:400]}", flush=True)
            libs[name] = lib
        for name, lib in libs.items():   # one process each: a hang is cut at its timeout
            try:
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant",
                                       name, lib], capture_output=True, text=True, timeout=150)
            except subprocess.TimeoutExpired:
                print(f"{name}: timed out", flush=True)
                rc = 1
                continue
            lines = proc.stdout.strip().splitlines()
            for line in sorted(set(x for x in lines if x.startswith("scan_wg"))):
                print(f"{name}: {line}", flush=True)   # the profile's per-CTA counts
            print(lines[-1] if proc.returncode == 0 and lines
                  else f"{name}: failed ({proc.returncode})\n{proc.stderr[-3000:]}", flush=True)
            rc |= proc.returncode
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
