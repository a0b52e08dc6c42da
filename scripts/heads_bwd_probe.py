#!/usr/bin/env python3
"""Variants of K3's tensor-core backward (`reverso_tpu_torch/csrc/
flash_heads_bwd_tc.cu`), timed on one card.

    python3 scripts/heads_bwd_probe.py [variant ...]

Copies `csrc/` once per variant (each in a temporary directory), applies
the variant's edits to `flash_heads_bwd_tc.cu`, and compiles every
variant's copy at once into a library of its own (ptxas's registers and
spill bytes of the dq and dk / dv kernels at head dim 64 printed). The
port's own library runs K3's forward, which writes each row's
log-sum-exp. Then each variant's `rv_flash_heads_bwd_tc` runs at PE-L14's
training shape (B = 16, S = 577, W = 1024, 16 heads of 64) and at PE-G14's
head dim (B = 4, S = 1025, W = 1536, 16 heads of 96) in bf16, and its
`rv_flash_heads_bwd_parts` in fp32 (the split mode) at B = 2, S = 577,
W = 1024, RoPE tables on the card: its time by CUDA events after a device sleep
(`chip_smoke.py::cuda_ms`, the median of 5 repeats of 20 calls), each
kernel's device time (`chip_smoke.py::kernel_times`) and its error
against the autograd of the plain forward (max over dq, dk, dv of the
max abs error over max(1, the largest plain value)).

The variants: the loops with parts left out, for where the time goes
(the results are wrong): the exponentials and the dS arithmetic, the RS
products (dq, dv, dk), the SS products (S, dP), all three, the dk / dv
producer's lse and D loads (zeros), the epilogues' stores (each of
these in both modes); and the CTA shapes the shipped kernels choose
between by head dim (`Cfg`): in bf16 two consumer warpgroups (128 rows)
in one CTA an SM at every head dim, and one consumer warpgroup a CTA
with two CTAs an SM at every head dim (a two-stage ring above head dim
80, so that two fit an SM); in the split mode one CTA an SM at head dim
64 (a four-stage ring) for the shipped two. Names on the
command line pick variants (default: all). Prints the card and one JSON
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
SOURCE = "flash_heads_bwd_tc.cu"

SKIP_MATH = [(head, head + "        return;\n") for head in (
    f"    auto {fn} = [&]({arg}) {{\n" for fn, arg in (
        ("probs", "int j"), ("grad_scores", ""), ("probs", "int i"), ("grad_scores", "int i")))]
VARIANTS = {
    "shipped": [],
    "skip_math": SKIP_MATH,
    "skip_rs": [("pv_tile<HD, BK, PARTS>(", "if (false) pv_tile<HD, BK, PARTS>(")],
    "skip_ss": [("qk_tile<HD, BK, PARTS>(", "if (false) qk_tile<HD, BK, PARTS>(")],
    "skip_all": SKIP_MATH + [("pv_tile<HD, BK, PARTS>(", "if (false) pv_tile<HD, BK, PARTS>("),
                             ("qk_tile<HD, BK, PARTS>(", "if (false) qk_tile<HD, BK, PARTS>(")],
    "stats_const": [("nl[r] = row < p.S ? p.lse[srow + row] : CUDART_INF_F;", "nl[r] = 0.f;"),
                    ("nd[r] = row < p.S ? p.dsum[srow + row] : 0.f;", "nd[r] = 0.f;")],
    "skip_store": [("store_out<HD, PARTS>(p.d", "if (false) store_out<HD, PARTS>(p.d")],
    "two_wgs_one_cta": [("NWG = !SPLIT && HD > 80 ? 2 : 1;", "NWG = !SPLIT ? 2 : 1;"),
                        ("CTAS = (SPLIT ? HD <= 64 : HD <= 80) ? 2 : 1;",
                         "CTAS = (SPLIT ? HD <= 64 : false) ? 2 : 1;")],
    "one_wg_two_ctas": [("NWG = !SPLIT && HD > 80 ? 2 : 1;", "NWG = 1;"),
                        ("CTAS = (SPLIT ? HD <= 64 : HD <= 80) ? 2 : 1;",
                         "CTAS = (SPLIT ? HD <= 64 : true) ? 2 : 1;"),
                        ("STAGES = !SPLIT ? 4 :", "STAGES = !SPLIT ? (HD <= 80 ? 4 : 2) :")],
    "split_one_cta": [("CTAS = (SPLIT ? HD <= 64 : HD <= 80) ? 2 : 1;",
                       "CTAS = (SPLIT ? false : HD <= 80) ? 2 : 1;")],
}
# (name, B, S, W, heads, dtype): PE-L14's training shape and PE-G14's head
# dim 96 in bf16, the fp32 tower's at B = 2
SHAPES = (("PE-L14", 16, 577, 1024, 16, "bfloat16"), ("PE-G14", 4, 1025, 1536, 16, "bfloat16"),
          ("PE-L14 fp32", 2, 577, 1024, 16, "float32"))
# variants whose results are the shipped kernel's
EXACT = ("shipped", "two_wgs_one_cta", "one_wg_two_ctas", "split_one_cta")


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def start_build(name: str, work: str) -> dict:
    """Copies csrc/ into work/name, applies the edits, starts nvcc."""
    from reverso_tpu_torch import kernels
    csrc = os.path.join(work, name)
    shutil.copytree(kernels.CSRC, csrc)
    path = os.path.join(csrc, SOURCE)
    text = open(path).read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {SOURCE}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(csrc, "libprobe.so")
    cmd = [nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, path]
    return dict(lib=lib, proc=subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True))


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of the dq and dk / dv kernels at head dims
    64 and 96, bf16 (<hd, 1>) and the split mode (<hd, 3>)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"hbwd\d+(dq_kernel|dkv_kernel)ILi(64|96)ELi(\d)E", fn or "")
        if not m:
            continue
        key = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
        m2 = re.search(r"(\d+) bytes spill stores", line)
        if m2:
            out.setdefault(key, {})["spill_stores"] = int(m2.group(1))
        m2 = re.search(r"Used (\d+) registers", line)
        if m2:
            out.setdefault(key, {})["registers"] = int(m2.group(1))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("heads_bwd_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, kernel_times
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import _heads_launch, flash_attention_heads_grad_ref
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    kernels.lib()
    work = tempfile.mkdtemp(prefix="heads_bwd_probe_")
    try:
        builds = {name: start_build(name, work) for name in names}
        dev = torch.device("cuda")
        cases = []
        for shape, b, s, w, heads, dtype in SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(1)
            hd = w // heads
            dt = getattr(torch, dtype)
            q, k, v, do = (torch.randn(b, s, w, generator=gen, device=dev).to(dt)
                           for _ in range(4))
            c, sn = rope_2d_tables(int(np.sqrt(s - 1)), hd, cls_token=True)
            cos, sin = torch.from_numpy(c).to(dev), torch.from_numpy(sn).to(dev)
            lse = torch.empty((b * heads, s), dtype=torch.float32, device=dev)
            o = _heads_launch(q, k, v, heads, (cos, sin), hd ** -0.5, s, lse)
            refs = flash_attention_heads_grad_ref(q, k, v, do, heads=heads, cos=cos, sin=sin)
            dsum = torch.empty_like(lse)
            if dt == torch.bfloat16:   # rv_flash_heads_bwd_tc's scratch: qr, kr, D
                entry, scratch = "rv_flash_heads_bwd_tc", (torch.empty_like(q),
                                                           torch.empty_like(k), dsum)
            else:   # rv_flash_heads_bwd_parts': the operands' parts, D
                pitch = heads * (-(-hd // 16) * 16)
                entry, scratch = "rv_flash_heads_bwd_parts", (torch.empty(
                    (4, 3, b, s, pitch), dtype=torch.bfloat16, device=dev), dsum)
            cases.append(dict(
                shape=shape, dims=(b, s, w, heads), ins=(q, k, v, o, do, lse, cos, sin),
                entry=entry, scratch=scratch,
                extra=() if dt == torch.bfloat16 else (kernels.DTYPE_CODES[dt], pitch),
                grads=[torch.empty_like(q) for _ in range(3)], refs=refs))
        for name in names:
            build = builds[name]
            out, err = build["proc"].communicate()
            row = dict(variant=name, ptxas=ptxas_usage(out + err))
            if build["proc"].returncode != 0:
                row["build_error"] = (out + err)[-2000:]
                print(json.dumps(row), flush=True)
                continue
            lib = ctypes.CDLL(build["lib"])
            for entry in ("rv_flash_heads_bwd_tc", "rv_flash_heads_bwd_parts"):
                getattr(lib, entry).argtypes = kernels._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
            for case in cases:
                b, s, w, heads = case["dims"]
                fn = getattr(lib, case["entry"])

                def call():
                    kernels.check(name, fn(
                        *(t.data_ptr() for t in case["ins"]),
                        *(t.data_ptr() for t in case["scratch"]),
                        *(t.data_ptr() for t in case["grads"]), b, s, w, heads, s,
                        (w // heads) ** -0.5, 1, *case["extra"], kernels.stream_ptr(dev)))

                call()
                torch.cuda.synchronize()
                res = dict(ms=float(np.median([cuda_ms(call, iters=20) for _ in range(5)])))
                res["kernels_ms"], res["kernels_ms_check"] = kernel_times(torch, call, res["ms"])
                if name in EXACT:
                    call()
                    res["max_err"] = max(
                        float((g.float() - r.float()).abs().max())
                        / max(1.0, float(r.float().abs().max()))
                        for g, r in zip(case["grads"], case["refs"]))
                row[case["shape"]] = res
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
