#!/usr/bin/env python3
"""Variants of the bf16 tensor-core flash core (`reverso_tpu_torch/csrc/
flash_tc.cuh`) timed on one card.

    python3 scripts/flash_tc_probe.py [variant ...]

Builds the shipped kernels and edited copies of `csrc/` (each in a
temporary directory, with its own build) and times, with each, K3 (B = 8,
S = 577, W = 1024, 16 heads, RoPE tables on the card, and its no-RoPE
mode), K7 (B = 8, H = 16, S = 1297, D = 64, bf16) and K6 (SAM's global
layer, B = 4, H = 12, S = 4096, D = 64, G = 64, with the rel-pos bias:
fp32 inputs with the wrapper's bf16 casts, bf16 inputs, the kernel alone
on bf16 operands, and the same kernel launch without the bias) beside
SDPA, by CUDA events after a device sleep (`chip_smoke.py::cuda_ms`, 30
calls). The variants are the tile shapes the core did not take and two
diagnostics of the RoPE pass (every key reading the tables' row 0: they
stay in L1, the results are wrong; K tiles left unrotated). Names on the
command line pick variants (default: all). Prints the card and one JSON line per variant.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (text in flash_tc.cuh, replacement); "shipped" edits nothing
VARIANTS = {
    "shipped": None,
    "rope_tables_row_0": ("(size_t)(row0 + r) * HD", "(size_t)0"),
    "rope_k_unrotated": ("rope_tile<HD, BK, 32>(ks", "if (false) rope_tile<HD, BK, 32>(ks"),
    "one_warpgroup_with_rope": ("NWG = ROPE ? 2 : 1;", "NWG = 1;"),
    "two_warpgroups_without_rope": ("NWG = ROPE ? 2 : 1;", "NWG = 2;"),
    "keys_per_tile_128": ("constexpr int kBK = 64;", "constexpr int kBK = 128;"),
    "three_stages": ("STAGES = ROPE ? 6 : 4;", "STAGES = 3;"),
}


def run_variant(name: str) -> dict:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import flash_attention, flash_attention_heads
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    work = tempfile.mkdtemp(prefix=f"flash_tc_{name}_")
    try:
        csrc = os.path.join(work, "csrc")
        shutil.copytree(kernels.CSRC, csrc)
        edit = VARIANTS[name]
        if edit is not None:
            path = os.path.join(csrc, "flash_tc.cuh")
            text = open(path).read()
            if edit[0] not in text:
                raise RuntimeError(f"{name}: {edit[0]!r} not in flash_tc.cuh")
            open(path, "w").write(text.replace(edit[0], edit[1]))
        kernels.CSRC = csrc
        kernels.BUILD_DIR = os.path.join(work, "build")
        kernels.LIB_PATH = os.path.join(kernels.BUILD_DIR, "libreverso_kernels.so")
        kernels.lib()

        gen = torch.Generator(device="cuda").manual_seed(0)
        bf16 = torch.bfloat16
        out = dict(variant=name)
        q, k, v = (torch.randn(8, 16, 1297, 64, generator=gen, device="cuda").to(bf16)
                   for _ in range(3))
        out["k7_ms"] = cuda_ms(lambda: flash_attention(q, k, v), iters=30)
        out["k7_sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=30)
        b, s, w, heads = 8, 577, 1024, 16
        cos, sin = (torch.from_numpy(t).cuda() for t in rope_2d_tables(24, 64, cls_token=True))
        q, k, v = (torch.randn(b, s, w, generator=gen, device="cuda").to(bf16) for _ in range(3))
        split = lambda t: t.reshape(b, s, heads, 64).transpose(1, 2).contiguous()
        qh, kh, vh = split(q), split(k), split(v)
        out["k3_ms"] = cuda_ms(lambda: flash_attention_heads(q, k, v, heads=heads, cos=cos,
                                                             sin=sin), iters=30)
        out["k3_no_rope_ms"] = cuda_ms(lambda: flash_attention_heads(q, k, v, heads=heads),
                                       iters=30)
        out["k3_sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                    iters=30)
        del q, k, v, qh, kh, vh
        b, h, s, d, g = 4, 12, 4096, 64, 64
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda") for _ in range(3))
        bias = tuple(torch.randn(b, h, s, g, generator=gen, device="cuda") * 0.5
                     for _ in range(2)) + (g,)
        out["k6_ms"] = cuda_ms(lambda: flash_attention(q, k, v, rel_bias=bias), iters=30)
        q16, k16, v16 = (t.to(bf16) for t in (q, k, v))
        out["k6_bf16_ms"] = cuda_ms(lambda: flash_attention(q16, k16, v16, rel_bias=bias),
                                    iters=30)
        # the kernel alone: bf16(q * scale) made once, as the wrapper makes it per call
        qs, o = (q * d ** -0.5).to(bf16), torch.empty_like(q)
        lib = kernels.lib()
        out["k6_kernel_ms"] = cuda_ms(lambda: lib.rv_flash_attn_tc(
            qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), bias[0].data_ptr(),
            bias[1].data_ptr(), o.data_ptr(), b * h, s, s, d, g, s, 1.0,
            kernels.DTYPE_CODES[torch.float32], kernels.stream_ptr(q.device)), iters=30)
        out["k6_no_bias_kernel_ms"] = cuda_ms(lambda: lib.rv_flash_attn_tc(
            qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), None, None, o.data_ptr(), b * h, s,
            s, d, 0, s, 1.0, kernels.DTYPE_CODES[torch.float32], kernels.stream_ptr(q.device)),
            iters=30)
        out["k7_rate_ms_at_k6_flops"] = out["k7_ms"] * (b * h * s * s) / (8 * 16 * 1297 ** 2)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_tc_probe: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2])), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    rc = 0
    for name in sys.argv[1:] or VARIANTS:   # one process each: a fresh library per build
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", name],
                              capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        print(lines[-1] if proc.returncode == 0 and lines
              else f"{name}: failed ({proc.returncode})\n{proc.stderr[-2000:]}", flush=True)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
