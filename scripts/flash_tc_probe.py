#!/usr/bin/env python3
"""Variants of the tensor-core flash core (`reverso_tpu_torch/csrc/
flash_tc.cuh`), its bf16 modes and its fp32 split mode, timed on one card.

    python3 scripts/flash_tc_probe.py [variant ...]

Copies `csrc/` once per variant (each in a temporary directory), applies
the variant's edits to `flash_tc.cuh` (or `hopper.cuh`), and compiles
the four flash sources of every variant at once (a `split_` variant only
the split mode's two) into a library of their own, with
ptxas's registers and spill bytes of the split mode's instantiations
printed. Then, one process per variant, it times by CUDA events after a
device sleep (`chip_smoke.py::cuda_ms`, 30 calls) and, for the split
mode, holds each result against the fp32 `attention_ref` (max abs err):

  * the split mode: K7 in fp32 (B = 2, H = 16, S = 1297, D = 64), K6
    with fp32 operands (SAM's global layer, B = 4, H = 12, S = 4096, D =
    64, G = 64, the bias mode of a tile one lattice row), beside SDPA, and
    K3 in fp32 with RoPE (B = 2 and 8, S = 577, W = 1024, 16 heads);
  * the bf16 core ("shipped" and the tile variants only): K3 (B = 8,
    S = 577, W = 1024, 16 heads, RoPE tables on the card, and its no-RoPE
    mode), K7 (B = 8, S = 1297, bf16) and K6 (fp32 inputs with the
    wrapper's bf16 casts, bf16 inputs, the kernel alone on bf16 operands,
    and the same launch without the bias).

The variants: the tile shapes the bf16 core did not take; two diagnostics
of the RoPE pass (every key reading the tables' row 0: they stay in L1,
the results are wrong; K tiles left unrotated); the split mode's design
choices (nine products, exact exp2f, the PV product in one tensor-core
accumulator, no register hand-over, two ring stages, one consumer
warpgroup, batches of four units in the lanes' RoPE loads); and, for
where the split mode's time goes, the loop with parts of it left out (the
results are wrong): the producers' split pass, the softmax, the split of
p, and all three ("products only"). Names on the command line pick
variants (default: all). Prints the card and one JSON line per variant.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH_SOURCES = ("flash_attn.cu", "flash_attn_split.cu", "flash_heads.cu",
                 "flash_heads_split.cu")
FLASH_LAUNCHERS = ("rv_flash_heads_tc", "rv_flash_heads_split", "rv_flash_attn_tc",
                   "rv_flash_attn_split")
SPLIT_SOURCES = ("flash_attn_split.cu", "flash_heads_split.cu")
SPLIT_LAUNCHERS = ("rv_flash_attn_split", "rv_flash_heads_split")
# the sources a variant's edits may touch (the split mode's product table
# sits in hopper.cuh)
EDITED = ("flash_tc.cuh", "hopper.cuh")


def split_only(name: str) -> bool:
    """A split-mode variant builds and times the split mode alone."""
    return name.startswith("split_")


SKIP_SPLIT_PASS = ("lane_tiles<T, PARTS, HD, BK, kWgThreads, 2>(",
                   "if (false) lane_tiles<T, PARTS, HD, BK, kWgThreads, 2>(")
SKIP_SOFTMAX = ("softmax_tile<BK, BIAS == kBiasRow>(sc,",
                "if (false) softmax_tile<BK, BIAS == kBiasRow>(sc,")
SKIP_P_SPLIT = ("        if constexpr (PARTS == 3) {\n            split2(sc",
                "        if constexpr (false) {\n            split2(sc")

# name -> [(text in flash_tc.cuh or hopper.cuh, replacement)]; "shipped"
# edits nothing
VARIANTS = {
    "shipped": [],
    "rope_tables_row_0": [("(size_t)(row0 + r) * HD", "(size_t)0")],
    "rope_k_unrotated": [("rope_tile<HD, BK, 32>(ks", "if (false) rope_tile<HD, BK, 32>(ks")],
    "one_warpgroup_with_rope": [("NWG = SPLIT ? (HD <= 64 ? 2 : 1) : ROPE ? 2 : 1;",
                                 "NWG = SPLIT && HD <= 64 ? 2 : 1;")],
    "two_warpgroups_without_rope": [("NWG = SPLIT ? (HD <= 64 ? 2 : 1) : ROPE ? 2 : 1;", "NWG = 2;")],
    "keys_per_tile_128": [("constexpr int kBK = 64;", "constexpr int kBK = 128;")],
    "three_stages": [("STAGES = ROTATING_WARPS ? 6 : SPLIT ? 3 : 4;", "STAGES = 3;")],
    "split_nine_products": [
        ("constexpr int kSplitTerms = 6;", "constexpr int kSplitTerms = 9;"),
        ("{{2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}}",
         "{{2, 2}, {1, 2}, {2, 1}, {2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}}")],
    "split_exact_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                          "y = exp2f(x);")],
    "split_one_accumulator": [("constexpr bool PROMOTE = PARTS == 3;",
                               "constexpr bool PROMOTE = false;")],
    "split_no_register_handover": [("SPLIT && NWG == 2 ? (HD % 32 ? 136 : 120) : 0", "0")],
    "split_two_stages": [("STAGES = ROTATING_WARPS ? 6 : SPLIT ? 3 : 4;",
                          "STAGES = ROTATING_WARPS ? 6 : SPLIT ? 2 : 4;")],
    "split_rope_batch_4": [("    constexpr int BATCH = ITERS < 2 ? ITERS : 2;\n    constexpr int QH",
                            "    constexpr int BATCH = ITERS < 4 ? ITERS : 4;\n    constexpr int QH")],
    "split_one_warpgroup": [("NWG = SPLIT ? (HD <= 64 ? 2 : 1) : ROPE ? 2 : 1;", "NWG = SPLIT ? 1 : ROPE ? 2 : 1;")],
    "split_pass_skipped": [SKIP_SPLIT_PASS],
    "split_softmax_skipped": [SKIP_SOFTMAX],
    "split_p_unsplit": [SKIP_P_SPLIT],
    "split_products_only": [SKIP_SPLIT_PASS, SKIP_SOFTMAX, SKIP_P_SPLIT],
}


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def start_build(name: str, work: str) -> dict:
    """Copies csrc/ into work/name, applies the edits, starts one nvcc per
    flash source."""
    from reverso_tpu_torch import kernels
    csrc = os.path.join(work, name)
    shutil.copytree(kernels.CSRC, csrc)
    texts = {f: open(os.path.join(csrc, f)).read() for f in EDITED}
    for old, new in VARIANTS[name]:
        where = [f for f in EDITED if old in texts[f]]
        if not where:
            raise RuntimeError(f"{name}: {old!r} not in {' or '.join(EDITED)}")
        texts[where[0]] = texts[where[0]].replace(old, new)
    for f, text in texts.items():
        open(os.path.join(csrc, f), "w").write(text)
    jobs = {}
    for src in SPLIT_SOURCES if split_only(name) else FLASH_SOURCES:
        obj = os.path.join(csrc, src + ".o")
        cmd = [nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
               os.path.join(csrc, src)]
        jobs[obj] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
    return dict(csrc=csrc, jobs=jobs, lib=os.path.join(csrc, "libprobe.so"))


def finish_build(build: dict) -> tuple[bool, str]:
    log, ok = "", True
    for proc in build["jobs"].values():
        out, err = proc.communicate()
        log += out + err
        ok &= proc.returncode == 0
    if ok:
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
               build["lib"], *build["jobs"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        ok = proc.returncode == 0
    return ok, log


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each split-mode instantiation
    (flash_tc_kernel<HD, BK, NWG, STAGES, ROPE, BIAS, OPS = 2>)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"_Z\w*flash_tc_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb[01]ELi(\d)ELi2E",
                      fn or "")
        if not m:
            continue
        key = f"HD={m.group(1)} BK={m.group(2)} NWG={m.group(3)} bias={m.group(5)}"
        m2 = re.search(r"(\d+) bytes spill stores", line)
        if m2:
            out.setdefault(key, {})["spill_stores"] = int(m2.group(1))
        m2 = re.search(r"Used (\d+) registers", line)
        if m2:
            out.setdefault(key, {})["registers"] = int(m2.group(1))
    return out


def run_variant(name: str, lib_path: str) -> dict:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (attention_ref, flash_attention,
                                                  flash_attention_heads,
                                                  flash_attention_heads_ref)
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    kernels.build = lambda force=False: lib_path
    launchers = SPLIT_LAUNCHERS if split_only(name) else FLASH_LAUNCHERS
    kernels._SIGNATURES = {k: v for k, v in kernels._SIGNATURES.items() if k in launchers}
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = kernels.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    out = dict(variant=name)

    def split(q, k, v, bias=None):
        """The split mode through its launcher (SAM's fp32 bias takes the
        bf16 core by the wrapper's rule)."""
        o = torch.empty_like(q)
        b, h, s, d = q.shape
        g = bias[2] if bias else 0
        kernels.check("rv_flash_attn_split", lib.rv_flash_attn_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias[0].data_ptr() if bias else None,
            bias[1].data_ptr() if bias else None, o.data_ptr(), b * h, s, k.shape[2], d, g,
            k.shape[2], d ** -0.5, kernels.stream_ptr(q.device)))
        return o

    q, k, v = (torch.randn(2, 16, 1297, 64, generator=gen, device="cuda") for _ in range(3))
    out["k7_f32_err"] = float((split(q, k, v) - attention_ref(q, k, v)).abs().max())
    out["k7_f32_ms"] = cuda_ms(lambda: split(q, k, v), iters=30)
    out["k7_f32_sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=30)
    b, h, s, d, g = 4, 12, 4096, 64, 64
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda") for _ in range(3))
    bias = tuple(torch.randn(b, h, s, g, generator=gen, device="cuda") * 0.5
                 for _ in range(2)) + (g,)
    out["k6_f32_err"] = float((split(q, k, v, bias) - attention_ref(q, k, v, rel_bias=bias))
                              .abs().max())
    out["k6_f32_ms"] = cuda_ms(lambda: split(q, k, v, bias), iters=10)
    # K3 in fp32: heads in lanes with RoPE (the lanes rotate, then split), at
    # the depth-2 tower's B = 2 and the full-depth forward's B = 8
    cos, sin = (torch.from_numpy(t).cuda() for t in rope_2d_tables(24, 64, cls_token=True))
    q3, k3, v3 = (torch.randn(8, 577, 1024, generator=gen, device="cuda") for _ in range(3))
    kw = dict(heads=16, cos=cos, sin=sin)
    out["k3_f32_err"] = float((flash_attention_heads(q3[:2], k3[:2], v3[:2], **kw)
                               - flash_attention_heads_ref(q3[:2], k3[:2], v3[:2], **kw))
                              .abs().max())
    out["k3_f32_ms"] = cuda_ms(lambda: flash_attention_heads(q3[:2], k3[:2], v3[:2], **kw),
                               iters=30)
    out["k3_f32_b8_ms"] = cuda_ms(lambda: flash_attention_heads(q3, k3, v3, **kw), iters=30)
    del q3, k3, v3
    if split_only(name):
        return out

    out["k6_ms"] = cuda_ms(lambda: flash_attention(q, k, v, rel_bias=bias), iters=30)
    q16, k16, v16 = (t.to(bf16) for t in (q, k, v))
    out["k6_bf16_ms"] = cuda_ms(lambda: flash_attention(q16, k16, v16, rel_bias=bias),
                                iters=30)
    # the kernel alone: bf16(q * scale) made once, as the wrapper makes it per call
    qs, o = (q * d ** -0.5).to(bf16), torch.empty_like(q)
    out["k6_kernel_ms"] = cuda_ms(lambda: lib.rv_flash_attn_tc(
        qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), bias[0].data_ptr(),
        bias[1].data_ptr(), o.data_ptr(), b * h, s, s, d, g, s, 1.0,
        kernels.DTYPE_CODES[f32], kernels.stream_ptr(q.device)), iters=30)
    out["k6_no_bias_kernel_ms"] = cuda_ms(lambda: lib.rv_flash_attn_tc(
        qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), None, None, o.data_ptr(), b * h, s,
        s, d, 0, s, 1.0, kernels.DTYPE_CODES[f32], kernels.stream_ptr(q.device)), iters=30)
    del q, k, v, q16, k16, v16, qs, o
    q, k, v = (torch.randn(8, 16, 1297, 64, generator=gen, device="cuda").to(bf16)
               for _ in range(3))
    out["k7_ms"] = cuda_ms(lambda: flash_attention(q, k, v), iters=30)
    out["k7_sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=30)
    b, s, w, heads = 8, 577, 1024, 16
    cos, sin = (torch.from_numpy(t).cuda() for t in rope_2d_tables(24, 64, cls_token=True))
    q, k, v = (torch.randn(b, s, w, generator=gen, device="cuda").to(bf16) for _ in range(3))
    out["k3_ms"] = cuda_ms(lambda: flash_attention_heads(q, k, v, heads=heads, cos=cos,
                                                         sin=sin), iters=30)
    out["k3_no_rope_ms"] = cuda_ms(lambda: flash_attention_heads(q, k, v, heads=heads),
                                   iters=30)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_tc_probe: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    work = tempfile.mkdtemp(prefix="flash_tc_probe_")
    rc = 0
    try:
        builds = {name: start_build(name, work) for name in names}
        for name in names:   # one process each: a fresh library per variant
            ok, log = finish_build(builds[name])
            if not ok:
                print(f"{name}: build failed\n{log[-3000:]}", flush=True)
                rc = 1
                continue
            print(f"{name}: ptxas (split mode) {json.dumps(ptxas_usage(log))}", flush=True)
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", name,
                                   builds[name]["lib"]],
                                  capture_output=True, text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            print(lines[-1] if proc.returncode == 0 and lines
                  else f"{name}: failed ({proc.returncode})\n{proc.stderr[-2000:]}", flush=True)
            rc |= proc.returncode
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
