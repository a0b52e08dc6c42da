#!/usr/bin/env python3
"""The rows a kernel change should leave as they are, measured in the tree
given (default: this checkout) on one card: each kernel's time
(`chip_smoke.py::cuda_ms`) and a hash of its output at the main paths'
shapes (K3 bf16 with RoPE at B = 8; K4 bf16 at T = 4616 and 36,928; K5 at
T = 4616; K7 bf16 at B = 8, S = 1297 and fp32 at B = 2; K6 at SAM's
shape with bf16 operands and on the split mode; the top-k scans over
1M x 1024: K1 bf16 at Q = 256 and 64, K1 on fp32 rows at Q = 64, K2
bf16 at Q = 64 with 10% of the rows kept, K9 at Q = 256, K10 at Q = 64
(k = 30, 10% kept), K12 at Q = 256 (k_fetch = 40)), the PE-Core-L14-336
forwards at B = 64 in bf16 and int8 and at B = 8 in fp32
(`chip_smoke.py::profiled`: host wall, device busy, output hash) and the
32-image region build (`chip_smoke.py::region_run`). With --scans, the
top-k scans alone (a change to csrc/topk_stream.cu). With --bwd, the
backward rows alone (a change to the backward kernels): K3's backward at
B = 2, S = 577, W = 1024, 16 heads with RoPE in fp32 and at B = 16 in
bf16, K4's backward at T = 9232, 1024 -> 4096 -> 1024, gelu, in fp32
(the kernel's call alone and the whole backward under autograd, with the
weights' parts as the tower caches them where the tree takes them) and in
bf16, each with a hash of its gradients. Prints one line, RESULT {json}.

    python3 scripts/compare_trees.py [tree root] [--scans | --bwd]

Run a parent checkout and the change in turns in one call (parent,
change, change, parent): equal hashes mean equal outputs bit for bit.
Builds nothing itself: the tree's kernels build at first use. Needs a
CUDA card and nvcc.
"""
import contextlib
import dataclasses
import hashlib
import importlib
import io
import json
import os
import sys
import tempfile

ARGS = [a for a in sys.argv[1:] if a not in ("--scans", "--bwd")]
SCANS = "--scans" in sys.argv[1:]
BWD = "--bwd" in sys.argv[1:]
ROOT = os.path.abspath(ARGS[0] if ARGS else
                       os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from reverso_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    attn = importlib.import_module("reverso_tpu_torch.ops.attention")
    mlp = importlib.import_module("reverso_tpu_torch.ops.fused_mlp")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def r(*shape, sc=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda") * sc).to(dt)

    def digest(t):
        return hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12]

    res = {"tree": ROOT}

    def row(name, fn, iters=20):
        out = fn()
        torch.cuda.synchronize()
        res[name] = [round(cs.cuda_ms(fn, iters=iters), 4), digest(out)]

    if BWD:
        bwd_rows(torch, attn, mlp, r, row, bf16)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    if not SCANS:
        kernel_rows(torch, attn, mlp, kernels, r, row, bf16)
    scan_rows(torch, r, row, bf16)
    if not SCANS:
        model_rows(torch, cs, res, digest)
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def kernel_rows(torch, attn, mlp, kernels, r, row, bf16):
    """K3, K4, K5, K7 and K6 at the main paths' shapes."""
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    cos, sin = (torch.from_numpy(a).cuda() for a in rope_2d_tables(24, 64))
    q, k, v = (r(8, 577, 1024, dt=bf16) for _ in range(3))
    row("k3_bf16", lambda: attn.flash_attention_heads(q, k, v, heads=16, cos=cos, sin=sin))
    w, hid = 1024, 4096
    wb = [z.to(bf16) for z in (r(hid, w, sc=w ** -0.5), r(hid, sc=0.02),
                               r(w, hid, sc=hid ** -0.5), r(w, sc=0.02))]
    x = r(4616, w, dt=bf16)
    row("k4_bf16_t4616", lambda: mlp.fused_mlp(x, *wb))
    x64 = r(36928, w, dt=bf16)
    row("k4_bf16_t36928", lambda: mlp.fused_mlp(x64, *wb), iters=10)
    qw = mlp.quantize_mlp_weights(*wb, bf16)
    row("k5_t4616", lambda: mlp.fused_mlp_int8(x, qw))
    del x64
    q, k, v = (r(8, 16, 1297, 64, dt=bf16) for _ in range(3))
    row("k7_bf16", lambda: attn.flash_attention(q, k, v))
    q, k, v = (r(2, 16, 1297, 64) for _ in range(3))
    row("k7_f32", lambda: attn.flash_attention(q, k, v))
    q, k, v = (r(4, 12, 4096, 64) for _ in range(3))
    bias = (r(4, 12, 4096, 64, sc=0.5), r(4, 12, 4096, 64, sc=0.5), 64)
    row("k6_fp32_in_bf16_operands", lambda: attn.flash_attention(q, k, v, rel_bias=bias),
        iters=10)
    o = torch.empty_like(q)

    def k6_split():
        status = kernels.lib().rv_flash_attn_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias[0].data_ptr(), bias[1].data_ptr(),
            o.data_ptr(), 48, 4096, 4096, 64, 64, 4096, 64 ** -0.5, kernels.stream_ptr(q.device))
        kernels.check("rv_flash_attn_split", status)
        return o

    row("k6_split", k6_split, iters=5)
    del q, k, v, bias, o
    torch.cuda.empty_cache()


def bwd_rows(torch, attn, mlp, r, row, bf16):
    """K3's and K4's backward through the tree's autograd Functions, fp32
    and bf16, at phase T's shapes; each row the gradients' hash."""
    import inspect

    from reverso_tpu_torch.ops.rope import rope_2d_tables

    cos, sin = (torch.from_numpy(a).cuda() for a in rope_2d_tables(24, 64))
    for name, b, dt in (("k3_bwd_f32_b2", 2, torch.float32), ("k3_bwd_bf16_b16", 16, bf16)):
        leaves = [r(b, 577, 1024, dt=dt).requires_grad_(True) for _ in range(3)]
        do = r(b, 577, 1024, dt=dt)
        out = attn.flash_attention_heads(*leaves, heads=16, cos=cos, sin=sin)
        row(name, lambda: torch.cat([g.flatten() for g in torch.autograd.grad(
            out, leaves, do, retain_graph=True)]))
        del leaves, do, out
    w, hid, t = 1024, 4096, 9232
    for suffix, dt in (("f32", torch.float32), ("bf16", bf16)):
        x, dy = r(t, w, dt=dt), r(t, w, dt=dt)
        w1, b1 = r(hid, w, sc=w ** -0.5, dt=dt), r(hid, sc=0.1, dt=dt)
        w2, b2 = r(w, hid, sc=hid ** -0.5, dt=dt), r(w, sc=0.1, dt=dt)
        parts = mlp.split_mlp_weights(w1, w2) if dt == torch.float32 else None
        extra = [parts] if "parts" in inspect.signature(mlp._mlp_bwd_launch).parameters else []
        row(f"k4_bwd_kernel_{suffix}", lambda: torch.cat(
            [o.flatten().float() for o in mlp._mlp_bwd_launch(x, w1, b1, w2, dy, "gelu",
                                                              *extra)]))
        leaves = [z.clone().requires_grad_(True) for z in (x, w1, b1, w2, b2)]
        y = mlp.fused_mlp(*leaves, act="gelu", parts=parts)
        row(f"k4_bwd_whole_{suffix}", lambda: torch.cat([g.flatten().float() for g in
                                                        torch.autograd.grad(
                                                            y, leaves, dy, retain_graph=True)]),
            iters=10)
        del x, dy, w1, b1, w2, b2, parts, leaves, y
    torch.cuda.empty_cache()


def scan_rows(torch, r, row, bf16):
    """The top-k scans on bf16, fp32, int8 and packed rows, 1M x 1024 (K1,
    K2, K9, K10, K12 at the paths' and the Q = 256 rows' shapes)."""
    topk = importlib.import_module("reverso_tpu_torch.ops.topk")
    tbin = importlib.import_module("reverso_tpu_torch.ops.binary")
    tk12 = importlib.import_module("reverso_tpu_torch.ops.topk_int8")
    x = r(1_000_000, 1024)
    x /= x.norm(dim=1, keepdim=True)
    qf = x[torch.arange(256, device="cuda") * 3001] + r(256, 1024, sc=0.05)
    qf /= qf.norm(dim=1, keepdim=True)
    folder3 = torch.arange(x.shape[0], device="cuda") % 10 == 3
    db, qb = x.to(bf16), qf.to(bf16)
    row("k1_bf16_q256", lambda: torch.cat([t.float() for t in topk.cosine_topk(db, qb, 10)], 1),
        iters=10)
    row("k1_bf16_q64", lambda: torch.cat([t.float() for t in topk.cosine_topk(
        db, qb[:64], 10)], 1), iters=10)
    row("k2_bf16_q64", lambda: torch.cat([t.float() for t in topk.cosine_topk(
        db, qb[:64], 10, row_mask=folder3)], 1), iters=10)
    del db
    row("k1_f32_q64", lambda: torch.cat([t.float() for t in topk.cosine_topk(
        x, qf[:64], 10)], 1), iters=10)
    v8, scale = topk.quantize_db_int8(x)
    row("k9_q256", lambda: torch.cat([t.float() for t in topk.cosine_topk_int8_exact(
        v8, scale, qf, 10)], 1), iters=10)
    del v8
    packed = torch.cat([tbin.pack_signs(x[lo:lo + 65536]) for lo in range(0, x.shape[0], 65536)])
    row("k10_q64", lambda: torch.cat([t.float() for t in tbin.binary_topk(
        packed, qf[:64], 30, 1024, row_mask=folder3)], 1), iters=10)
    del packed
    r8, rsc = tk12.quantize_rows(x)
    q8, qsc = tk12.quantize_queries(qf)
    row("k12_q256", lambda: torch.cat([t.float() for t in tk12.topk_int8_rows(
        r8, rsc, q8, qsc, 40)], 1), iters=10)
    del x, r8, rsc, folder3
    torch.cuda.empty_cache()


def model_rows(torch, cs, res, digest):
    """The PE-Core-L14-336 forwards and the region build."""
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    imgs = torch.randn(64, 336, 336, 3, generator=torch.Generator().manual_seed(9)).cuda()
    for quant in ("none", "int8", "f32"):
        cfg = MODEL_PRESETS["PE-Core-L14-336"]
        if quant == "int8":
            cfg = dataclasses.replace(cfg, quant="int8")
        x = imgs
        if quant == "f32":   # the fp32 tower (K3 and K4 fp32), B = 8
            cfg, x = dataclasses.replace(cfg, dtype="float32"), imgs[:8]
        enc = PerceptionEncoder(cfg, seed=3, device="cuda")
        with torch.inference_mode():
            prof = cs.profiled(torch, lambda: enc.module(x))
            res[f"forward_b{len(x)}_{quant}"] = [round(prof["wall_ms"], 3),
                                                 round(prof["device_busy_ms"], 3),
                                                 digest(enc.module(x))]
        del enc
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cs.region_run(tmp)
        line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("region slice: ")][0]
        res["region_build_s"] = round(json.loads(line[len("region slice: "):])["build_s"], 3)


if __name__ == "__main__":
    sys.exit(main())
