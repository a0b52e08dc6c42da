#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`reverso_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them. Phases, none
of which catches a failure:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `reverso_tpu_torch/csrc` (one nvcc per
     source, all at once);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it and at small ragged shapes, in the
     working dtype: max abs error against a stated tolerance, CUDA-event
     times of the kernel, its plain version and (where one PyTorch call
     computes the same function) that call, and the least time the card
     could take (`bound_ms`);
  4. depth-reduced full-width towers on the card (kernels) against the
     same weights on the CPU (plain versions), fp32: PE-Core-L14-336 at
     depth 2; GroundingDINO-tiny with 1 encoder and 1 decoder layer at
     800 px; SAM ViT-B with 3 layers (global layer 2) at 1024 px;
     PE-Core-L14 at 504 px (S = 1297, past the heads-in-lanes kernel:
     the ViT's long-sequence path, whose kernel launches it counts);
  5. the direct-embed path at full width: `SimpleReverso` with the
     default PE-Core-L14-336 config (seeded random init, bf16, batch 64)
     builds a database from 256 synthetic images with
     `use_direct_pe=True`, answers `process_image_direct_pe` +
     `search_similar` queries and a 64-query `search_batch`;
  6. the region path at full width: `SimpleReverso` with a seeded
     GroundingDINO-tiny + SAM ViT-B detector (fp32) builds a database from
     32 synthetic 640x480 / 480x640 images with `create_database(...,
     use_direct_pe=False)`, then answers `detect_regions` +
     `extract_embeddings` + `search_similar` queries.

Every kernel must have launched on its path (counts reset just before a
path and read just after it). The line before the last is the card's
name and power limit, the one before that a JSON object with one entry
per kernel; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least time on the card in ms: the larger of the bytes the function
    must move over the memory rate and its operations over the peak rate
    for the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of `fn` in ms, by CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def topk_agree(ref_s, ref_i, s, i, tol: float) -> None:
    """Kernel top-k against the plain version: equal scores within `tol`,
    and equal ids wherever the plain version's ranked scores are more than
    `tol` apart on both sides (the tie-margin rule)."""
    ref_s, ref_i, s, i = (t.cpu().numpy() for t in (ref_s, ref_i, s, i))
    fin = np.isfinite(ref_s)
    check(np.array_equal(fin, np.isfinite(s)), "top-k: -inf slots differ")
    check(np.array_equal(np.where(fin, 0, ref_i), np.where(fin, 0, i)),
          "top-k: empty slots must hold idx -1")
    check(np.abs(np.where(fin, ref_s - s, 0)).max() <= tol,
          f"top-k scores differ by {np.abs(np.where(fin, ref_s - s, 0)).max()}")
    r = np.where(fin, ref_s, -1e9)
    pad = np.full((r.shape[0], 1), np.inf)
    gap_up = np.concatenate([pad, -np.diff(r, axis=1)], axis=1)
    gap_dn = np.concatenate([-np.diff(r, axis=1), pad], axis=1)
    clear = (gap_up > tol) & (gap_dn > tol)
    check(np.array_equal(np.where(clear, i, -2), np.where(clear, ref_i, -2)),
          "top-k ids differ where the score margins are clear")


def kernel_checks(torch, gen) -> dict:
    import torch.nn.functional as F
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (flash_attention_heads,
                                                  flash_attention_heads_ref)
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp, mlp_ref
    from reverso_tpu_torch.ops.rope import rope_2d_tables
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # K3: PE-L14 attention, B=8, S=577, W=1024, 16 heads, RoPE; kv_valid < S;
    # and the CLIP family's cos=None form
    b, s, w, heads = 8, 577, 1024, 16
    cos, sin = rope_2d_tables(24, w // heads, cls_token=True)
    q, k, v = randn(b, s, w), randn(b, s, w), randn(b, s, w)
    tol = 2e-2   # bf16 output (8-bit mantissa) and online vs one-pass softmax
    errs = []
    for kv_valid, c, sn in ((None, cos, sin), (300, cos, sin), (None, None, None)):
        kw = dict(heads=heads, cos=c, sin=sn, kv_valid=kv_valid)
        out = flash_attention_heads(q, k, v, **kw)
        ref = flash_attention_heads_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        check(errs[-1] <= tol, f"flash_heads kv_valid={kv_valid} rope={c is not None}: "
                               f"max abs err {errs[-1]} > {tol}")
    kw = dict(heads=heads, cos=cos, sin=sin)
    hd = w // heads
    split = lambda t: t.reshape(b, s, heads, hd).transpose(1, 2).contiguous()
    qh, kh, vh = split(q), split(k), split(v)
    rows["flash_heads"] = dict(
        source="reverso_tpu_torch/csrc/flash_heads.cu",
        replaces="reverso_tpu/ops/attention.py:337",
        max_abs_err=max(errs), shape="B=8 S=577 W=1024 H=16 bf16 RoPE",
        ms=cuda_ms(lambda: flash_attention_heads(q, k, v, **kw)),
        ms_no_rope=cuda_ms(lambda: flash_attention_heads(q, k, v, heads=heads)),
        plain_ms=cuda_ms(lambda: flash_attention_heads_ref(q, k, v, **kw)),
        library="F.scaled_dot_product_attention on [B, H, S, D] (no RoPE)",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)))
    rows["flash_heads"]["bound_ms"], rows["flash_heads"]["bound_by"] = bound(
        4 * b * s * w * 2 + 2 * s * hd * 4, 4 * b * heads * s * s * hd, "bfloat16")
    del qh, kh, vh
    print(f"flash_heads: max abs err {errs} (tol {tol}); no-RoPE mode "
          f"{rows['flash_heads'].pop('ms_no_rope'):.4f} ms", flush=True)

    # K4: PE-L14 MLP, T=8*577, 1024 -> 4096 -> 1024, gelu and quick_gelu
    t, hid = 8 * 577, 4096
    x = randn(t, w)
    w1, b1 = randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.02)
    w2, b2 = randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.02)
    tol = 2e-2   # bf16 output; h rounds to bf16 in both, sums in another order
    errs = []
    for act in ("gelu", "quick_gelu"):
        out = fused_mlp(x, w1, b1, w2, b2, act=act)
        ref = mlp_ref(x, w1, b1, w2, b2, act=act)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        check(errs[-1] <= tol, f"fused_mlp {act}: max abs err {errs[-1]} > {tol}")
    rows["fused_mlp"] = dict(
        source="reverso_tpu_torch/csrc/fused_mlp.cu",
        replaces="reverso_tpu/ops/fused_mlp.py:63",
        max_abs_err=max(errs), shape="T=4616 1024->4096->1024 bf16 gelu",
        ms=cuda_ms(lambda: fused_mlp(x, w1, b1, w2, b2, act="gelu")),
        plain_ms=cuda_ms(lambda: mlp_ref(x, w1, b1, w2, b2, act="gelu")),
        library="none: no single PyTorch call", library_ms=None)
    rows["fused_mlp"]["bound_ms"], rows["fused_mlp"]["bound_by"] = bound(
        (2 * t * w + 2 * hid * w + hid + w) * 2, 4 * t * w * hid, "bfloat16")
    print(f"fused_mlp: max abs err {errs} (tol {tol})", flush=True)
    del x, w1, b1, w2, b2

    # K1: 1M x 1024 bf16 (n_valid 1,000,000 of 1,048,576 rows), Q=256, k=10
    db = torch.randn(1 << 20, w, generator=gen, device=dev)
    db = (db / db.norm(dim=1, keepdim=True)).to(bf16)
    qs = db[torch.arange(256, device=dev) * 3001].float()
    qs = (qs + 0.05 * torch.randn(qs.shape, generator=gen, device=dev))
    qs = (qs / qs.norm(dim=1, keepdim=True)).to(bf16)
    n_valid = 1_000_000
    tol = 1e-4   # fp32 sums of exact bf16 products, in another order
    out_s, out_i = cosine_topk(db, qs, 10, n_valid=n_valid)
    ref_s, ref_i = cosine_topk_ref(db, qs, 10, n_valid=n_valid)
    topk_agree(ref_s, ref_i, out_s, out_i, tol)
    check(bool((out_i < n_valid).all()), "top-k returned a row past n_valid")
    err = float((out_s - ref_s).abs().max())
    # small ragged case: k > n_valid, duplicate rows tie to the lower index
    small = torch.randn(1000, w, generator=gen, device=dev)
    small = (small / small.norm(dim=1, keepdim=True)).to(bf16)
    small[10] = small[3]
    small[500] = small[3]
    sq = small[[3, 0, 5]].contiguous()
    s2, i2 = cosine_topk(small, sq, 20, n_valid=600)
    r2s, r2i = cosine_topk_ref(small, sq, 20, n_valid=600)
    topk_agree(r2s, r2i, s2, i2, tol)
    check(i2[0, :3].tolist() == [3, 10, 500], f"ties must go to the lower row: {i2[0, :3]}")
    s3, i3 = cosine_topk(small, sq, 20, n_valid=7)
    check(bool((i3[:, 7:] == -1).all()) and bool(torch.isneginf(s3[:, 7:]).all()),
          "k > n_valid: slots past the valid rows must be (-inf, -1)")
    check(bool((i3[:, :7] >= 0).all()), "k > n_valid: valid rows missing")
    rows["topk_stream"] = dict(
        source="reverso_tpu_torch/csrc/topk_stream.cu",
        replaces="reverso_tpu/ops/topk.py:183",
        max_abs_err=err, shape="N=1M(n_valid 1,000,000) d=1024 Q=256 k=10 bf16",
        ms=cuda_ms(lambda: cosine_topk(db, qs, 10, n_valid=n_valid)),
        plain_ms=cuda_ms(lambda: cosine_topk_ref(db, qs, 10, n_valid=n_valid),
                         iters=3),
        library="none: no single PyTorch call (a matmul and a topk)",
        library_ms=None)
    rows["topk_stream"]["bound_ms"], rows["topk_stream"]["bound_by"] = bound(
        (n_valid + 256) * w * 2 + 256 * 10 * 8, 2 * 256 * n_valid * w, "bfloat16")
    print(f"topk_stream: max abs score err {err} (tol {tol})", flush=True)
    check(all(v == 0 for v in kernels.plain_dispatches.values()),
          "a k <= 128 search must not take the plain path")
    del db, small
    return rows


def region_kernel_checks(torch, gen) -> dict:
    """K6, K7, K8 against their plain versions at the region and ViT
    long-sequence paths' shapes and at small ragged shapes."""
    import torch.nn.functional as F
    from reverso_tpu_torch.ops.attention import attention_ref, flash_attention
    from reverso_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_ref

    dev = torch.device("cuda")
    rows = {}

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # K6: SAM ViT-B global layers, B=4 H=12 S=4096 D=64 G=64, fp32; ragged:
    # Sq = 150 (not a multiple of the 128-row tile), kv_valid = 190 < 196
    f32, bf16 = torch.float32, torch.bfloat16
    tol = 2e-5   # fp32: sums in another order, online vs one-pass softmax
    errs = []
    for b, h, g, d, sq, kv_valid in ((4, 12, 64, 64, 4096, None),
                                     (1, 2, 14, 32, 150, 190)):
        q = randn(b, h, sq, d, dtype=f32)
        k, v = randn(b, h, g * g, d, dtype=f32), randn(b, h, g * g, d, dtype=f32)
        bh, bw = randn(b, h, sq, g, dtype=f32, scale=0.5), randn(b, h, sq, g, dtype=f32, scale=0.5)
        kw = dict(kv_valid=kv_valid, rel_bias=(bh, bw, g), scale=d ** -0.5)
        out = flash_attention(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        check(errs[-1] <= tol, f"flash_attn rel-bias {q.shape}: max abs err {errs[-1]} > {tol}")
        if sq == 4096:
            main = (q, k, v, bh, bw, kw)
    q, k, v, bh, bw, kw = main
    b, h, s, d, g = 4, 12, 4096, 64, 64
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=2)
    from reverso_tpu_torch.ops.attention import rel_bias_dense
    mask = rel_bias_dense(bh, bw, g)   # [B, H, S, S] fp32, 3.2 GB
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                     iters=2)
    del mask
    rows["flash_attn_relbias"] = dict(
        source="reverso_tpu_torch/csrc/flash_attn.cu",
        replaces="reverso_tpu/ops/attention.py:131",
        max_abs_err=max(errs), shape="B=4 H=12 S=4096 D=64 G=64 fp32 (SAM global)",
        ms=ms, plain_ms=plain_ms,
        library="F.scaled_dot_product_attention with the bias materialized "
                "as a [B, H, S, S] fp32 attn_mask (not timed)",
        library_ms=lib_ms)
    rows["flash_attn_relbias"]["bound_ms"], rows["flash_attn_relbias"]["bound_by"] = bound(
        4 * b * h * s * d * 4 + 2 * b * h * s * g * 4,
        4 * b * h * s * s * d + 2 * b * h * s * s, "float32")
    print(f"flash_attn rel-bias: max abs err {errs} (tol {tol})", flush=True)
    del q, k, v, bh, bw, main

    # K7: PE-L14 at 504 px, B=8 H=16 S=1297 D=64, bf16 (the tower's
    # dtype); ragged: S_kv != S_q, head_dim 6, kv_valid < S_kv
    tol = 2e-2   # bf16 output (8-bit mantissa); p rounds before vs after normalizing
    errs = []
    for b, h, sq, skv, d, kv_valid in ((8, 16, 1297, 1297, 64, None),
                                       (1, 4, 200, 131, 6, 100)):
        q = randn(b, h, sq, d, dtype=bf16)
        k, v = randn(b, h, skv, d, dtype=bf16), randn(b, h, skv, d, dtype=bf16)
        out = flash_attention(q, k, v, kv_valid=kv_valid)
        ref = attention_ref(q, k, v, kv_valid=kv_valid)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        check(errs[-1] <= tol, f"flash_attn {q.shape}: max abs err {errs[-1]} > {tol}")
        if sq == 1297:
            main = (q, k, v)
    q, k, v = main
    b, h, s, d = 8, 16, 1297, 64
    rows["flash_attn"] = dict(
        source="reverso_tpu_torch/csrc/flash_attn.cu",
        replaces="reverso_tpu/ops/attention.py:48",
        max_abs_err=max(errs), shape="B=8 H=16 S=1297 D=64 bf16 (PE-L14 at 504 px)",
        ms=cuda_ms(lambda: flash_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: attention_ref(q, k, v)),
        library="F.scaled_dot_product_attention",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    rows["flash_attn"]["bound_ms"], rows["flash_attn"]["bound_by"] = bound(
        4 * b * h * s * d * 2, 4 * b * h * s * s * d, "bfloat16")
    print(f"flash_attn: max abs err {errs} (tol {tol})", flush=True)
    del q, k, v, main

    # K8: GroundingDINO-tiny's encoder at 800 px, B=4, Lq=Lv=13,294, H=8,
    # D=32, L=P=4, fp32 (the detector's dtype); its decoder (Lq=900); and a
    # ragged case: widths not multiples of 8, points outside every side
    tol = 1e-5   # fp32: the same sums in another order
    errs = []
    for b, shapes, lq, h, d, p in (
            (4, ((100, 100), (50, 50), (25, 25), (13, 13)), 13294, 8, 32, 4),
            (4, ((100, 100), (50, 50), (25, 25), (13, 13)), 900, 8, 32, 4),
            (2, ((9, 13), (5, 7), (3, 4), (2, 2)), 11, 4, 8, 4)):
        lv = sum(hl * wl for hl, wl in shapes)
        value = randn(b, lv, h, d, dtype=f32)
        loc = torch.rand(b, lq, h, len(shapes), p, 2, generator=gen, device=dev)
        if lq != 13294:
            loc = loc * 1.6 - 0.3
        wt = torch.rand(b, lq, h, len(shapes), p, generator=gen, device=dev)
        wt = wt / wt.sum(dim=(-2, -1), keepdim=True)
        out = ms_deform_attn(value, shapes, loc, wt)
        ref = ms_deform_attn_ref(value, shapes, loc, wt)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        check(errs[-1] <= tol, f"ms_deform Lq={lq}: max abs err {errs[-1]} > {tol}")
        if lq == 13294:
            main = (value, shapes, loc, wt)
    value, shapes, loc, wt = main
    b, lv, h, d, n_l, p = 4, 13294, 8, 32, 4, 4
    rows["ms_deform"] = dict(
        source="reverso_tpu_torch/csrc/ms_deform.cu",
        replaces="reverso_tpu/ops/deformable.py:155",
        max_abs_err=max(errs),
        shape="B=4 Lq=Lv=13294 H=8 D=32 L=4 P=4 fp32 (DINO-tiny encoder, 800 px)",
        ms=cuda_ms(lambda: ms_deform_attn(value, shapes, loc, wt)),
        plain_ms=cuda_ms(lambda: ms_deform_attn_ref(value, shapes, loc, wt), iters=2),
        library="none: no single PyTorch call (grid_sample per level and a sum)",
        library_ms=None)
    # 11 operations per sample and channel: three lerps and one FMA
    rows["ms_deform"]["bound_ms"], rows["ms_deform"]["bound_by"] = bound(
        (2 * b * lv * h * d + b * lv * h * n_l * p * 3) * 4,
        11 * b * lv * h * n_l * p * d, "float32")
    print(f"ms_deform: max abs err {errs} (tol {tol})", flush=True)
    return rows


def tower_check() -> None:
    """Depth-2 PE-Core-L14-336, fp32: kernels on the card vs plain on CPU."""
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], depth=2,
                              dtype="float32")
    imgs = np.random.default_rng(1).standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    gpu = PerceptionEncoder(cfg, seed=3, device="cuda").encode_image(imgs)
    cpu = PerceptionEncoder(cfg, seed=3, device="cpu").encode_image(imgs)
    err = float(np.abs(gpu - cpu).max())
    cos = float((gpu * cpu).sum(1).min())
    print(f"tower depth-2 fp32 card vs cpu: max abs err {err}, min cosine {cos}",
          flush=True)
    check(gpu.shape == (2, cfg.embed_dim) and np.isfinite(gpu).all(),
          "tower output shape/finite")
    check(err <= 1e-4 and cos >= 0.99999, "tower: card and CPU disagree")


def vit_long_check() -> dict:
    """PE-Core-L14 at 504 px, depth 2, fp32: S = 1297 tokens take the ViT's
    long-sequence path (the [B, H, S, D] flash kernel) on the card, the
    plain version on the CPU. Returns the card run's kernel launches."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], depth=2,
                              dtype="float32", image_size=504)
    check(cfg.seq_len == 1297, f"seq_len {cfg.seq_len}")
    imgs = np.random.default_rng(2).standard_normal(
        (2, 504, 504, 3)).astype(np.float32)
    enc = PerceptionEncoder(cfg, seed=4, device="cuda")
    kernels.reset_counts()
    gpu = enc.encode_image(imgs)
    launches = dict(kernels.launches)
    cpu = PerceptionEncoder(cfg, seed=4, device="cpu").encode_image(imgs)
    err = float(np.abs(gpu - cpu).max())
    print(f"vit 504 px (S=1297) depth-2 fp32 card vs cpu: max abs err {err}, "
          f"launches {launches}", flush=True)
    check(gpu.shape == (2, cfg.embed_dim) and np.isfinite(gpu).all(), "vit 504 shape")
    check(err <= 1e-4, "vit 504: card and CPU disagree")
    check(launches["flash_attn"] == cfg.depth, "vit 504 did not take the flash kernel")
    return launches


def write_vocab(path: str) -> None:
    """A synthetic 30,522-line BERT vocab with bert-base-uncased's special
    ids ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, '.' 1012, '?' 1029),
    which GroundingDINO's phrase masks key on, and the prompt words."""
    vocab = [f"[unused{i}]" for i in range(30522)]
    for idx, tok in ((0, "[PAD]"), (100, "[UNK]"), (101, "[CLS]"), (102, "[SEP]"),
                     (1012, "."), (1029, "?"), (2711, "person"), (2482, "car"),
                     (2311, "building")):
        vocab[idx] = tok
    with open(path, "w") as f:
        f.write("\n".join(vocab) + "\n")


def detector_parity(root: str) -> None:
    """Depth-reduced full-width GroundingDINO and SAM, fp32, one seed each:
    the card (kernels) against the CPU (plain versions)."""
    import copy

    import torch
    from reverso_tpu_torch.detect.wordpiece import WordPieceTokenizer
    from reverso_tpu_torch.models.groundingdino import (
        GroundingDino, GroundingDinoConfig, generate_text_masks)
    from reverso_tpu_torch.models.layers import init_weights
    from reverso_tpu_torch.models.sam import Sam, SamConfig, SamVisionCfg

    rng = np.random.default_rng(5)
    # GroundingDINO-tiny, 1 encoder + 1 decoder layer, 800 px
    cfg = GroundingDinoConfig(encoder_layers=1, decoder_layers=1)
    cpu = GroundingDino(cfg)
    init_weights(cpu, torch.Generator().manual_seed(11))
    cpu = cpu.eval().requires_grad_(False)
    gpu = copy.deepcopy(cpu).cuda()
    vocab = os.path.join(root, "vocab.txt")
    write_vocab(vocab)
    ids, _ = WordPieceTokenizer(vocab).token_spans(["person", "car", "building"])
    ids = np.asarray(ids + [0] * (64 - len(ids)))[None]
    attn, pos = generate_text_masks(ids)
    imgs = rng.standard_normal((1, 800, 800, 3)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (imgs, ids, attn, pos, ids != 0)]
    out = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        tokens = {}
        hook = model.encoder_layer0.register_forward_hook(
            lambda m, i, o: tokens.update(vision=o[0]))   # returns None
        with torch.inference_mode():
            logits, boxes = model(*[a.to(name) for a in args])
        hook.remove()
        out[name] = (tokens["vision"].cpu(), model.topk_proposal_idx.cpu(),
                     logits.cpu(), boxes.cpu())
    err = max_err(out["cuda"][0], out["cpu"][0])
    scale = float(out["cpu"][0].abs().max())
    overlap = len(set(out["cuda"][1][0].tolist()) & set(out["cpu"][1][0].tolist())) / 900
    print(f"dino 1+1 layers 800 px fp32 card vs cpu: encoder tokens max abs err "
          f"{err} (max |x| {scale}), top-900 overlap {overlap}", flush=True)
    check(torch.isfinite(out["cuda"][2][torch.isfinite(out["cpu"][2])]).all()
          and torch.isfinite(out["cuda"][3]).all(), "dino outputs not finite")
    # fp32: Swin-T, BERT-base and one fusion/deformable layer, sums in
    # another order on the card
    check(err <= 1e-3, "dino encoder tokens: card and CPU disagree")
    check(overlap >= 0.95, f"dino top-900 overlap {overlap} < 0.95")
    del gpu, cpu

    # SAM ViT-B, 3 layers with the global one at index 2, 1024 px
    scfg = SamConfig(vision=SamVisionCfg(num_layers=3, global_attn_indexes=(2,)))
    cpu = Sam(scfg)
    init_weights(cpu, torch.Generator().manual_seed(12))
    g13 = torch.Generator().manual_seed(13)
    with torch.no_grad():   # flax leaves rel-pos and pos-embed at zero
        for name, prm in cpu.named_parameters():
            if "rel_pos" in name or "pos_embed" in name:
                prm.copy_(torch.randn(prm.shape, generator=g13) * 0.02)
    cpu = cpu.eval().requires_grad_(False)
    gpu = copy.deepcopy(cpu).cuda()
    imgs = torch.from_numpy(rng.standard_normal((1, 1024, 1024, 3)).astype(np.float32))
    boxes = torch.tensor([[[100., 120., 500., 700.], [0., 0., 1023., 1023.],
                           [600., 50., 900., 400.], [300., 300., 330., 340.]]])
    with torch.inference_mode():
        gm, gi = gpu(imgs.cuda(), boxes.cuda())
        cm, ci = cpu(imgs, boxes)
    err_m, err_i = max_err(gm.cpu(), cm), max_err(gi.cpu(), ci)
    print(f"sam 3 layers 1024 px fp32 card vs cpu: mask logits max abs err {err_m} "
          f"(max |x| {float(cm.abs().max())}), iou max abs err {err_i}", flush=True)
    check(err_m <= 1e-3 * max(1.0, float(cm.abs().max())) and err_i <= 1e-3,
          "sam: card and CPU disagree")


def make_images(folder: str, n: int, seed: int) -> None:
    """`n` seeded PNGs of distinct content: smooth color fields plus noise."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:128, 0:128] / 128.0
    for j in range(n):
        f = rng.uniform(0.5, 6.0, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([np.sin(2 * np.pi * (f[c, 0] * xx + f[c, 1] * yy) + ph[c])
                        for c in range(3)], axis=-1)
        img = 127.5 * (1 + img) + rng.normal(0, 20, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(folder, f"img_{j:04d}.png"))


def slice_run(root: str) -> dict:
    """The main path at full width through the reference-compatible facade."""
    from PIL import Image
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.compat import SimpleReverso
    from reverso_tpu_torch.config import StoreConfig, default_config
    from reverso_tpu_torch.store import VectorStore

    folder = os.path.join(root, "images")
    os.makedirs(folder)
    n_img = 256
    make_images(folder, n_img, seed=0)
    cfg = default_config()
    cfg = cfg.replace(store=StoreConfig(root_dir=os.path.join(root, "db")))
    check(cfg.model.name == "PE-Core-L14-336" and cfg.model.dtype == "bfloat16"
          and cfg.ingest.batch_size == 64, "default config changed")
    sr = SimpleReverso(cfg, device="cuda")
    engine = sr._engine
    engine.encoder   # build (seeded init) outside the timed path

    kernels.reset_counts()
    t0 = time.perf_counter()
    transcript = sr.create_database(folder, "smoke", use_direct_pe=True)
    build_s = time.perf_counter() - t0
    check("ready for searching" in transcript, f"build failed:\n{transcript}")
    print(sr.load_database("smoke"), flush=True)
    store = VectorStore.open(cfg.store.root_dir, "smoke")
    vecs = np.asarray(store.vectors())
    names = [p["filename"] for p in store.payloads(list(range(store.count)))]
    check(vecs.shape == (n_img, 1024) and np.isfinite(vecs).all(),
          f"stored vectors {vecs.shape}")
    check(np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3),
          "stored vectors are not unit norm")
    gram = vecs @ vecs.T
    off = gram[~np.eye(n_img, dtype=bool)]
    print(f"stored embeddings: {vecs.shape}, off-diagonal cosine "
          f"max {off.max():.6f} mean {off.mean():.6f}", flush=True)

    tie_tol = 5e-3   # bf16 tower: batch-1 vs batch-64 forwards round differently
    for j in (0, 17, 101, 255):
        fname = f"img_{j:04d}.png"
        emb, metas = sr.process_image_direct_pe(Image.open(os.path.join(folder, fname)))
        text, items = sr.search_similar(0.0, 5)
        check(len(items) == 5, f"search_similar returned {len(items)} items")
        own = [it for it in items if it["filename"] == fname]
        check(bool(own), f"{fname}: own row not in the top 5:\n{text}")
        check(own[0]["score"] >= items[0]["score"] - tie_tol,
              f"{fname}: own row not at rank 0 within {tie_tol}:\n{text}")
        print(f"{fname}: rank-0 {items[0]['filename']} {items[0]['score']:.6f}, "
              f"own {own[0]['score']:.6f}", flush=True)

    qsel = np.arange(0, n_img, n_img // 64)[:64]
    queries = vecs[qsel]
    scores, ids = engine.search_batch(queries, 5)
    check(scores.shape == (64, 5) and ids.shape == (64, 5), "search_batch shape")
    own_score = gram[qsel, qsel]
    check(bool(np.all(scores[:, 0] >= own_score - 1e-2))
          and bool(np.all(own_score >= scores[:, 0] - 1e-2)), "search_batch scores")
    hit = [(qsel[r] in ids[r]) for r in range(64)]
    check(all(hit), "search_batch: a query's own row is missing from its top 5")
    launches = dict(kernels.launches)
    print(f"launches on the direct-embed path: {launches}", flush=True)
    for name in ("flash_heads", "fused_mlp", "topk_stream"):
        check(launches[name] > 0, f"kernel {name} never launched on the direct-embed path")

    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.search_batch(queries, 5)
        lat.append((time.perf_counter() - t0) * 1e3)
    m = engine.metrics
    out = dict(embed_img_s=m.rate("embed"), embed_images=m.counts["embed"],
               build_s=build_s, search_batch64_ms_median=float(np.median(lat)),
               names_ok=len(set(names)) == n_img)
    print(f"slice: {json.dumps(out)}", flush=True)
    return launches


def make_photos(folder: str, n: int, seed: int) -> None:
    """`n` seeded PNGs of mixed orientation (640x480 and 480x640)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for j in range(n):
        h, w = (480, 640) if j % 2 == 0 else (640, 480)
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        f = rng.uniform(0.5, 6.0, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([np.sin(2 * np.pi * (f[c, 0] * xx + f[c, 1] * yy) + ph[c])
                        for c in range(3)], axis=-1)
        img = 127.5 * (1 + img) + rng.normal(0, 20, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(folder, f"photo_{j:03d}.png"))


def sync_ms(torch, fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# kernel-name patterns of the region path's device time, in match order
KERNEL_GROUPS = (("ms_deform (K8)", "ms_deform"), ("flash_attn (K6/K7)", "flash_attn"),
                 ("flash_heads (K3)", "flash_heads"), ("fused_mlp (K4)", "fused_mlp"),
                 ("topk (K1)", "topk"), ("convolution", "conv"),
                 ("matmul", "gemm"), ("matmul", "cutlass"), ("matmul", "Kernel2"))


def profile_detect(torch, det, images, prompts) -> dict:
    """One profiled `detect_batch` of a DINO and a SAM batch: device busy
    share of the host wall and device time by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    det.detect_batch(images, prompts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.detect_batch(images, prompts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.lower()
        group = next((g for g, pat in KERNEL_GROUPS if pat.lower() in name), "other")
        groups[group] = groups.get(group, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):          # union of device intervals
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return dict(wall_ms=wall_ms, device_busy_ms=busy / 1e3,
                busy_share=busy / 1e3 / wall_ms,
                kernel_ms={k: round(v, 3) for k, v in sorted(groups.items())})


def region_run(root: str) -> dict:
    """The region path at full width through the reference-compatible
    facade, with a seeded GroundingDINO-tiny + SAM ViT-B detector."""
    import torch
    from PIL import Image
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.compat import SimpleReverso
    from reverso_tpu_torch.config import DetectorConfig, StoreConfig, default_config
    from reverso_tpu_torch.detect.grounded import GroundedSamDetector
    from reverso_tpu_torch.detect.wordpiece import WordPieceTokenizer
    from reverso_tpu_torch.store import VectorStore

    folder = os.path.join(root, "photos")
    os.makedirs(folder)
    n_img, max_regions = 32, 8
    make_photos(folder, n_img, seed=1)
    vocab = os.path.join(root, "vocab.txt")
    write_vocab(vocab)
    dcfg = DetectorConfig(box_threshold=0.0, text_threshold=0.0, max_regions=max_regions)
    cfg = default_config()
    cfg = cfg.replace(store=StoreConfig(root_dir=os.path.join(root, "region_db")),
                      detector=dcfg)
    check(cfg.ingest.region_embed_mode == "compat", "default region_embed_mode changed")
    t0 = time.perf_counter()
    det = GroundedSamDetector(tokenizer=WordPieceTokenizer(vocab), cfg=dcfg,
                              seed=7, device="cuda")
    check(det.dino_cfg.d_model == 256 and det.dino_cfg.num_queries == 900
          and det.sam_cfg.vision.hidden_size == 768 and det.dino_cfg.dtype == "float32",
          "detector config is not GroundingDINO-tiny + SAM ViT-B fp32")
    sr = SimpleReverso(cfg, detector=det, device="cuda")
    engine = sr._engine
    engine.encoder
    print(f"region path set-up: {time.perf_counter() - t0:.1f} s", flush=True)

    # where the build's time goes: each model call is timed on the host
    # clock up to a device sync (every call's result goes to the host
    # right after it anyway, so the syncs change no overlap)
    spent = {"dino": 0.0, "sam": 0.0, "pe": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return run

    det._dino_fwd = timed("dino", det._dino_fwd)
    det._sam_fwd = timed("sam", det._sam_fwd)
    engine.encoder.encode_image = timed("pe", engine.encoder.encode_image)
    kernels.reset_counts()
    t0 = time.perf_counter()
    transcript = sr.create_database(folder, "regions", text_prompt="person . car . building")
    build_s = time.perf_counter() - t0
    for key in ("_dino_fwd", "_sam_fwd"):
        delattr(det, key)
    del engine.encoder.encode_image
    shares = {k: v / build_s for k, v in spent.items()}
    shares["host"] = 1.0 - sum(shares.values())
    print(f"region build time shares: {json.dumps(shares)} of {build_s:.3f} s "
          f"(seconds: {json.dumps(spent)})", flush=True)
    check("ready for searching" in transcript, f"region build failed:\n{transcript}")
    print(sr.load_database("regions"), flush=True)
    store = VectorStore.open(cfg.store.root_dir, "regions")
    vecs = np.asarray(store.vectors())
    pays = store.payloads(list(range(store.count)))
    print(f"region build: {vecs.shape[0]} rows from {n_img} images in {build_s:.1f} s",
          flush=True)
    check(vecs.shape == (n_img * max_regions, cfg.model.embed_dim) and np.isfinite(vecs).all(),
          f"stored region vectors {vecs.shape}")
    check(np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3),
          "stored region vectors are not unit norm")
    for pay in pays:
        w, h = (640, 480) if int(pay["filename"][6:9]) % 2 == 0 else (480, 640)
        x0, y0, x1, y1 = pay["bbox"]
        check(0 <= x0 <= x1 < w and 0 <= y0 <= y1 < h, f"bbox outside the image: {pay}")
        check(pay["mask_status"] == "processed", f"mask status: {pay}")

    tie_tol = 5e-3   # bf16 tower: batch-1 vs batch-64 forwards round differently
    for j in (0, 5, 18, 31):
        fname = f"photo_{j:03d}.png"
        img = Image.open(os.path.join(folder, fname))
        n = sr.detect_regions(img, "person . car . building")
        regions = sr.detected_regions
        check(n == max_regions and regions.masks.shape == (n, img.height, img.width),
              f"{fname}: {n} regions, masks {regions.masks.shape}")
        embs, metas = sr.extract_embeddings(img)
        check(len(embs) == n and len(metas) == n, f"{fname}: {len(embs)} embeddings")
        text, items = sr.search_similar(0.0, max_regions)
        own = [it for it in items if it["filename"] == fname]
        check(bool(own), f"{fname}: own rows not in the top {max_regions}:\n{text}")
        check(own[0]["score"] >= items[0]["score"] - tie_tol,
              f"{fname}: own rows not at rank 0 within {tie_tol}:\n{text}")
        print(f"{fname}: {n} regions, rank-0 {items[0]['filename']} "
              f"{items[0]['score']:.6f}, own {own[0]['score']:.6f}", flush=True)
    launches = dict(kernels.launches)
    print(f"launches on the region path: {launches}", flush=True)
    for name in ("ms_deform", "flash_attn_relbias", "flash_heads", "fused_mlp",
                 "topk_stream"):
        check(launches[name] > 0, f"kernel {name} never launched on the region path")

    # batch-4 forwards of the two detector models, host clock around syncs
    imgs = [np.asarray(Image.open(os.path.join(folder, f"photo_{j:03d}.png")))
            for j in range(4)]
    ids, attn, pos, token_mask, _ = det._prep_text(["person", "car", "building"])
    text = tuple(torch.from_numpy(np.repeat(a, 4, axis=0)).cuda()
                 for a in (ids, attn, pos, token_mask))
    dino_in = torch.stack([det._prep_dino_image(im) for im in imgs])
    dino_ms = sync_ms(torch, lambda: det._dino_fwd(dino_in, text))
    preps = [det._prep_sam_image(im) for im in imgs]
    sam_in = torch.stack([p[0] for p in preps])
    boxes = torch.tensor([[[50., 60., 400., 500.]] * max_regions] * 4, device="cuda")
    nh = torch.tensor([p[1][0] for p in preps], device="cuda")
    nw = torch.tensor([p[1][1] for p in preps], device="cuda")
    sam_ms = sync_ms(torch, lambda: det._sam_fwd(sam_in, boxes, nh, nw))
    prof = profile_detect(torch, det, imgs, ["person", "car", "building"])
    print(f"profiled detect_batch of 4 images: {json.dumps(prof)}", flush=True)
    m = engine.metrics
    out = dict(build_s=build_s, detect_img_s=m.rate("detect"), embed_img_s=m.rate("embed"),
               detect_s=m.seconds.get("detect", 0.0), embed_s=m.seconds.get("embed", 0.0),
               append_s=m.seconds.get("append", 0.0),
               dino_batch4_ms=dino_ms, sam_batch4_8boxes_ms=sam_ms, rows=int(vecs.shape[0]))
    print(f"region slice: {json.dumps(out)}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from reverso_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds:.1f} s)",
          flush=True)

    t_all = time.perf_counter()
    phases = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase("kernels (PR 1)", kernel_checks, torch, gen)
    rows.update(phase("kernels (region, long ViT)", region_kernel_checks, torch, gen))
    torch.cuda.empty_cache()
    phase("tower parity", tower_check)
    long_launches = phase("vit 504 parity", vit_long_check)
    with tempfile.TemporaryDirectory() as root:
        phase("detector parity", detector_parity, root)
        torch.cuda.empty_cache()
        direct_launches = phase("direct-embed slice", slice_run, root)
        region_launches = phase("region slice", region_run, root)

    # each kernel's launches on its own path
    path_of = {"flash_heads": direct_launches, "fused_mlp": direct_launches,
               "topk_stream": direct_launches, "flash_attn": long_launches,
               "flash_attn_relbias": region_launches, "ms_deform": region_launches}
    print(f"phases: {json.dumps(phases)}; total {time.perf_counter() - t_all:.1f} s "
          f"after the build", flush=True)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape", "library")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=path_of[name][name], **{k: r[k] for k in keys})
        for name, r in rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
