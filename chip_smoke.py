#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`reverso_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them. Phases, none
of which catches a failure:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `reverso_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, in the working dtype (max abs error
     against a stated tolerance, CUDA-event times of both);
  4. a depth-2 PE-Core-L14-336 tower on the card (kernels) against the
     same weights on the CPU (plain versions), fp32;
  5. the main path at full width: `SimpleReverso` with the default
     PE-Core-L14-336 config (seeded random init, bf16, batch 64) builds a
     database from 256 synthetic images with `use_direct_pe=True`, loads
     it, answers `process_image_direct_pe` + `search_similar` queries and
     a 64-query `search_batch`. Every kernel must have launched there.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
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


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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
    rows["flash_heads"] = dict(
        source="reverso_tpu_torch/csrc/flash_heads.cu",
        replaces="reverso_tpu/ops/attention.py:337",
        max_abs_err=max(errs), shape="B=8 S=577 W=1024 H=16 bf16",
        ms=cuda_ms(lambda: flash_attention_heads(q, k, v, **kw)),
        plain_ms=cuda_ms(lambda: flash_attention_heads_ref(q, k, v, **kw)))
    print(f"flash_heads: max abs err {errs} (tol {tol})", flush=True)

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
        ms=cuda_ms(lambda: fused_mlp(x, w1, b1, w2, b2, act="gelu"), iters=5),
        plain_ms=cuda_ms(lambda: mlp_ref(x, w1, b1, w2, b2, act="gelu"), iters=5))
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
        ms=cuda_ms(lambda: cosine_topk(db, qs, 10, n_valid=n_valid), iters=5),
        plain_ms=cuda_ms(lambda: cosine_topk_ref(db, qs, 10, n_valid=n_valid),
                         iters=3, warmup=1))
    print(f"topk_stream: max abs score err {err} (tol {tol})", flush=True)
    check(all(v == 0 for v in kernels.plain_dispatches.values()),
          "a k <= 128 search must not take the plain path")
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
    sr = SimpleReverso(cfg)
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
    print(f"launches on the main path: {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_checks(torch, gen)
    tower_check()
    with tempfile.TemporaryDirectory() as root:
        launches = slice_run(root)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=launches[name], max_abs_err=r["max_abs_err"],
             shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"])
        for name, r in rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
