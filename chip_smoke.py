#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`reverso_tpu_torch`) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --copy-soak [ITERS]   # only `copy_soak` (default 100)
    python3 chip_smoke.py --probes   # only the hardware probes' full sweeps (P1-P5)
    python3 chip_smoke.py --backward-kernel-times   # phase T's child process

Needs one CUDA card and `nvcc`; exits non-zero without them. Phases, none
of which catches a failure:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `reverso_tpu_torch/csrc` (one nvcc per
     source, all at once);
  2H. the hardware probes (H, `probes_run`; `reverso_tpu_torch/probes/`,
     the ports of the TPU probes under `scripts/`), each once at its
     script's shape, counted, held against its plain version and timed:
     P1 the TMA ring's read rate over 1M x 1024 bf16 (every ring of the
     sweep that fits; `torch.amax` beside it), P2 the tensor cores' rate in
     bf16, int8 and the fp32 split mode with the SM clock under the load
     (`torch.matmul` at 8192^3 beside it; each element within its rounding
     gate, which one dropped step would fail), P3 K1's pipeline without its
     select at Q = 256 in three variants beside K1 (checked on the script's
     queries and on queries drawn apart from the rows), P4 loads at aligned
     and unaligned data offsets (one CTA and the grid) and the grid at blocks
     that do not overlap, P5 the per-lane gather at four table sizes and K8
     at the script's shapes; a line `measured peaks: {...}` (the card, its
     power limit, the SM clock, the highest read rate of P1 and P4, P4's
     rate of loads from L2, P2's highest rates), which every row's
     `measured_bound_ms` divides by, and no row's `ms` may fall under;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it and at small ragged shapes, in the
     working dtype: max abs error against a stated tolerance, CUDA-event
     times of the kernel, its plain version and (where one PyTorch call
     computes the same function) that call, and the least time the card
     could take (`bound_ms`); the MLP (K4) on its two wgmma GEMMs at
     T = 4616, 1000 and 36,928 with the cuBLAS route of three calls
     beside it, and in fp32 on the same GEMMs in the split mode (three
     bf16 parts a value, six products) at the depth-2 tower's T = 1154
     and the B = 8 tower's T = 4616, against `mlp_ref` and
     `mlp_split_ref`, with the fp32 cuBLAS route, and the split pass that
     makes the parts; the attention kernels in bf16 on the tensor cores
     (K3 with RoPE, its whole PyTorch route and its lanes' copy route
     beside it, K7), SAM's
     rel-pos bias attention (K6) on the tensor cores in fp32 and bf16
     against its bf16-operand and fp32 plain versions, with SDPA and a
     materialized mask in both dtypes beside it, K7 and K6 with fp32
     operands on the core's split mode (three bf16 parts a value, six
     products) against `attention_split_ref` and the fp32 `attention_ref`
     at the 2e-5 gate, and K3 in fp32 on the split mode with RoPE
     (B = 2, and B = 8 timed) against `flash_attention_heads_ref` and
     `flash_attention_heads_split_ref`; K1 on fp32 rows (the wgmma
     scan's split mode) over 1M x 1024 at Q = 64 and 256 beside a matmul
     and a topk, and a small ragged fp32 case (ties, k > n_valid); the
     attention kernels at edge shapes (S 1 to 129, kv_valid 0 to S - 1,
     head dims 6 to 128, S_kv != S_q, B * H 1 and 1024, bases one element
     into their buffers; bf16 on the tensor cores, fp32 on the split
     mode); the capacity
     kernels at 1,000,000 x 1024
     (masked bf16, int8 with ids and scores equal bit for bit, packed
     binary) and the IVF probed scan at 1024 clusters, nprobe 16 (bf16,
     int8, fp32; its plan's table checked; every cluster at Q = 64 beside
     K1 over the same rows); the
     int8 MLP (K5: T = 4616, 1000, 36,928 and 577, 1024 -> 4096 -> 1024,
     gelu and quick_gelu, and a ragged case) and the two-stage int8 search's
     candidate scan (1M x 1024 int8 rows with row scales, Q = 256,
     k_fetch 40, ids and scores equal bit for bit, ragged cases);
  4. depth-reduced full-width towers on the card (kernels) against the
     same weights on the CPU (plain versions), fp32: PE-Core-L14-336 at
     depth 2 (its embeddings and, through `encode_regions`, its ROI
     region embeddings); GroundingDINO-tiny with 1 encoder and 1 decoder
     layer at 800 px; SAM ViT-B with 3 layers (global layer 2) at
     1024 px, its rel-pos bias attention once on the split mode (fp32
     operands, the 1e-3 gate) and once on the default route (the tensor-core
     core, bf16 operands, a 2e-2 gate); PE-Core-L14 at 504 px (S = 1297,
     past the heads-in-lanes kernel: the ViT's long-sequence path, K7 on
     the split mode); then PE-Core-L14 at 504 px in
     bf16 at full depth, B = 8, against the same weights in fp32 on the
     card (every block's attention on the tensor-core K7; the fp32
     forward's K4 counted by shape); then PE-Core-L14-336 in fp32 at full
     width and depth, B = 8 (K3 and K4 fp32 on the split routes, 24
     launches each), one profiled forward (device busy share, time by
     kernel group) and the min cosine against the bf16 tower of the same
     seed and weights; K3 and K4 fp32 timed at each shape these paths ran
     them at;
  4b. the two-stage int8 search at op level (`cosine_topk_int8` over the
     1M x 1024 rows, Q = 256, k = 10, overfetch 4): the plain pipeline's
     ids, recall@10 against exact fp32, and K12's launches by shape;
  5. the direct-embed path at full width: `SimpleReverso` with the
     default PE-Core-L14-336 config (seeded random init, bf16, batch 64)
     builds a database from 256 synthetic images with
     `use_direct_pe=True`, answers `process_image_direct_pe` +
     `search_similar` queries and a 64-query `search_batch`, and profiles
     one B = 64 forward of the tower (device time by kernel);
  6. the region path at full width: `SimpleReverso` with a seeded
     GroundingDINO-tiny + SAM ViT-B detector (fp32) builds a database from
     32 synthetic 640x480 / 480x640 images with `create_database(...,
     use_direct_pe=False)`, then answers `detect_regions` +
     `extract_embeddings` + `search_similar` queries, and holds 8 photos'
     detections on the default route against SAM's split-mode route
     (boxes equal, the share of mask pixels that agree); K8's inputs at
     each shape the path ran it at are captured (the model's own sampling
     locations), and K8 is held against its plain version and timed on
     them;
  5c. the parity direct-embed slice: `SimpleReverso` with PE-Core-L14-336
     at full width and depth in fp32 (`ModelConfig.dtype="float32"`, batch
     8) into a float32 store builds from the first 64 of phase 5's images,
     then answers `search_similar` and a 64-query `search_batch` (K3 and K4
     fp32 on the split routes, K1 on fp32 rows), held against the plain
     scan of the same matrix and the bf16 build's rows;
  5b. the int8 embedding tower: the direct-embed build of phase 5 again
     with `ModelConfig.quant="int8"` (same images, seed and weights),
     held against the bf16 build (min cosine, top-10 overlap), one
     profiled B = 64 forward of the int8 tower, and K5 timed at each shape
     the path ran it at (`kernels.shape_launches`);
  6b. ROI pooling: the region build of phase 6 again with
     `region_embed_mode="region"` (masks pooled onto the patch grid,
     masked attention pooling), then `detect_regions` +
     `extract_embeddings` + `search_similar`;
  7. the capacity indexes and filtered search through `Reverso` on a
     1,000,000 x 1024 store of clustered rows with payloads: first (g) the
     float32 store (4.1 GB of fp32 rows on the card; `search_batch` at
     Q = 64 with no filter and with `{"folder": 3}`, `search_similar` at
     Q = 1: K1 and K2 on fp32 rows, counted on their own), then payload
     filters and `count` (bf16), vectors deleted with
     `VectorStore.delete_vector_rows`, int8, binary + rescore, IVF at the
     defaults (built, cached, reloaded) and IVF int8 with spill and
     balance, each held against the exact plain search of its subset;
     recall@10 against exact fp32 for the approximate ones; K11 held
     against its plain version and timed at each (shape, mode) the IVF
     engines ran it at, on the inputs captured there;
  5d. the vision-checkpoint loaders (L): a seeded PE-Core-L14-336 written
     in the `openai_clip` scheme with `torch.save` and loaded through
     `PerceptionEncoder.from_torch` embeds phase 5's 256 images bit for bit
     as the same weights loaded directly (B = 64, bf16); a seeded
     CLIP-L14-336 in the `hf_clip` scheme (family "clip": K3 without RoPE,
     K4 with quick_gelu at full width) against the fp32 tower of the same
     weights (min cosine), then a store built from it through
     `create_database(use_direct_pe=True)` and searched (K1); K3 and K4
     in bf16 at each shape the direct-embed and CLIP paths ran them at,
     held against their plain versions there and timed;
  7b. the ops the JAX package left to XLA, over the capacity rows: (E)
     euclid on K1/K2 through the `[x, ||x||^2]` rows at d = 1025 (norms in
     [0.5, 2]; bf16 and fp32; Q = 64 and 1, plain and 10% kept), held
     against the kernel's keys and those against the plain scan, and K1 at
     d = 1025 timed against the matrix zero-padded to 1032 / 1028; (M)
     manhattan at Q = 16 against `manhattan_topk_host` on a 65,536-row
     subset, `torch.cdist` chunks timed against the broadcast; (P) PQ at
     m = 128: train, encode and search timed, the card's search against
     the CPU's on a subset, recall@10 after the rescore beside binary's;
     (C) best_score, discover and context in bf16 and int8 against their
     numpy twins on a subset, timed at 1M, and `matrix_topk` at S = 4096;
     (X) MaxSim over 100,000 points of 1-8 sub-vectors, Q = 16 of Tq = 4,
     against `maxsim_score_rows` and the exact host ranking; (S) 100,000-row
     euclid, manhattan, pq and multivector stores built through
     `VectorStore.append` and searched through `Reverso.search_batch`, also
     filtered, against the same indexes on the CPU;
  7S. meshes (phase S, `sharded_run`): the capacity rows row-sharded over
     a mesh of four shards on the one card (`make_mesh(devices=["cuda:0"]
     * 4)`): the exact bf16 (K1 at Q = 256 and 1, K2), int8 (K9) and
     binary (K10) indexes and the IVF in bf16 and int8 (K11, 1,024
     clusters, nprobe 16) built with `mesh=` beside the same index on one
     device, each kernel launched once per shard and search, each sharded
     result equal to the single-device scan bit for bit, both timed; the
     plain ops sharded (best_score, discover, context, manhattan, PQ,
     MaxSim) by the tie-margin rule; the mesh engine's hybrid query
     against the single engine's; its numbers on a line `sharded (S)
     numbers: {...}`;
  7B. the device builds (B, `device_builds_run`) from a corpus made window
     by window on the card (scripts/bench_capacity.py's generator shape):
     `IVFIndex.from_chunks` at 8,388,608 x 1024 int8, 2,048 clusters, and
     `BinaryIndex.from_chunks` at 16,777,216 x 1024: build seconds, peak
     device memory, search ms at Q = 1 and 256, recall@10 against the
     exact scan regenerated window by window, and the IVF at nprobe =
     clusters against the exact int8 scan; on a line `device builds (B)
     numbers: {...}`;
  7c. the query and write surface (U) through `Reverso` on phase 7's
     1,000,000 x 1024 store: `query_batch` on the int8, binary + rescore
     and IVF engines (K9, K10, K11; K11 held against its plain version and
     timed at each (shape, mode) on its captured inputs, as on phase 7's
     path); with phase 7's deleted rows written back,
     `query_batch` of 64 requests sharing {"folder": 3} and 64 plain ones
     (exactly one K2 and one K1 launch; each request against its own
     `query()` and the plain scan of its subset), 16 hybrid requests (two
     dense branches under different filters, RRF; one scan a group), the
     other query forms (recommend in three strategies, discover, context,
     MMR, a formula rescore, order_by, a seeded sample, scroll, retrieve,
     facet, search_matrix, search_groups) timed at 1M and held against
     numpy twins on a 65,536-row store of the same rows, `search_groups` by
     filename on phase 6's region store, the mutations (upsert of 1,000
     rows, update and delete of 100 vectors, delete_points of a folder,
     set_payload on 1,000 rows, one mixed update_batch), each timed with
     the time to its first search, and the batcher (`warmup()`, then 64
     threads of 8 queries: host p50 / p99, the launched batch sizes);
  7d. the entry points (EP), as a user starts them: `reverso_tpu_torch.cli`
     in this process (its default device, the card) builds a store of 128
     synthetic PNGs with `--direct-pe` at PE-Core-L14-336 and searches it
     plain and under a payload filter (K3, K4, K1, K2), the same search in a
     subprocess with `jax` blocked; the CLIP text tower at
     `ClipTextConfig()`'s full width in fp32 (seeded, written and loaded
     through `REVERSO_CLIP_TEXT_CKPT` on a vocab of the published size)
     against itself on the CPU and through `search-text`; the web UI over
     HTTP against the engine's own calls; the video scorer against a numpy
     loop, and, where OpenCV imports, `video local` and a `build` of its
     frames (the engine's direct calls that check the UI do not count);
  7T. training (T): the backward kernels of K3 and K4 at the training
     path's shapes, each on its route (all on wgmma + TMA: bf16, K3's odd
     head dims on zero-padded copies, fp32 on the split mode), held
     against the autograd of the plain forward (fp32 also against the
     split plain versions) and timed beside their library calls, with
     their device time by kernel and ptxas's registers and spills;
     `ClipTrainer` at PE-Core-L14-336, 5 AdamW steps on two seeded views
     of B = 16 (the loss finite and falling, K3, K4 and their backward
     kernels 48 times a step, the backward on its wgmma route); a
     checkpoint restored bit for bit; one step profiled; the fp32 tower
     (`dtype="float32"`), 3 steps on B = 4 a view, every backward on the
     split routes, its first step held against the plain tower's;
     `reverso-torch train` for 2 steps and `--resume` (`train_run`); its
     numbers on a line `training (T) numbers: {...}`;
  7TM. training on a mesh (TM, `mesh_train_run`): `ClipTrainer(cfg, mesh)`
     at PE-Core-L14-336 on a 2 x 2 data x model mesh of the one card,
     seeded as phase T: 5 bf16 AdamW steps on the same views (K3, K4 and
     their backward kernels 192 times a step on every model shard's 8
     heads and 2048 hidden units; the loss falling), its first step's
     gradient within 1.5x the one-device bf16 step's distance from the
     plain fp32 tower's, a checkpoint resumed bit for bit, the fp32 tower
     on the mesh against one device within 1e-4, and `reverso-torch
     --device cuda:0 train --tp 2`; its numbers on a line `training on a
     mesh (TM) numbers: {...}`;
  7e. K3 and K4 in bf16 and fp32 at each shape the direct-embed, CLIP
     loader, entry-point and training paths ran them at, each held against
     its plain version; their backward rows at each shape phases T and TM
     ran them at, in a process of their own (`backward_kernel_times`);
  8. the top-k scans (K1 from the direct-embed and CLIP paths, K1 and K2
     on fp32 rows from the parity slice and the float32 store, K1 and K2 at
     the euclid phases' padded rows in bf16 and fp32, K2, K9 and K10 from
     the capacity path, K12 from the two-stage search, K1, K2, K9 and K10
     from the surface path, K1 and K2 from the entry points) timed at
     each shape their path ran them at
     (`kernels.shape_launches`), on seeded rows of that shape, each held
     against its plain version (K9 and K12 bit for bit).

Every kernel must have launched on its path (counts reset just before a
path and read just after it). A "redesign order" line ranks the kernels
by launches x (ms - bound_ms), summed over the shapes a path ran K1, K2
(bf16 and fp32 rows), K3 and K4 (bf16 and fp32, forward and backward),
K5, K8, K9, K10, K11 and K12 at. The line before the last is the card's name and power limit, the
one before that a JSON object with one entry per kernel (each with
`bound_ms` at the published peaks and `measured_bound_ms` at phase H's
measured rates, never above `ms`; the probes P1-P5 among them), the one before
that phase U's numbers (after phase S's and B's); the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the CUDA-event timer, kept under the name that scripts/ import it by
from reverso_tpu_torch.probes import timed_ms as cuda_ms

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W); fp32
# products at fp32 accuracy: six bf16 tensor-core passes of three-way
# split operands (the TPU's Precision.HIGHEST), 989 / 6 TFLOP/s, which the
# split mode reaches past the CUDA cores' 67 ("float32": work that is not
# products, as K8's lerps)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12, "float32_split": 989e12 / 6,
              "int8": 1979e12}


class BoundMs(float):
    """A bound in ms that keeps the bytes, operations and operation type it
    was computed from, so that the same work can be bounded again at the
    rates phase H measured (`measured_bound_ms`)."""

    def __new__(cls, ms: float, nbytes: float, ops: float, dtype: str):
        self = super().__new__(cls, ms)
        self.nbytes, self.ops, self.dtype = nbytes, ops, dtype
        return self


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least time on the card in ms: the larger of the bytes the function
    must move over the memory rate and its operations over the peak rate
    for the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return BoundMs(max(t_bytes, t_ops), nbytes, ops, dtype), by


def k5_bound(t: int, w: int, hid: int) -> tuple[float, str]:
    """K5's least time at [T, W] -> H -> W: x read and y written in bf16,
    both int8 weights and the f32 scales and biases read once; 4 T W H int8
    operations."""
    return bound(2 * t * w * 2 + 2 * w * hid + (hid + w) * 8, 4 * t * w * hid, "int8")


def k8_bound(b: int, lv: int, lq: int, h: int, d: int, n_l: int, p: int,
             itemsize: int = 4) -> tuple[float, str]:
    """K8's least time: the value map and the output once in the value
    dtype, the fp32 locations and weights once; 11 operations per sample
    and channel (three lerps and one FMA) at the fp32 rate."""
    return bound((b * lv + b * lq) * h * d * itemsize + b * lq * h * n_l * p * 3 * 4,
                 11 * b * lq * h * n_l * p * d, "float32")


def heads_bound(b: int, s: int, w: int, heads: int, itemsize: int,
                dtype: str) -> tuple[float, str]:
    """K3's least time on [B, S, W]: q, k, v read and o written once, the
    two fp32 RoPE tables read once; 4 B H S^2 hd operations."""
    hd = w // heads
    return bound(4 * b * s * w * itemsize + 2 * s * hd * 4, 4 * b * heads * s * s * hd, dtype)


def mlp_bound(t: int, w: int, hid: int, itemsize: int, dtype: str) -> tuple[float, str]:
    """K4's least time at [T, W] -> H -> W: x read and y written, both
    weights and both biases read once; 4 T W H operations."""
    return bound((2 * t * w + 2 * hid * w + hid + w) * itemsize, 4 * t * w * hid, dtype)


def offset_copy(torch, t):
    """A copy of t one element into a fresh buffer: contiguous, its base not
    16-byte aligned (the wrappers' views TMA cannot take)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    check(view.data_ptr() % 16 != 0, "offset_copy: aligned")
    return view.copy_(t)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def topk_agree(ref_s, ref_i, s, i, tol: float, what: str = "top-k", seed=None) -> None:
    """Kernel top-k against the plain version: equal scores within `tol`,
    and equal ids wherever the plain version's ranked scores are more than
    `tol` apart on both sides (the tie-margin rule). A failure's message
    names the search (`what`), the generator seed its data came from
    (`seed`, where the caller seeded it) and the first (query, slot) that
    disagrees."""
    ref_s, ref_i, s, i = (t.cpu().numpy() for t in (ref_s, ref_i, s, i))
    where = what if seed is None else f"{what} (seed {seed})"

    def agree(bad, why: str) -> None:
        if bad.any():
            q, slot = (int(v) for v in np.argwhere(bad)[0])
            raise AssertionError(f"{where}: {why}; first at query {q}, slot {slot} "
                                 f"(plain {ref_s[q, slot]} id {ref_i[q, slot]}, "
                                 f"kernel {s[q, slot]} id {i[q, slot]})")

    fin = np.isfinite(ref_s)
    agree(fin != np.isfinite(s), "-inf slots differ")
    agree(~fin & (ref_i != i), "empty slots must hold idx -1")
    diff = np.abs(np.where(fin, ref_s, 0) - np.where(fin, s, 0))
    agree(diff > tol, f"scores differ by up to {diff.max()} > {tol}")
    r = np.where(fin, ref_s, -1e9)
    pad = np.full((r.shape[0], 1), np.inf)
    gap_up = np.concatenate([pad, -np.diff(r, axis=1)], axis=1)
    gap_dn = np.concatenate([-np.diff(r, axis=1), pad], axis=1)
    clear = (gap_up > tol) & (gap_dn > tol)
    agree(clear & (i != ref_i), "ids differ where the score margins are clear")


@contextlib.contextmanager
def split_relbias():
    """SAM's rel-pos bias attention on the split mode (fp32 operands)
    instead of the bf16 core, for a comparison with the default route:
    `ops/attention.py::attention_route` patched inside this script only."""
    import importlib
    from unittest import mock

    import torch
    attn = importlib.import_module("reverso_tpu_torch.ops.attention")
    route = attn.attention_route

    def forced(device_type, dtype, head_dim, rel_bias=False):
        if rel_bias and device_type != "cpu" and dtype == torch.float32:
            return "split"
        return route(device_type, dtype, head_dim, rel_bias)

    with mock.patch.object(attn, "attention_route", forced):
        yield


@contextlib.contextmanager
def captured_deform(store: dict):
    """GroundingDINO's `ms_deform_attn` wrapped inside this script only:
    the first call at each shape keeps a copy of its inputs (the model's
    own sampling locations and weights) in `store`, under the key the
    wrapper counts launches by (`kernels.shape_launches`)."""
    import importlib
    from unittest import mock
    gd = importlib.import_module("reverso_tpu_torch.models.groundingdino")
    orig = gd.ms_deform_attn

    def capture(value, shapes, loc, weights):
        shp = [(int(hl), int(wl)) for hl, wl in shapes]
        key = (value.shape[0], loc.shape[1], tuple(shp), value.shape[2], value.shape[3],
               loc.shape[4], str(value.dtype))
        if key not in store:
            store[key] = (value.clone(), shp, loc.clone(), weights.clone())
        return orig(value, shapes, loc, weights)

    with mock.patch.object(gd, "ms_deform_attn", capture):
        yield


def kernel_checks(torch, gen) -> dict:
    import torch.nn.functional as F
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (flash_attention_heads,
                                                  flash_attention_heads_ref,
                                                  flash_attention_heads_split_ref)
    from reverso_tpu_torch.ops.fused_mlp import (fused_mlp, mlp_ref, mlp_split_ref,
                                                 split_mlp_weights)
    from reverso_tpu_torch.ops.rope import apply_rope_2d, rope_2d_tables
    from reverso_tpu_torch.ops.split import split_parts, split_parts_ref
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # K3: PE-L14 attention, B=8, S=577, W=1024, 16 heads, RoPE; kv_valid < S;
    # and the CLIP family's cos=None form. bf16 takes the tensor-core kernel
    # (csrc/flash_tc.cuh); the RoPE tables are on the card, as the tower
    # passes them (vit.py caches them per device)
    b, s, w, heads = 8, 577, 1024, 16
    hd = w // heads
    cos_np, sin_np = rope_2d_tables(24, hd, cls_token=True)
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    q, k, v = randn(b, s, w), randn(b, s, w), randn(b, s, w)
    tol = 2e-2   # bf16 output (8-bit mantissa) and online vs one-pass softmax
    errs = []
    for kv_valid, c, sn in ((None, cos, sin), (300, cos, sin), (None, None, None)):
        kw = dict(heads=heads, cos=c, sin=sn, kv_valid=kv_valid)
        t0 = kernels.launches["flash_heads_tc"]
        out = flash_attention_heads(q, k, v, **kw)
        check(kernels.launches["flash_heads_tc"] == t0 + 1, "flash_heads: not the tensor-core kernel")
        ref = flash_attention_heads_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        check(errs[-1] <= tol, f"flash_heads kv_valid={kv_valid} rope={c is not None}: "
                               f"max abs err {errs[-1]} > {tol}")
    kw = dict(heads=heads, cos=cos, sin=sin)
    split = lambda t: t.reshape(b, s, heads, hd).transpose(1, 2).contiguous()
    merge = lambda t: t.transpose(1, 2).reshape(b, s, w)
    qh, kh, vh = split(q), split(k), split(v)
    t0 = kernels.launches["flash_heads_tc"]
    ms = cuda_ms(lambda: flash_attention_heads(q, k, v, **kw))
    check(kernels.launches["flash_heads_tc"] == t0 + 6, "flash_heads timing: not the tensor-core kernel")
    rows["flash_heads"] = dict(
        source="reverso_tpu_torch/csrc/flash_tc.cuh",
        replaces="reverso_tpu/ops/attention.py:337",
        max_abs_err=max(errs), shape="B=8 S=577 W=1024 H=16 bf16 RoPE",
        ms=ms, plain_ms=cuda_ms(lambda: flash_attention_heads_ref(q, k, v, **kw)),
        library="F.scaled_dot_product_attention on [B, H, S, D] (no RoPE)",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)))
    rows["flash_heads"]["bound_ms"], rows["flash_heads"]["bound_by"] = heads_bound(
        b, s, w, heads, 2, "bfloat16")
    # beside it: the no-RoPE mode, the whole PyTorch route (split, RoPE,
    # SDPA, merge), the lanes' copy route on the same values one element
    # into their buffers (TMA cannot take the bases; bit for bit the TMA
    # route's output), and the RoPE tables passed as numpy arrays (copied
    # to the card on every call, as the first version of this row timed it)
    no_rope_ms = cuda_ms(lambda: flash_attention_heads(q, k, v, heads=heads))
    route_ms = cuda_ms(lambda: merge(F.scaled_dot_product_attention(
        apply_rope_2d(split(q), cos, sin), apply_rope_2d(split(k), cos, sin), split(v))))
    qu, ku, vu = (offset_copy(torch, t) for t in (q, k, v))
    t0 = kernels.launches["flash_heads_tc"]
    check(torch.equal(flash_attention_heads(qu, ku, vu, **kw), flash_attention_heads(q, k, v, **kw))
          and kernels.launches["flash_heads_tc"] == t0 + 2,
          "flash_heads: the copy route differs from the TMA route")
    copy_ms = cuda_ms(lambda: flash_attention_heads(qu, ku, vu, **kw))
    numpy_tables_ms = cuda_ms(lambda: flash_attention_heads(q, k, v, heads=heads, cos=cos_np,
                                                            sin=sin_np))
    rows["flash_heads"]["copy_route_ms"] = copy_ms
    del qh, kh, vh, qu, ku, vu
    print(f"flash_heads: max abs err {errs} (tol {tol}); no-RoPE mode {no_rope_ms:.4f} ms; "
          f"PyTorch route (split, apply_rope_2d, SDPA, merge) {route_ms:.4f} ms; the lanes' "
          f"copy route (unaligned bases) {copy_ms:.4f} ms; numpy RoPE tables "
          f"{numpy_tables_ms:.4f} ms", flush=True)

    # K3 in fp32 on the core's split mode (the fp32 tower): B = 2, S = 577,
    # W = 1024, RoPE (the depth-2 tower's shape), held against the exact
    # fp32 plain version and the split plain version, with kv_valid < S and
    # without RoPE; B = 8 (the full-depth fp32 forward's shape) timed beside
    tol32 = 2e-5   # fp32: sums in another order, online vs one-pass softmax
    q32, k32, v32 = (randn(8, s, w, dtype=torch.float32) for _ in range(3))
    q2, k2, v2 = q32[:2], k32[:2], v32[:2]
    errs, errs_split = [], []
    for kv_valid, c, sn in ((None, cos, sin), (300, cos, sin), (None, None, None)):
        kw32 = dict(heads=heads, cos=c, sin=sn, kv_valid=kv_valid)
        t0 = kernels.launches["flash_heads_split"]
        out = flash_attention_heads(q2, k2, v2, **kw32)
        check(kernels.launches["flash_heads_split"] == t0 + 1, "fp32 missed the split mode")
        ref = flash_attention_heads_ref(q2, k2, v2, **kw32)
        ref_split = flash_attention_heads_split_ref(q2, k2, v2, **kw32)
        torch.cuda.synchronize()
        errs.append(max_err(out, ref))
        errs_split.append(max_err(out, ref_split))
        check(errs[-1] <= tol32 and errs_split[-1] <= tol32,
              f"flash_heads fp32 kv_valid={kv_valid} rope={c is not None}: max abs err "
              f"{errs[-1]} / {errs_split[-1]} (split plain version) > {tol32}")
    split2 = lambda t: t.reshape(t.shape[0], s, heads, hd).transpose(1, 2).contiguous()
    qh, kh, vh = split2(q2), split2(k2), split2(v2)
    rows["flash_heads_f32"] = dict(
        source="reverso_tpu_torch/csrc/flash_tc.cuh",
        replaces="reverso_tpu/ops/attention.py:337",
        max_abs_err=max(errs), max_abs_err_split_plain=max(errs_split),
        shape="B=2 S=577 W=1024 H=16 fp32 RoPE (split mode; depth-2 tower parity)",
        ms=cuda_ms(lambda: flash_attention_heads(q2, k2, v2, **kw)),
        plain_ms=cuda_ms(lambda: flash_attention_heads_ref(q2, k2, v2, **kw)),
        split_plain_ms=cuda_ms(lambda: flash_attention_heads_split_ref(q2, k2, v2, **kw)),
        library="F.scaled_dot_product_attention on [B, H, S, D] (no RoPE, fp32)",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
        ms_b8=cuda_ms(lambda: flash_attention_heads(q32, k32, v32, **kw)))
    rows["flash_heads_f32"]["bound_ms"], rows["flash_heads_f32"]["bound_by"] = heads_bound(
        2, s, w, heads, 4, "float32_split")
    rows["flash_heads_f32"]["bound_ms_b8"] = heads_bound(8, s, w, heads, 4, "float32_split")[0]
    r = rows["flash_heads_f32"]
    print(f"flash_heads fp32 (split mode): max abs err {errs} against the fp32 plain version, "
          f"{errs_split} against the split plain version (tol {tol32}); B=8: {r['ms_b8']:.4f} "
          f"ms (bound {r['bound_ms_b8']:.4f})", flush=True)
    del q32, k32, v32, q2, k2, v2, qh, kh, vh

    # K4: PE-L14 MLP, T=8*577, 1024 -> 4096 -> 1024, gelu and quick_gelu, on
    # the two wgmma GEMMs; a ragged T (1000 = 7 * 128 + 104) and T = 36,928
    # (B = 64, the direct-embed forward's batch); beside it the cuBLAS route
    # of three PyTorch calls (F.linear, F.gelu, F.linear: no single call
    # computes the MLP)
    t, hid = 8 * 577, 4096
    w1, b1 = randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.02)
    w2, b2 = randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.02)
    # bf16 output; h rounds to bf16 in both, sums in another order: within
    # 2e-2 absolute at T = 4616 (the row's gate), and within 2e-2 of
    # max(1, |y|) for each element at every T (T = 36,928 draws outputs
    # past 4, where one bf16 ulp is 0.031)
    tol = 2e-2
    errs = []
    for tt, act in ((t, "gelu"), (t, "quick_gelu"), (1000, "gelu"), (36928, "gelu")):
        x = randn(tt, w)
        t0 = kernels.launches["fused_mlp_tc"]
        out = fused_mlp(x, w1, b1, w2, b2, act=act)
        check(kernels.launches["fused_mlp_tc"] == t0 + 1, "fused_mlp: not the wgmma GEMMs")
        ref = mlp_ref(x, w1, b1, w2, b2, act=act)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        errs.append(float(diff.max()))
        check(bool((diff <= tol * ref.float().abs().clamp(min=1.0)).all())
              and (tt != t or errs[-1] <= tol),
              f"fused_mlp T={tt} {act}: max abs err {errs[-1]} (tol {tol})")
        del diff
        if tt == 36928:
            x64 = x
    del out, ref
    x = randn(t, w)
    route = lambda xx: F.linear(F.gelu(F.linear(xx, w1, b1)), w2, b2)
    rows["fused_mlp"] = dict(
        source="reverso_tpu_torch/csrc/fused_mlp.cu",
        replaces="reverso_tpu/ops/fused_mlp.py:63",
        max_abs_err=max(errs), shape="T=4616 1024->4096->1024 bf16 gelu",
        ms=cuda_ms(lambda: fused_mlp(x, w1, b1, w2, b2, act="gelu")),
        plain_ms=cuda_ms(lambda: mlp_ref(x, w1, b1, w2, b2, act="gelu")),
        library="none: no single PyTorch call", library_ms=None,
        library_route="F.linear, F.gelu, F.linear (cuBLAS, three calls)",
        library_route_ms=cuda_ms(lambda: route(x)),
        ms_b64=cuda_ms(lambda: fused_mlp(x64, w1, b1, w2, b2, act="gelu")),
        library_route_ms_b64=cuda_ms(lambda: route(x64)),
        # h written and read back as bf16 between the GEMMs, at the HBM rate
        h_roundtrip_bound_ms=2 * t * hid * 2 / HBM_BYTES_S * 1e3)
    rows["fused_mlp"]["bound_ms"], rows["fused_mlp"]["bound_by"] = mlp_bound(
        t, w, hid, 2, "bfloat16")
    rows["fused_mlp"]["bound_ms_b64"] = mlp_bound(36928, w, hid, 2, "bfloat16")[0]
    r = rows["fused_mlp"]
    print(f"fused_mlp: max abs err {errs} (tol {tol}); cuBLAS route {r['library_route_ms']:.4f} "
          f"ms; T=36928: {r['ms_b64']:.4f} ms (cuBLAS route {r['library_route_ms_b64']:.4f}, "
          f"bound {r['bound_ms_b64']:.4f}); h round trip at the HBM rate "
          f"{r['h_roundtrip_bound_ms']:.4f} ms", flush=True)

    # the tower's norm sites (`ops/norm.py::add_layernorm`): a B = 64 batch's
    # tokens, T = 36,928, W = 1024, bf16, in the three modes the tower runs
    # (LayerNorm alone, the residual add, with LayerScale), against the
    # plain composition: r bit for bit, h within one bf16 ulp (plus 1e-5
    # near 0, where the affine's fp32 terms cancel)
    from reverso_tpu_torch.ops.norm import add_layernorm, add_layernorm_ref

    t_norm = 64 * 577
    xn, yn = randn(t_norm, w, scale=3.0), randn(t_norm, w)
    lw = 1 + 0.3 * randn(w, dtype=torch.float32)
    lb, gam = randn(w, dtype=torch.float32), 0.1 + 0.05 * randn(w, dtype=torch.float32)
    errs = []
    with torch.inference_mode():
        for y_, g_ in ((None, None), (yn, None), (yn, gam)):
            t0 = kernels.launches["add_layernorm"]
            r_, h_ = add_layernorm(xn, y_, lw, lb, gamma=g_)
            check(kernels.launches["add_layernorm"] == t0 + 1, "add_layernorm: not the kernel")
            rr_, hr_ = add_layernorm_ref(xn, y_, lw, lb, gamma=g_)
            torch.cuda.synchronize()
            check(torch.equal(r_, rr_), "add_layernorm: the residual differs from the plain one")
            _, e_ = torch.frexp(hr_.float())
            diff = (h_.float() - hr_.float()).abs()
            check(bool((diff <= torch.ldexp(torch.ones_like(diff), e_ - 8) + 1e-5).all()),
                  "add_layernorm: h beyond one bf16 ulp of the plain one")
            errs.append(float(diff.max()))
        del r_, h_, rr_, hr_, diff, e_
        rows["add_layernorm"] = dict(
            source="reverso_tpu_torch/csrc/add_layernorm.cu",
            replaces="none: XLA fuses the JAX tower's residual adds and LayerNorms "
                     "(reverso_tpu/models/vit.py); added for the port's plain passes",
            max_abs_err=max(errs), shape="T=36928 W=1024 bf16, residual + LayerScale",
            ms=cuda_ms(lambda: add_layernorm(xn, yn, lw, lb, gamma=gam)),
            plain_ms=cuda_ms(lambda: add_layernorm_ref(xn, yn, lw, lb, gamma=gam)),
            norm_alone_ms=cuda_ms(lambda: add_layernorm(xn, None, lw, lb)),
            library="none: no single PyTorch call", library_ms=None)
    rows["add_layernorm"]["bound_ms"], rows["add_layernorm"]["bound_by"] = bound(
        4 * t_norm * w * 2 + 3 * w * 4, 0, "bfloat16")
    rows["add_layernorm"]["norm_alone_bound_ms"] = bound(2 * t_norm * w * 2 + 2 * w * 4, 0,
                                                         "bfloat16")[0]
    del xn, yn
    # fp32, the fp32 tower's B = 8 forward (T = 4616): r bit for bit, h
    # within 1e-5 of max(1, |h|) (the order of the fp32 sums)
    t32 = 8 * 577
    xf, yf = randn(t32, w, dtype=torch.float32, scale=3.0), randn(t32, w, dtype=torch.float32)
    errs32 = []
    with torch.inference_mode():
        for y_, g_ in ((None, None), (yf, None), (yf, gam)):
            t0 = kernels.launches["add_layernorm"]
            r_, h_ = add_layernorm(xf, y_, lw, lb, gamma=g_)
            check(kernels.launches["add_layernorm"] == t0 + 1,
                  "add_layernorm fp32: not the kernel")
            rr_, hr_ = add_layernorm_ref(xf, y_, lw, lb, gamma=g_)
            torch.cuda.synchronize()
            check(torch.equal(r_, rr_), "add_layernorm fp32: the residual differs")
            diff = (h_ - hr_).abs()
            check(bool((diff <= 1e-5 * hr_.abs().clamp(min=1.0)).all()),
                  "add_layernorm fp32: h beyond 1e-5 of the plain one")
            errs32.append(float(diff.max()))
        rows["add_layernorm"].update(
            max_abs_err_f32=max(errs32), shape_f32="T=4616 W=1024 fp32, residual + LayerScale",
            ms_f32=cuda_ms(lambda: add_layernorm(xf, yf, lw, lb, gamma=gam)),
            plain_ms_f32=cuda_ms(lambda: add_layernorm_ref(xf, yf, lw, lb, gamma=gam)))
    del r_, h_, rr_, hr_, diff, xf, yf
    rows["add_layernorm"]["bound_ms_f32"] = bound(4 * t32 * w * 4 + 3 * w * 4, 0, "float32")[0]
    r = rows["add_layernorm"]
    print(f"add_layernorm: max abs err {errs}; {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
          f"bound {r['bound_ms']:.4f}); alone {r['norm_alone_ms']:.4f} "
          f"(bound {r['norm_alone_bound_ms']:.4f}); fp32 T=4616 err {errs32}, "
          f"{r['ms_f32']:.4f} ms (plain {r['plain_ms_f32']:.4f}, bound {r['bound_ms_f32']:.4f})",
          flush=True)

    # K4 in fp32 on the split GEMMs (the fp32 tower): T = 2 * 577, the
    # depth-2 tower's forward (`tower_check`), and T = 4616, the full-depth
    # B = 8 forward's; the weights' parts made once by the split pass, as
    # the tower caches them (the direct call without them, which splits the
    # weights per call, timed beside); held against the exact fp32 plain
    # version and the split plain version; the cuBLAS route of three fp32
    # calls beside it
    f32, t32 = torch.float32, 2 * 577
    w1f, b1f, w2f, b2f = (p.float() for p in (w1, b1, w2, b2))
    n0 = kernels.launches["split_parts"]
    parts = split_mlp_weights(w1f, w2f)
    check(kernels.launches["split_parts"] == n0 + 2, "the weights' parts missed the split pass")
    tol32 = 1e-4   # fp32: sums in another order, A&S erf against the plain version's gelu
    errs, errs_split, xs = [], [], {}
    for tt, act in ((t32, "gelu"), (t32, "quick_gelu"), (t, "gelu"), (1000, "gelu")):
        x32 = randn(tt, w, dtype=f32)
        xs.setdefault(tt, x32)
        n0 = kernels.launches["fused_mlp_split"]
        out = fused_mlp(x32, w1f, b1f, w2f, b2f, act=act, parts=parts)
        check(kernels.launches["fused_mlp_split"] == n0 + 1, "fused_mlp fp32: not the split GEMMs")
        errs.append(max_err(out, mlp_ref(x32, w1f, b1f, w2f, b2f, act=act)))
        errs_split.append(max_err(out, mlp_split_ref(x32, w1f, b1f, w2f, b2f, act=act)))
        check(errs[-1] <= tol32 and errs_split[-1] <= tol32,
              f"fused_mlp fp32 T={tt} {act}: max abs err {errs[-1]} / {errs_split[-1]} (split "
              f"plain version) > {tol32}")
    x32, x4616 = xs[t32], xs[t]
    route32 = lambda xx: F.linear(F.gelu(F.linear(xx, w1f, b1f)), w2f, b2f)
    rows["fused_mlp_f32"] = dict(
        source="reverso_tpu_torch/csrc/fused_mlp.cu",
        replaces="reverso_tpu/ops/fused_mlp.py:63",
        max_abs_err=max(errs), max_abs_err_split_plain=max(errs_split),
        shape="T=1154 1024->4096->1024 fp32 gelu on the split GEMMs (depth-2 tower parity)",
        ms=cuda_ms(lambda: fused_mlp(x32, w1f, b1f, w2f, b2f, act="gelu", parts=parts)),
        plain_ms=cuda_ms(lambda: mlp_ref(x32, w1f, b1f, w2f, b2f, act="gelu")),
        split_plain_ms=cuda_ms(lambda: mlp_split_ref(x32, w1f, b1f, w2f, b2f, act="gelu")),
        library="none: no single PyTorch call", library_ms=None,
        library_route="F.linear, F.gelu, F.linear (cuBLAS fp32, three calls)",
        library_route_ms=cuda_ms(lambda: route32(x32)),
        ms_weights_split_per_call=cuda_ms(lambda: fused_mlp(x32, w1f, b1f, w2f, b2f)),
        ms_t4616=cuda_ms(lambda: fused_mlp(x4616, w1f, b1f, w2f, b2f, parts=parts)),
        library_route_ms_t4616=cuda_ms(lambda: route32(x4616)),
        bound_ms_t4616=mlp_bound(t, w, hid, 4, "float32_split")[0])
    rows["fused_mlp_f32"]["bound_ms"], rows["fused_mlp_f32"]["bound_by"] = mlp_bound(
        t32, w, hid, 4, "float32_split")
    r = rows["fused_mlp_f32"]
    print(f"fused_mlp fp32 (split GEMMs): max abs err {errs} against the fp32 plain version, "
          f"{errs_split} against the split plain version (tol {tol32}); cuBLAS route "
          f"{r['library_route_ms']:.4f} ms; T=4616: {r['ms_t4616']:.4f} ms (cuBLAS route "
          f"{r['library_route_ms_t4616']:.4f}, bound {r['bound_ms_t4616']:.4f})", flush=True)

    # the split pass (K4 fp32's operands): W1's parts at PE-L14's 4096 x
    # 1024, equal bit for bit to the plain version's
    n0 = kernels.launches["split_parts"]
    out = split_parts(w1f, 3)
    check(kernels.launches["split_parts"] == n0 + 1, "split_parts: not the kernel")
    err = max_err(out, split_parts_ref(w1f, 3))
    check(err == 0.0, f"split_parts: {err} from its plain version")
    rows["split_parts"] = dict(
        source="reverso_tpu_torch/csrc/fused_mlp.cu",
        replaces="reverso_tpu/ops/fused_mlp.py:63",
        max_abs_err=err, shape="4096 x 1024 fp32 -> 3 bf16 parts (W1 of PE-L14)",
        ms=cuda_ms(lambda: split_parts(w1f, 3), iters=20),
        plain_ms=cuda_ms(lambda: split_parts_ref(w1f, 3)),
        library="none: no single PyTorch call (three casts and two subtractions)",
        library_ms=None)
    rows["split_parts"]["bound_ms"], rows["split_parts"]["bound_by"] = bound(
        hid * w * (4 + 3 * 2), hid * w * 5, "float32")
    del x, x64, w1, b1, w2, b2, x32, x4616, xs, w1f, b1f, w2f, b2f, out, parts

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
    # one query over the same rows: the scan as a pure stream
    q1 = qs[:1].contiguous()
    s1, i1 = cosine_topk(db, q1, 10, n_valid=n_valid)
    r1s, r1i = cosine_topk_ref(db, q1, 10, n_valid=n_valid)
    topk_agree(r1s, r1i, s1, i1, tol)
    rows["topk_stream"]["q1_ms"] = cuda_ms(lambda: cosine_topk(db, q1, 10, n_valid=n_valid),
                                           iters=10)
    rows["topk_stream"]["q1_bound_ms"] = bound((n_valid + 1) * w * 2 + 80,
                                               2 * n_valid * w, "bfloat16")[0]
    print(f"topk_stream: max abs score err {err} (tol {tol}); Q = 1: "
          f"{rows['topk_stream']['q1_ms']:.4f} ms", flush=True)
    check(all(v == 0 for v in kernels.plain_dispatches.values()),
          "a k <= 128 search must not take the plain path")
    del small

    # K1 on fp32 rows (`DeviceIndex(dtype="float32")`, the wgmma scan's split
    # mode: three bf16 parts a value, six products a k16 step): 1M x 1024
    # fp32 (4.1 GB) at Q = 64 and 256, k = 10, against the plain version
    # under the tie-margin rule, with a matmul and a topk beside it
    db32 = db[:n_valid].float()
    del db
    q32 = qs.float()
    tol32 = 1e-5   # the split's dropped terms (< 2^-23 of a product), sums in another order
    by_q = {}
    for qn in (64, 256):
        qq = q32[:qn].contiguous()
        out_s, out_i = cosine_topk(db32, qq, 10)
        ref_s, ref_i = cosine_topk_ref(db32, qq, 10)
        topk_agree(ref_s, ref_i, out_s, out_i, tol32)
        by_q[qn] = dict(
            max_abs_err=float((out_s - ref_s).abs().max()),
            ms=cuda_ms(lambda: cosine_topk(db32, qq, 10), iters=5),
            plain_ms=cuda_ms(lambda: cosine_topk_ref(db32, qq, 10), iters=3),
            library_route_ms=cuda_ms(lambda: torch.topk(qq @ db32.T, 10, dim=1), iters=3),
            bound=bound(n_valid * w * 4 + qn * w * 4 + qn * 10 * 8, 2 * qn * n_valid * w,
                        "float32_split"))
    # small ragged case in fp32: duplicates tie to the lower row, k > n_valid
    small32 = torch.randn(1000, w, generator=torch.Generator(device=dev).manual_seed(12),
                          device=dev)
    small32 = small32 / small32.norm(dim=1, keepdim=True)
    small32[10] = small32[3]
    small32[500] = small32[3]
    sq32 = small32[[3, 0, 5]].contiguous()
    s2, i2 = cosine_topk(small32, sq32, 20, n_valid=600)
    r2s, r2i = cosine_topk_ref(small32, sq32, 20, n_valid=600)
    topk_agree(r2s, r2i, s2, i2, tol32)
    check(i2[0, :3].tolist() == [3, 10, 500], f"fp32 ties must go to the lower row: {i2[0, :3]}")
    s3, i3 = cosine_topk(small32, sq32, 20, n_valid=7)
    check(bool((i3[:, 7:] == -1).all()) and bool(torch.isneginf(s3[:, 7:]).all()),
          "fp32 k > n_valid: slots past the valid rows must be (-inf, -1)")
    del small32
    main = by_q[256]
    rows["topk_stream_f32"] = dict(
        source="reverso_tpu_torch/csrc/topk_stream.cu",
        replaces="reverso_tpu/ops/topk.py:183",
        max_abs_err=max(r["max_abs_err"] for r in by_q.values()),
        shape="N=1,000,000 d=1024 Q=256 k=10 fp32 rows (the wgmma scan's split mode)",
        ms=main["ms"], plain_ms=main["plain_ms"],
        library="none: no single PyTorch call (a matmul and a topk)", library_ms=None,
        library_route="torch.matmul, torch.topk", library_route_ms=main["library_route_ms"],
        bound_ms=main["bound"][0], bound_by=main["bound"][1],
        q64_ms=by_q[64]["ms"], q64_library_route_ms=by_q[64]["library_route_ms"],
        q64_bound_ms=by_q[64]["bound"][0], q64_bound_by=by_q[64]["bound"][1])
    print(f"topk_stream fp32 rows: {json.dumps(by_q)}", flush=True)
    del db32
    return rows


def region_kernel_checks(torch, gen) -> dict:
    """K6, K7, K8 against their plain versions at the region and ViT
    long-sequence paths' shapes and at small ragged shapes."""
    import torch.nn.functional as F
    from reverso_tpu_torch.ops.attention import (attention_ref, attention_split_ref,
                                                  flash_attention)
    from reverso_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_ref

    dev = torch.device("cuda")
    rows = {}

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # K6: SAM ViT-B global layers, B=4 H=12 S=4096 D=64 G=64, fp32 (the
    # detector's dtype) and bf16, on the tensor-core core with bf16 operands
    # (the TPU kernel's one bf16 pass); ragged: Sq = 150 (not a multiple of
    # the 64-row tile), kv_valid = 190 < 196, G = 14 (keys' lattice row and
    # column computed per key)
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import attention_bf16_ref, rel_bias_dense
    f32, bf16 = torch.float32, torch.bfloat16
    tol = 2e-2   # bf16 operands: one output ulp (bf16) or p rounded against
    # the running max (fp32) from the bf16-operand plain version; the
    # operands' rounding from the fp32 one
    errs, errs32, sam = [], [], {}
    for b, h, g, d, sq, kv_valid in ((4, 12, 64, 64, 4096, None),
                                     (1, 2, 14, 32, 150, 190)):
        for dt in (f32, bf16):
            q = randn(b, h, sq, d, dtype=dt)
            k, v = randn(b, h, g * g, d, dtype=dt), randn(b, h, g * g, d, dtype=dt)
            bh, bw = randn(b, h, sq, g, dtype=f32, scale=0.5), randn(b, h, sq, g, dtype=f32, scale=0.5)
            kw = dict(kv_valid=kv_valid, rel_bias=(bh, bw, g), scale=d ** -0.5)
            t0 = kernels.launches["flash_attn_relbias_tc"]
            out = flash_attention(q, k, v, **kw)
            check(kernels.launches["flash_attn_relbias_tc"] == t0 + 1,
                  "flash_attn rel-bias: not the tensor-core core")
            check(out.dtype == dt, f"flash_attn rel-bias output dtype {out.dtype}")
            ref16 = attention_bf16_ref(q, k, v, **kw)
            ref = attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            errs.append(max_err(out, ref16))
            errs32.append(max_err(out, ref))
            check(errs[-1] <= tol and errs32[-1] <= tol,
                  f"flash_attn rel-bias {q.shape} {dt}: max abs err {errs[-1]} (bf16 "
                  f"operands), {errs32[-1]} (fp32) > {tol}")
            del ref16, ref
            if sq == 4096:
                sam[dt] = (q, k, v, bh, bw, kw)
    q16, k16, v16, bh16, bw16, kw16 = sam.pop(bf16)
    q, k, v, bh, bw, kw = sam.pop(f32)
    b, h, s, d, g = 4, 12, 4096, 64, 64
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    ms_bf16 = cuda_ms(lambda: flash_attention(q16, k16, v16, **kw16))
    plain_ms = cuda_ms(lambda: attention_bf16_ref(q, k, v, **kw), iters=2)
    mask = rel_bias_dense(bh, bw, g)   # [B, H, S, S] fp32, 3.2 GB
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                     iters=2)
    mask = rel_bias_dense(bh16, bw16, g).to(bf16)
    lib_bf16_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q16, k16, v16, attn_mask=mask),
                          iters=2)
    del mask
    rows["flash_attn_relbias"] = dict(
        source="reverso_tpu_torch/csrc/flash_tc.cuh",
        replaces="reverso_tpu/ops/attention.py:131",
        max_abs_err=max(errs),
        shape="B=4 H=12 S=4096 D=64 G=64 fp32 in and out, bf16 operands (SAM global); "
              "ms with the wrapper's bf16 casts",
        ms=ms, plain_ms=plain_ms,
        library="F.scaled_dot_product_attention with the bias materialized "
                "as a [B, H, S, S] fp32 attn_mask (not timed)",
        library_ms=lib_ms, ms_bf16=ms_bf16, library_bf16_ms=lib_bf16_ms,
        max_abs_err_vs_fp32=max(errs32))
    rows["flash_attn_relbias"]["bound_ms"], rows["flash_attn_relbias"]["bound_by"] = bound(
        4 * b * h * s * d * 4 + 2 * b * h * s * g * 4,
        4 * b * h * s * s * d + 2 * b * h * s * s, "bfloat16")
    print(f"flash_attn rel-bias (tensor cores): max abs err vs the bf16-operand plain version "
          f"{errs}, vs the fp32 plain version {errs32} (tol {tol}; fp32, bf16 at each shape); "
          f"bf16 inputs {ms_bf16:.4f} ms, SDPA bf16 with a bf16 mask {lib_bf16_ms:.4f} ms",
          flush=True)
    del q16, k16, v16, bh16, bw16, kw16

    # K6 with fp32 operands on the split mode: SAM's shape through the
    # route this script forces (as the SAM parity phase does), a ragged
    # case (Sq = 150, G = 14: the bias mode whose tiles cross lattice rows,
    # kv_valid 190 < 196) and a head dim the bf16 core does not take (D =
    # 40, where the split mode is the default route), each against the
    # fp32 `attention_ref` and the split mode's plain version
    tol32 = 2e-5   # fp32 operands: six products, sums in another order, online softmax
    err_sp = []
    n0 = kernels.launches["flash_attn_relbias_split"]
    with split_relbias():
        out = flash_attention(q, k, v, **kw)
        err_sp += [max_err(out, attention_ref(q, k, v, **kw)),
                   max_err(out, attention_split_ref(q, k, v, **kw))]
        del out
        for d2 in (32, 40):
            q2, k2, v2 = (randn(1, 2, n, d2, dtype=f32) for n in (150, 196, 196))
            bh2, bw2 = (randn(1, 2, 150, 14, dtype=f32, scale=0.5) for _ in range(2))
            kw2 = dict(kv_valid=190, rel_bias=(bh2, bw2, 14))
            out = flash_attention(q2, k2, v2, **kw2)
            err_sp += [max_err(out, attention_ref(q2, k2, v2, **kw2)),
                       max_err(out, attention_split_ref(q2, k2, v2, **kw2))]
        split_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()
    check(kernels.launches["flash_attn_relbias_split"] == n0 + 3 + 6,
          "flash_attn rel-bias fp32: not the split mode")
    check(max(err_sp) <= tol32, f"the split-mode rel-bias kernel: max abs err {err_sp} > {tol32}")
    rows["flash_attn_relbias_f32"] = dict(
        source="reverso_tpu_torch/csrc/flash_tc.cuh",
        replaces="reverso_tpu/ops/attention.py:131",
        max_abs_err=max(err_sp),
        shape="B=4 H=12 S=4096 D=64 G=64 fp32 operands on the split mode (head dims the bf16 "
              "core does not take; SAM parity on this route)",
        ms=split_ms, plain_ms=cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=2),
        library="F.scaled_dot_product_attention with the bias materialized "
                "as a [B, H, S, S] fp32 attn_mask (not timed)",
        library_ms=lib_ms)
    rows["flash_attn_relbias_f32"]["bound_ms"], rows["flash_attn_relbias_f32"]["bound_by"] = \
        bound(4 * b * h * s * d * 4 + 2 * b * h * s * g * 4,
              4 * b * h * s * s * d + 2 * b * h * s * s, "float32_split")
    print(f"flash_attn rel-bias (split mode): max abs err vs attention_ref, "
          f"attention_split_ref at SAM's shape, D = 32 and D = 40 (G = 14, ragged) {err_sp} "
          f"(tol {tol32}), {split_ms:.4f} ms", flush=True)
    del q, k, v, bh, bw, kw

    # K7: PE-L14 at 504 px, B=8 H=16 S=1297 D=64, bf16 (the tower's dtype),
    # on the bf16 core; the same shape at B=2 in fp32 (the fp32 tower
    # parity phase's) on the split mode
    tol = 2e-2   # bf16 output (8-bit mantissa); p rounds before vs after normalizing
    b, h, s, d = 8, 16, 1297, 64
    q, k, v = (randn(b, h, s, d, dtype=bf16) for _ in range(3))
    t0 = kernels.launches["flash_attn_tc"]
    out = flash_attention(q, k, v)
    check(kernels.launches["flash_attn_tc"] == t0 + 1, "flash_attn: not the tensor-core kernel")
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(err <= tol, f"flash_attn {q.shape}: max abs err {err} > {tol}")
    t0 = kernels.launches["flash_attn_tc"]
    ms = cuda_ms(lambda: flash_attention(q, k, v))
    check(kernels.launches["flash_attn_tc"] == t0 + 6, "flash_attn timing: not the tensor-core kernel")
    rows["flash_attn"] = dict(
        source="reverso_tpu_torch/csrc/flash_tc.cuh",
        replaces="reverso_tpu/ops/attention.py:48",
        max_abs_err=err, shape="B=8 H=16 S=1297 D=64 bf16 (PE-L14 at 504 px)",
        ms=ms, plain_ms=cuda_ms(lambda: attention_ref(q, k, v)),
        library="F.scaled_dot_product_attention",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    rows["flash_attn"]["bound_ms"], rows["flash_attn"]["bound_by"] = bound(
        4 * b * h * s * d * 2, 4 * b * h * s * s * d, "bfloat16")
    print(f"flash_attn: max abs err {err} (tol {tol})", flush=True)
    del q, k, v, out, ref

    q, k, v = (randn(2, h, s, d, dtype=f32) for _ in range(3))
    errs = []
    for kv_valid in (None, 1000):
        t0 = kernels.launches["flash_attn_split"]
        out = flash_attention(q, k, v, kv_valid=kv_valid)
        check(kernels.launches["flash_attn_split"] == t0 + 1, "fp32 missed the split mode")
        ref = attention_ref(q, k, v, kv_valid=kv_valid)
        ref_split = attention_split_ref(q, k, v, kv_valid=kv_valid)
        torch.cuda.synchronize()
        errs += [max_err(out, ref), max_err(out, ref_split)]
        check(max(errs) <= tol32, f"flash_attn fp32 kv_valid={kv_valid}: max abs err "
                                  f"{errs[-2:]} > {tol32}")
    rows["flash_attn_f32"] = dict(
        source="reverso_tpu_torch/csrc/flash_tc.cuh",
        replaces="reverso_tpu/ops/attention.py:48",
        max_abs_err=max(errs),
        shape="B=2 H=16 S=1297 D=64 fp32 on the split mode (depth-2 504 px parity)",
        ms=cuda_ms(lambda: flash_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: attention_ref(q, k, v)),
        library="F.scaled_dot_product_attention (fp32)",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    rows["flash_attn_f32"]["bound_ms"], rows["flash_attn_f32"]["bound_by"] = bound(
        4 * 2 * h * s * d * 4, 4 * 2 * h * s * s * d, "float32_split")
    print(f"flash_attn fp32 (split mode): max abs err vs attention_ref, attention_split_ref "
          f"{errs} (tol {tol32})", flush=True)
    del q, k, v

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
    rows["ms_deform"]["bound_ms"], rows["ms_deform"]["bound_by"] = k8_bound(
        b, lv, lv, h, d, n_l, p)
    print(f"ms_deform: max abs err {errs} (tol {tol})", flush=True)
    return rows


def rope_tables(s: int, hd: int):
    """[s, hd] fp32 RoPE tables: the 2D grid's rows (class token first),
    identity rows past them."""
    from reverso_tpu_torch.ops.rope import rope_2d_tables
    cos, sin = np.ones((s, hd), np.float32), np.zeros((s, hd), np.float32)
    c, sn = rope_2d_tables(int(np.sqrt(max(s - 1, 0))), hd)
    cos[:len(c)], sin[:len(c)] = c[:s], sn[:s]
    return cos, sin


def attention_edge_checks(torch, gen) -> None:
    """K3 and K7 at ragged and edge shapes against their plain versions:
    S in {1, 63, 64, 65, 129}, kv_valid in {1, 63, 64, 65, S - 1} and 0
    (NaN, as the plain versions), head dims 16, 32, 64, 96, 128, S_kv !=
    S_q, B * H = 1 and 1024; bf16 on the tensor-core kernel, K3 also at
    head dims 20, 24, 40 and 72 and at bases one element into their
    buffers (the lanes' copy, rotating K as they load it), K7 also at head
    dims 6, 40 and 72 (padded to a multiple of 16: the lanes' copy, TMA
    past the row's end); the same K3 and K7 shapes in fp32 on the split
    mode at the 2e-5 gate, K3's also against its split plain version."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (attention_ref, flash_attention,
                                                  flash_attention_heads,
                                                  flash_attention_heads_ref,
                                                  flash_attention_heads_split_ref)

    bf16, tol, tol32 = torch.bfloat16, 2e-2, 2e-5

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def close(out, ref, what, tol=tol):
        nan = torch.isnan(ref)
        check(torch.equal(torch.isnan(out), nan), f"{what}: NaN where the plain version has none")
        diff = (out.float() - ref.float())[~nan].abs()
        err = float(diff.max()) if diff.numel() else 0.0
        check(err <= tol, f"{what}: max abs err {err} > {tol}")
        return err

    # (B, S, W, heads, kv_valid, RoPE); at head dims 20, 24, 40 and 72 the
    # bf16 core takes the lanes' copy, as every case does once more one
    # element into its buffers
    heads_cases = ([(1, n, 128, 2, None, True) for n in (1, 63, 64, 65, 129)]
                   + [(2, 129, 128, 2, kv, True) for kv in (1, 63, 64, 65, 128, 0)]
                   + [(2, 129, 4 * hd, 4, 100, hd != 32) for hd in (16, 32, 64, 96, 128)]
                   + [(1, 65, 64, 1, None, True), (64, 65, 1024, 16, None, True)]
                   + [(2, 129, 80, 4, 100, True), (1, 65, 96, 4, None, False),
                      (2, 129, 160, 4, 64, True), (1, 37, 288, 4, 30, True),
                      (8, 577, 1280, 16, None, True)])
    errs, errs32 = [], []
    for dtype in (bf16, torch.float32):
        counter = "flash_heads_tc" if dtype == bf16 else "flash_heads_split"
        for b, s, w, heads, kv, rope in heads_cases:
            q, k, v = (randn(b, s, w, dtype=dtype) for _ in range(3))
            cos, sin = rope_tables(s, w // heads) if rope else (None, None)
            kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=kv)
            what = f"flash_heads B={b} S={s} W={w} heads={heads} kv_valid={kv} {dtype}"
            ref = flash_attention_heads_ref(q, k, v, **kw)
            t0 = kernels.launches[counter]
            outs = [flash_attention_heads(q, k, v, **kw),
                    flash_attention_heads(*(offset_copy(torch, t) for t in (q, k, v)), **kw)]
            check(kernels.launches[counter] == t0 + 2, f"{what}: not {counter}")
            for out in outs:
                if dtype == bf16:
                    errs.append(close(out, ref, what))
                else:
                    errs32.append(close(out, ref, what, tol32))
                    close(out, flash_attention_heads_split_ref(q, k, v, **kw),
                          f"{what} (split plain version)", tol32)
            if dtype == bf16 and w // heads % 16 == 0:   # the copy route computes TMA's values
                check(torch.equal(torch.nan_to_num(outs[0]), torch.nan_to_num(outs[1])),
                      f"{what}: the copy route differs from the TMA route")
    # (B, H, S_q, S_kv, D, kv_valid)
    attn_cases = ([(1, 2, n, n, 64, None) for n in (1, 63, 64, 65, 129)]
                  + [(1, 2, 129, 129, 64, kv) for kv in (1, 63, 64, 65, 128, 0)]
                  + [(1, 2, 129, 129, d, 100) for d in (16, 32, 64, 96, 128)]
                  + [(1, 4, 200, 131, 64, 100), (1, 2, 65, 129, 64, None),
                     (1, 1, 65, 65, 64, None), (64, 16, 65, 65, 64, None),
                     (1, 4, 200, 131, 6, 100), (1, 2, 129, 129, 40, 100),
                     (1, 2, 129, 129, 72, 65)])
    for dtype in (bf16, torch.float32):
        for b, h, sq, skv, d, kv in attn_cases:
            q, k, v = (randn(b, h, n, d, dtype=dtype) for n in (sq, skv, skv))
            counter = "flash_attn_tc" if dtype == bf16 else "flash_attn_split"
            t0 = kernels.launches[counter]
            out = flash_attention(q, k, v, kv_valid=kv)
            check(kernels.launches[counter] == t0 + 1,
                  f"flash_attn {(b, h, sq, skv, d)} {dtype}: not {counter}")
            (errs if dtype == bf16 else errs32).append(close(
                out, attention_ref(q, k, v, kv_valid=kv),
                f"flash_attn B={b} H={h} Sq={sq} Skv={skv} D={d} kv_valid={kv} {dtype}",
                tol if dtype == bf16 else tol32))
    torch.cuda.synchronize()
    print(f"attention edge cases: {len(heads_cases)} heads-in-lanes shapes (each also at "
          f"unaligned bases) and {len(attn_cases)} [B, H, S, D] shapes within {tol}, max abs "
          f"err {max(errs)}; the same shapes in fp32 (split mode) within {tol32}, max abs err "
          f"{max(errs32)}", flush=True)


def int8_kernel_checks(torch, gen):
    """K5 (the int8 MLP) and K12 (the per-row-scale int8 candidate scan)
    against their plain versions on the card. Returns the kernel rows and
    K12's 1M x 1024 data for the two-stage search's path."""
    from reverso_tpu_torch.ops.fused_mlp import (fused_mlp_int8, mlp_int8_plain,
                                                 mlp_int8_ref, quantize_mlp_weights)
    from reverso_tpu_torch.ops.quant import int_dot, quantize_rows_int8
    from reverso_tpu_torch.ops.topk_int8 import (quantize_queries, quantize_rows,
                                                 topk_int8_rows, topk_int8_rows_ref)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    # K5: bit for bit where the plain version's rounding is the kernel's; a
    # rare hidden-quantum flip otherwise: under 0.2% of elements beyond one
    # output rounding, none beyond two hidden quanta times the largest W2
    # (T = 36,928 and 577: the int8 path's own shapes, B = 64 and one image)
    errs, flips, timed = [], [], {}
    for t, w, hid, act in ((4616, 1024, 4096, "gelu"), (4616, 1024, 4096, "quick_gelu"),
                           (1000, 1024, 4096, "gelu"), (77, 72, 200, "gelu"),
                           (36928, 1024, 4096, "gelu"), (577, 1024, 4096, "gelu")):
        x = randn(t, w)
        w1, b1 = randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.02)
        w2, b2 = randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.02)
        qw = quantize_mlp_weights(w1, b1, w2, b2, bf16)
        out = fused_mlp_int8(x, qw, act=act)
        ref = mlp_int8_ref(x, w1, b1, w2, b2, act=act)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        loose = diff > 2 ** -8 * (1 + ref.float().abs())
        errs.append(float(diff.max()))
        flips.append(int((diff > 0).sum()))
        check(float(loose.float().mean()) < 0.002,
              f"fused_mlp_int8 T={t} W={w} H={hid} {act}: {int(loose.sum())} elements off")
        if loose.any():
            x8, xs = quantize_rows_int8(x)
            h_amax = max(float((int_dot(x8, qw.w1[lo:lo + 512]).float()
                                * (xs * qw.s1[lo:lo + 512]) + qw.b1[lo:lo + 512]).abs().max())
                         for lo in range(0, hid, 512)) * 1.2
            quantum = 2 * h_amax / 127 * float((qw.w2.float().abs() * qw.s2[:, None]).max())
            check(float(diff[loose].max()) <= quantum + 2 ** -7 * (1 + float(ref.abs().max())),
                  f"fused_mlp_int8 T={t} {act}: a difference beyond two hidden quanta")
        if act == "gelu" and w == 1024 and t != 1000:
            timed[t] = (x, qw)
        del diff, loose, out, ref
    x, qw = timed[4616]
    t, w, hid = 4616, 1024, 4096
    r = rows["fused_mlp_int8"] = dict(
        source="reverso_tpu_torch/csrc/fused_mlp.cu",
        replaces="reverso_tpu/ops/fused_mlp.py:92",
        max_abs_err=max(errs), shape="T=4616 1024->4096->1024 bf16 gelu, int8 products",
        ms=cuda_ms(lambda: fused_mlp_int8(x, qw, act="gelu")),
        plain_ms=cuda_ms(lambda: mlp_int8_plain(x, qw, "gelu")),
        library="none: no single PyTorch call (torch._int_mm twice, with the "
                "per-chunk re-quantization between them)",
        library_ms=None,
        # h8 written and read back as int8 between the GEMMs, at the HBM rate
        h8_roundtrip_bound_ms=2 * t * hid / HBM_BYTES_S * 1e3)
    r["bound_ms"], r["bound_by"] = k5_bound(t, w, hid)
    for tt in (36928, 577):
        xx, qq = timed[tt]
        r[f"ms_t{tt}"] = cuda_ms(lambda: fused_mlp_int8(xx, qq, act="gelu"))
        r[f"bound_ms_t{tt}"] = k5_bound(tt, w, hid)[0]
    print(f"fused_mlp_int8: max abs err {errs}, elements differing from the plain "
          f"version {flips}; T=36928 {r['ms_t36928']:.4f} ms (bound "
          f"{r['bound_ms_t36928']:.4f}), T=577 {r['ms_t577']:.4f} ms (bound "
          f"{r['bound_ms_t577']:.4f}); h8 round trip at the HBM rate "
          f"{r['h8_roundtrip_bound_ms']:.4f} ms", flush=True)
    del x, qw, xx, qq, timed

    # K12 stage 1: 1M x 1024 int8 rows with row scales, Q = 256, k_fetch 40
    n, d, q, kf = 1_000_000, 1024, 256, 40
    xf = torch.randn(n, d, generator=gen, device=dev)
    xf /= xf.norm(dim=1, keepdim=True)
    xf[777_777] = xf[3]                                     # a tie: lower row first
    qf = xf[torch.arange(q, device=dev) * 3001].clone()
    qf += 0.05 * torch.randn(qf.shape, generator=gen, device=dev)
    qf /= qf.norm(dim=1, keepdim=True)
    qf[0] = xf[3]
    v8, sc = quantize_rows(xf)
    q8, qs = quantize_queries(qf)
    s, i = topk_int8_rows(v8, sc, q8, qs, kf)
    rs, ri = topk_int8_rows_ref(v8, sc, q8, qs, kf)
    torch.cuda.synchronize()
    check(torch.equal(i, ri) and torch.equal(s, rs),
          f"K12 differs from its plain version: ids {int((i != ri).sum())}, max score "
          f"diff {float((s - rs).abs().max())}")
    check(i[0, :2].tolist() == [3, 777_777], f"K12 tie order {i[0, :2].tolist()}")
    for nv, kk, qn in ((30, 40, 70), (999, 128, 65), (1001, 10, 3)):   # k > n_valid; ragged
        s2, i2 = topk_int8_rows(v8[:1001], sc[:1001], q8[:qn], qs[:qn], kk, n_valid=nv)
        r2s, r2i = topk_int8_rows_ref(v8[:1001], sc[:1001], q8[:qn], qs[:qn], kk, n_valid=nv)
        check(torch.equal(i2, r2i) and torch.equal(s2, r2s),
              f"K12 ragged case n_valid={nv} k={kk} differs")
    check(bool((i2[:, :3] >= 0).all()) and bool((i2 < 1001).all()), "K12 ragged ids")
    rows["topk_int8_rows"] = dict(
        source="reverso_tpu_torch/csrc/topk_stream.cu",
        replaces="reverso_tpu/ops/topk_int8.py:47",
        max_abs_err=0.0,
        shape="N=1,000,000 d=1024 int8 + f32 row scales, Q=256, k_fetch=40 (k=10, overfetch 4)",
        ms=cuda_ms(lambda: topk_int8_rows(v8, sc, q8, qs, kf)),
        plain_ms=cuda_ms(lambda: topk_int8_rows_ref(v8, sc, q8, qs, kf), iters=3),
        library="none: no single PyTorch call (an int8 matmul, two scalings and a topk)",
        library_ms=None)
    rows["topk_int8_rows"]["bound_ms"], rows["topk_int8_rows"]["bound_by"] = bound(
        n * d + n * 4 + q * d + q * 4 + q * kf * 8, 2 * q * n * d, "int8")
    print("topk_int8_rows: ids and scores equal the plain version's bit for bit", flush=True)
    return rows, (xf, v8, sc, qf)


def int8_search_run(torch, data) -> dict:
    """The two-stage int8 search at op level (`cosine_topk_int8`, no engine
    path routes to it): 1M x 1024, Q = 256, k = 10, overfetch 4, with a
    bf16 full-precision copy for the rescore. Returns its launches and
    K12's launches by shape."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk import cosine_topk_ref
    from reverso_tpu_torch.ops.topk_int8 import (cosine_topk_int8, quantize_queries,
                                                 rescore, topk_int8_rows_ref)

    xf, v8, sc, qf = data
    full = xf.to(torch.bfloat16)
    kernels.reset_counts()
    s, i = cosine_topk_int8(v8, sc, full, qf, 10)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    shapes = {key: n for key, n in kernels.shape_launches.items() if key[0] == "topk_int8_rows"}
    check(launches["topk_int8_rows"] > 0, "K12 never launched on the two-stage search")
    _, cand = topk_int8_rows_ref(v8, sc, *quantize_queries(qf), 40)
    rs, ri = rescore(full, qf, cand, 10)
    check(torch.equal(i, ri) and torch.equal(s, rs),
          "two-stage search differs from its plain pipeline")
    _, exact = cosine_topk_ref(xf, qf, 10)
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in
                            zip(i.cpu().tolist(), exact.cpu().tolist())]))
    check(recall >= 0.95, f"two-stage int8 recall@10 {recall} < 0.95")
    check(i[0, :2].tolist() == [3, 777_777], f"two-stage tie order {i[0, :2].tolist()}")
    ms = cuda_ms(lambda: cosine_topk_int8(v8, sc, full, qf, 10))
    print(f"two-stage int8 search: recall@10 vs exact fp32 {recall}, {ms:.4f} ms per "
          f"Q=256 batch, launches {launches['topk_int8_rows']}, by shape "
          f"{[(key, n) for key, n in shapes.items()]}", flush=True)
    return launches, shapes


def tower_check() -> dict:
    """Depth-2 PE-Core-L14-336, fp32: kernels on the card vs plain on CPU,
    the embeddings and the ROI region embeddings of `encode_regions`.
    Returns the card forward's kernel launches."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], depth=2,
                              dtype="float32")
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    gpu_enc = PerceptionEncoder(cfg, seed=3, device="cuda")
    cpu_enc = PerceptionEncoder(cfg, seed=3, device="cpu")
    kernels.reset_counts()
    gpu = gpu_enc.encode_image(imgs)
    launches = dict(kernels.launches)
    check(launches["flash_heads"] == launches["flash_heads_split"] == cfg.depth
          and launches["fused_mlp"] == launches["fused_mlp_split"] == cfg.depth,
          "the fp32 tower's attention and MLP did not take the split routes")
    cpu = cpu_enc.encode_image(imgs)
    err = float(np.abs(gpu - cpu).max())
    cos = float((gpu * cpu).sum(1).min())
    print(f"tower depth-2 fp32 card vs cpu: max abs err {err}, min cosine {cos}",
          flush=True)
    check(gpu.shape == (2, cfg.embed_dim) and np.isfinite(gpu).all(),
          "tower output shape/finite")
    check(err <= 1e-4 and cos >= 0.99999, "tower: card and CPU disagree")
    # ROI pooling: pixel masks (a box, scattered pixels, an empty mask) and
    # soft pooled ones, the 24 x 24 grid
    g = cfg.grid_size
    masks = np.zeros((2, 4, cfg.image_size, cfg.image_size), np.float32)
    masks[:, 0, 20:200, 50:300] = 1
    masks[:, 1] = rng.random((2, cfg.image_size, cfg.image_size)) < 0.2
    masks[:, 3, 300:, :] = 1
    pooled = rng.random((2, 3, g * g)).astype(np.float32)
    pooled *= pooled > 0.5
    for m in (masks, pooled):
        (gg, gr), (cg, cr) = gpu_enc.encode_regions(imgs, m), cpu_enc.encode_regions(imgs, m)
        err = max(float(np.abs(gg - cg).max()), float(np.abs(gr - cr).max()))
        print(f"encode_regions depth-2 fp32 card vs cpu, masks {m.shape}: max abs err {err}",
              flush=True)
        check(gr.shape == (2, m.shape[1], cfg.embed_dim) and np.isfinite(gr).all(),
              "encode_regions shape/finite")
        check(err <= 1e-4, "encode_regions: card and CPU disagree")
        check(float(np.abs(gr[:, 0] - gr[:, 1]).max()) > 1e-3, "regions pool alike")
    return launches


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
    check(launches["flash_attn"] == launches["flash_attn_split"] == cfg.depth,
          "vit 504 did not take the split mode")
    return launches


def vit_long_bf16() -> dict:
    """PE-Core-L14 at 504 px (S = 1297), bf16, full depth (24 blocks),
    B = 8, seeded random init: every block's attention takes K7 on the
    tensor cores. Held against the same weights in fp32 on the card (min
    cosine of the embeddings). Returns the bf16 forward's launches."""
    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], image_size=504)
    check(cfg.seq_len == 1297 and cfg.depth == 24 and cfg.dtype == "bfloat16",
          f"PE-L14 at 504 px: S {cfg.seq_len}, depth {cfg.depth}, {cfg.dtype}")
    imgs = np.random.default_rng(6).standard_normal((8, 504, 504, 3)).astype(np.float32)
    enc = PerceptionEncoder(cfg, seed=8, device="cuda")
    kernels.reset_counts()
    emb = enc.encode_image(imgs)
    launches = dict(kernels.launches)
    check(launches["flash_attn_tc"] == 24 and launches["flash_attn"] == 24
          and launches["flash_heads"] == 0,
          f"PE-L14 504 px bf16: attention launches {launches}")
    x = torch.from_numpy(imgs).cuda()
    with torch.inference_mode():
        fwd_ms = sync_ms(torch, lambda: enc.module(x))
    del enc
    # the fp32 reference forward: K7 on the split mode, K4 on the split GEMMs
    # at T = 8 * 1297, counted by shape
    kernels.reset_counts()
    f32 = PerceptionEncoder(dataclasses.replace(cfg, dtype="float32"), seed=8,
                            device="cuda").encode_image(imgs)
    f32_launches = dict(kernels.launches)
    f32_shapes = {key: n for key, n in kernels.shape_launches.items()
                  if key[0] == "fused_mlp_split"}
    check(f32_launches["fused_mlp_split"] == 24 and f32_launches["flash_attn_split"] == 24,
          f"PE-L14 504 px fp32: launches {f32_launches}")
    cos = (emb * f32).sum(1)
    print(f"vit 504 px (S=1297) bf16 full depth, B=8: min cosine vs fp32 {float(cos.min())}, "
          f"mean {float(cos.mean())}; forward {fwd_ms:.3f} ms; launches {launches}; the fp32 "
          f"forward's K4 by shape {[(key[1], n) for key, n in f32_shapes.items()]}", flush=True)
    check(emb.shape == (8, cfg.embed_dim) and np.isfinite(emb).all(), "vit 504 bf16 shape")
    check(float(cos.min()) >= 0.99, f"vit 504 bf16 drifts from fp32: {cos.min()}")
    return launches, f32_shapes


def vit_f32_full() -> tuple:
    """PE-Core-L14-336 in fp32 (the parity mode) at full width and depth, B
    = 8, seeded random init: every block's attention on the split mode
    with RoPE (K3 fp32) and every MLP on the split GEMMs (K4 fp32), the
    weights' parts made once by the split pass. One forward through
    `encode_image` is the path (launches by shape), then one profiled
    forward of the tower; held against the bf16 tower of the same seed
    and weights (min cosine). Returns the path's launches and shapes."""
    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], dtype="float32")
    check(cfg.seq_len == 577 and cfg.depth == 24 and cfg.width == 1024,
          f"PE-L14-336: S {cfg.seq_len}, depth {cfg.depth}, width {cfg.width}")
    imgs = np.random.default_rng(11).standard_normal((8, 336, 336, 3)).astype(np.float32)
    enc = PerceptionEncoder(cfg, seed=12, device="cuda")
    kernels.reset_counts()
    emb = enc.encode_image(imgs)
    launches = dict(kernels.launches)
    shapes = {key: n for key, n in kernels.shape_launches.items()
              if key[0] in ("fused_mlp_split", "flash_heads_split")}
    check(shapes == {("flash_heads_split", (8, 577, 1024, 16)): 24,
                     ("fused_mlp_split", (4616, 1024, 4096)): 24}
          and launches["flash_heads"] == launches["fused_mlp"] == 24
          and launches["split_parts"] == 48,
          f"PE-L14 fp32 B=8: launches {launches}, by shape {shapes}")
    check(emb.shape == (8, cfg.embed_dim) and np.isfinite(emb).all(), "PE-L14 fp32 shape")
    x = torch.from_numpy(imgs).cuda()
    with torch.inference_mode():
        prof = profiled(torch, lambda: enc.module(x))
    del enc
    bf = PerceptionEncoder(dataclasses.replace(cfg, dtype="bfloat16"), seed=12,
                           device="cuda").encode_image(imgs)
    cos = (emb * bf).sum(1)
    print(f"PE-L14-336 fp32 full depth, B=8: forward {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['busy_share']}; {json.dumps(prof)}; min cosine vs bf16 "
          f"{float(cos.min())}, mean {float(cos.mean())}; launches by shape "
          f"{[(key, n) for key, n in shapes.items()]}, split pass {launches['split_parts']}",
          flush=True)
    check(float(cos.min()) >= 0.99, f"PE-L14 fp32 drifts from bf16: {cos.min()}")
    return launches, shapes


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


def detector_parity(root: str) -> dict:
    """Depth-reduced full-width GroundingDINO and SAM, fp32, one seed each:
    the card (kernels) against the CPU (plain versions); SAM twice on the
    card, with its global layer's rel-pos bias attention on the split mode
    (fp32 operands, the 1e-3 gate) and on the default route (the tensor-core
    core, bf16 operands). Returns the split-mode run's launches."""
    import copy

    import torch
    from reverso_tpu_torch import kernels
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
        cm, ci = cpu(imgs, boxes)
        kernels.reset_counts()
        with split_relbias():
            gm, gi = gpu(imgs.cuda(), boxes.cuda())
        sp_launches = dict(kernels.launches)
        kernels.reset_counts()
        tm, ti = gpu(imgs.cuda(), boxes.cuda())
        tc_launches = dict(kernels.launches)
    check(sp_launches["flash_attn_relbias"] == sp_launches["flash_attn_relbias_split"] == 1,
          f"sam split-mode route: launches {sp_launches}")
    check(tc_launches["flash_attn_relbias"] == tc_launches["flash_attn_relbias_tc"] == 1,
          f"sam default route: launches {tc_launches}")
    scale = max(1.0, float(cm.abs().max()))
    err_m, err_i = max_err(gm.cpu(), cm), max_err(gi.cpu(), ci)
    print(f"sam 3 layers 1024 px fp32 card (split-mode rel-bias) vs cpu: mask logits max abs "
          f"err {err_m} (max |x| {float(cm.abs().max())}), iou max abs err {err_i}", flush=True)
    check(err_m <= 1e-3 * scale and err_i <= 1e-3, "sam: card and CPU disagree")
    # the default route: the global layer's products on bf16 operands (8
    # significant bits, 2^-9 relative rounding per operand), as the TPU
    # kernel computes them; the gate is 2e-2 of the logits' scale, ten
    # times a few such roundings carried through the layers after it
    tol16 = 2e-2
    err_m, err_i = max_err(tm.cpu(), cm), max_err(ti.cpu(), ci)
    agree = float(((tm.cpu() > 0) == (cm > 0)).float().mean())
    print(f"sam 3 layers 1024 px fp32 card (tensor-core rel-bias, bf16 operands) vs cpu: mask "
          f"logits max abs err {err_m}, iou max abs err {err_i} (gate {tol16} x {scale}, "
          f"{tol16}); mask pixels whose sign agrees {agree}", flush=True)
    check(err_m <= tol16 * scale and err_i <= tol16, "sam default route: card and CPU disagree")
    return sp_launches


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
    topk_shapes = {k: n for k, n in kernels.shape_launches.items() if k[0] == "topk_stream"}
    tc_shapes = {k: n for k, n in kernels.shape_launches.items()
                 if k[0] in ("flash_heads_tc", "fused_mlp_tc")}
    print(f"launches on the direct-embed path: {launches}; K1 by shape "
          f"{[(k[1], n) for k, n in topk_shapes.items()]}", flush=True)
    for name in ("flash_heads", "fused_mlp", "topk_stream", "add_layernorm"):
        check(launches[name] > 0, f"kernel {name} never launched on the direct-embed path")
    check(kernels.plain_dispatches["norm_shape"] == 0,
          "a norm site of the direct-embed path took the plain composition")
    depth = engine.encoder.cfg.depth   # K3 launches a forward: one a block
    check(launches["add_layernorm"] * depth == (2 * depth + 2) * launches["flash_heads"],
          f"add_layernorm: {launches['add_layernorm']} launches on the direct-embed path, "
          f"not {2 * depth + 2} a forward of {launches['flash_heads'] / depth:g}")
    check(launches["flash_heads_tc"] == launches["flash_heads"],
          "a bf16 attention of the direct-embed path missed the tensor-core kernel")
    check(launches["fused_mlp_tc"] == launches["fused_mlp"],
          "a bf16 MLP of the direct-embed path missed the wgmma GEMMs")

    # one B=64 forward of the tower (input already on the card), profiled
    import torch
    enc = engine.encoder
    x = torch.randn(64, enc.cfg.image_size, enc.cfg.image_size, 3,
                    generator=torch.Generator().manual_seed(9)).cuda()
    with torch.inference_mode():
        prof = profiled(torch, lambda: enc.module(x))
    print(f"profiled B=64 PE-Core-L14-336 forward: {json.dumps(prof)}", flush=True)

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
    return launches, topk_shapes, tc_shapes


def int8_slice_run(root: str) -> dict:
    """The direct-embed path with `ModelConfig.quant="int8"`: the same 256
    images, seed and weights as `slice_run`'s bf16 build, held against it."""
    from PIL import Image
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.compat import SimpleReverso
    from reverso_tpu_torch.config import StoreConfig, default_config
    from reverso_tpu_torch.engine import Reverso
    from reverso_tpu_torch.store import VectorStore

    folder = os.path.join(root, "images")
    cfg = default_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, quant="int8"),
                      store=StoreConfig(root_dir=os.path.join(root, "db_int8")))
    sr = SimpleReverso(cfg, device="cuda")
    engine = sr._engine
    check(all(blk.mlp.quant for blk in engine.encoder.module.blocks),
          "quant='int8' did not reach the tower's MLPs")
    kernels.reset_counts()
    t0 = time.perf_counter()
    transcript = sr.create_database(folder, "smoke_int8", use_direct_pe=True)
    build_s = time.perf_counter() - t0
    check("ready for searching" in transcript, f"int8 build failed:\n{transcript}")
    print(sr.load_database("smoke_int8"), flush=True)
    tie_tol = 5e-3
    for j in (0, 101):
        fname = f"img_{j:04d}.png"
        sr.process_image_direct_pe(Image.open(os.path.join(folder, fname)))
        text, items = sr.search_similar(0.0, 5)
        own = [it for it in items if it["filename"] == fname]
        check(bool(own) and own[0]["score"] >= items[0]["score"] - tie_tol,
              f"int8 {fname}: own row not at rank 0 within {tie_tol}:\n{text}")
    launches = dict(kernels.launches)
    k5_shapes = {k: n for k, n in kernels.shape_launches.items() if k[0] == "fused_mlp_int8"}
    print(f"launches on the int8 direct-embed path: {launches}; K5 by shape "
          f"{[(k[1], n) for k, n in k5_shapes.items()]}", flush=True)
    check(launches["fused_mlp_int8"] > 0, "fused_mlp_int8 never launched on the int8 path")
    check(launches["fused_mlp"] == 0, "the int8 tower launched the bf16 MLP kernel")
    for name in ("flash_heads", "topk_stream"):
        check(launches[name] > 0, f"kernel {name} never launched on the int8 path")

    def by_name(root_dir, db):
        st = VectorStore.open(root_dir, db)
        names = [p["filename"] for p in st.payloads(list(range(st.count)))]
        return np.asarray(st.vectors())[np.argsort(names)], sorted(names)

    v8, names8 = by_name(cfg.store.root_dir, "smoke_int8")
    vb, names_b = by_name(os.path.join(root, "db"), "smoke")
    check(names8 == names_b and np.isfinite(v8).all(), "int8 store rows")
    cos = (v8 * vb).sum(1)
    # each image's top-10 in its own store, the int8 build against the bf16 one
    qsel = np.arange(0, 256, 4)
    top8 = np.argsort(-(v8[qsel] @ v8.T), axis=1, kind="stable")[:, :10]
    topb = np.argsort(-(vb[qsel] @ vb.T), axis=1, kind="stable")[:, :10]
    overlap = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(top8, topb)]))
    bf16_cfg = default_config().replace(store=StoreConfig(root_dir=os.path.join(root, "db")))
    bf16_engine = Reverso(bf16_cfg, device="cuda")
    bf16_engine.load_database("smoke")
    _, ids8 = engine.search_batch(v8[qsel], 10)
    _, idsb = bf16_engine.search_batch(vb[qsel], 10)
    engine_overlap = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids8, idsb)]))
    out = dict(min_cosine_vs_bf16=float(cos.min()), mean_cosine_vs_bf16=float(cos.mean()),
               top10_overlap_vs_bf16=overlap, engine_top10_overlap_vs_bf16=engine_overlap,
               build_s=build_s, embed_img_s=engine.metrics.rate("embed"))
    print(f"int8 slice: {json.dumps(out)}", flush=True)
    check(float(cos.min()) >= 0.98, f"int8 rows drift from the bf16 build: {cos.min()}")

    # one B=64 forward of the int8 tower (input already on the card), profiled
    import torch
    enc = engine.encoder
    x = torch.randn(64, enc.cfg.image_size, enc.cfg.image_size, 3,
                    generator=torch.Generator().manual_seed(9)).cuda()
    with torch.inference_mode():
        prof = profiled(torch, lambda: enc.module(x))
    print(f"profiled B=64 PE-Core-L14-336 int8 forward: {json.dumps(prof)}", flush=True)
    return launches, k5_shapes


def f32_slice_run(root: str) -> tuple:
    """The direct-embed path in the reference's strict-parity mode:
    `SimpleReverso` with PE-Core-L14-336 at full width and depth in fp32
    (`ModelConfig.dtype="float32"`: K3 and K4 fp32 on the split routes),
    batch 8, into a float32 store (`StoreConfig(dtype="float32")`), from
    the first 64 of phase 5's synthetic images; then
    `process_image_direct_pe` + `search_similar` queries and a 64-query
    `search_batch` (K1 on fp32 rows), each held against the plain scan of
    the same matrix, and the rows against the bf16 build's of the same
    images, seed and weights (min cosine). Returns the path's launches and
    its fp32-row top-k launches by shape."""
    import torch
    from PIL import Image
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.compat import SimpleReverso
    from reverso_tpu_torch.config import StoreConfig, default_config
    from reverso_tpu_torch.ops.topk import cosine_topk_ref
    from reverso_tpu_torch.store import VectorStore

    folder = os.path.join(root, "images_f32")
    os.makedirs(folder)
    n_img = 64
    make_images(folder, n_img, seed=0)   # phase 5's first 64 images
    cfg = default_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"),
                      store=StoreConfig(root_dir=os.path.join(root, "db_f32"), dtype="float32"),
                      ingest=dataclasses.replace(cfg.ingest, batch_size=8))
    check(cfg.model.name == "PE-Core-L14-336" and cfg.model.depth == 24
          and cfg.model.width == 1024, f"parity config {cfg.model}")
    sr = SimpleReverso(cfg, device="cuda")
    engine = sr._engine
    engine.encoder   # build (seeded init) outside the counted path

    kernels.reset_counts()
    t0 = time.perf_counter()
    transcript = sr.create_database(folder, "parity", use_direct_pe=True)
    build_s = time.perf_counter() - t0
    check("ready for searching" in transcript, f"parity build failed:\n{transcript}")
    print(sr.load_database("parity"), flush=True)
    store = VectorStore.open(cfg.store.root_dir, "parity")
    vecs = np.asarray(store.vectors())
    check(vecs.shape == (n_img, 1024) and np.isfinite(vecs).all(), f"parity rows {vecs.shape}")
    matrix = engine._get_index().matrix
    check(matrix.dtype == torch.float32, f"parity store holds {matrix.dtype} rows")
    tol = 1e-5   # K1 on fp32 rows against the plain fp32 scan of the same matrix
    err = 0.0
    for j in (0, 33, 63):
        fname = f"img_{j:04d}.png"
        sr.process_image_direct_pe(Image.open(os.path.join(folder, fname)))
        text, items = sr.search_similar(-2.0, 5)
        q = torch.from_numpy(np.asarray(engine.region_embeddings[:1], np.float32)).cuda()
        rs, ri = cosine_topk_ref(matrix, q, 5)
        s = torch.tensor([[it["score"] for it in items]])
        topk_agree(rs, ri, s, torch.tensor([[it["id"] for it in items]], dtype=torch.int32), tol)
        err = max(err, max_err(s, rs.cpu()))
        check(items[0]["filename"] == fname, f"parity {fname}: own row not at rank 0:\n{text}")
    scores, ids = engine.search_batch(vecs, 5)
    rs, ri = cosine_topk_ref(matrix, torch.from_numpy(vecs).cuda(), 5)
    topk_agree(rs, ri, torch.from_numpy(scores), torch.from_numpy(ids), tol)
    err = max(err, max_err(torch.from_numpy(scores), rs.cpu()))
    check(all(r in ids[r] for r in range(n_img)), "parity search_batch: an own row is missing")
    launches = dict(kernels.launches)
    shapes = {key: c for key, c in kernels.shape_launches.items() if key[0] == "topk_stream_f32"}

    bf16 = VectorStore.open(os.path.join(root, "db"), "smoke")
    by_name = {p["filename"]: r for r, p in enumerate(bf16.payloads(list(range(bf16.count))))}
    names = [p["filename"] for p in store.payloads(list(range(store.count)))]
    vb = np.asarray(bf16.vectors())[[by_name[nm] for nm in names]]
    cos = (vecs * vb).sum(1)
    out = dict(build_s=build_s, embed_img_s=engine.metrics.rate("embed"),
               max_abs_err=err, min_cosine_vs_bf16=float(cos.min()),
               mean_cosine_vs_bf16=float(cos.mean()))
    print(f"parity slice (fp32 tower, float32 store): {json.dumps(out)}; launches "
          f"{ {key: c for key, c in launches.items() if c} }; K1 fp32 by shape "
          f"{[(key[1], c) for key, c in shapes.items()]}", flush=True)
    check(launches["topk_stream_f32"] > 0, "K1 on fp32 rows never launched on the parity path")
    check(launches["flash_heads_split"] == launches["flash_heads"] > 0
          and launches["fused_mlp_split"] == launches["fused_mlp"] > 0,
          "an fp32 attention or MLP of the parity path missed the split routes")
    check(float(cos.min()) >= 0.99, f"parity rows drift from the bf16 build: {cos.min()}")
    return launches, shapes


def k5_path_shapes(torch, shape_launches: dict) -> list:
    """K5 at each shape the int8 path ran it at: its launches there, and
    its ms and bound on seeded inputs and weights of that shape."""
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp_int8, quantize_mlp_weights

    gen = torch.Generator(device="cuda").manual_seed(21)
    out = []
    for (_, (t, w, hid, dtype)), n in sorted(shape_launches.items()):
        dt = getattr(torch, dtype.split(".")[-1])
        randn = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda")
                                           * scale).to(dt)
        qw = quantize_mlp_weights(randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.02),
                                  randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.02), dt)
        x = randn(t, w)
        out.append(dict(shape=f"T={t} W={w} H={hid} {dtype}", launches=n,
                        ms=cuda_ms(lambda: fused_mlp_int8(x, qw)),
                        bound_ms=k5_bound(t, w, hid)[0]))
    return out


def f32_path_shapes(torch, shape_launches: dict, tower_launches: dict,
                    train_shapes: dict) -> tuple:
    """K4 and K3 in fp32 at each shape their paths ran them at: the
    full-depth fp32 forward (B = 8, T = 4616), the 504 px fp32 reference
    (K4 at T = 10,376), the depth-2 parity tower (B = 2, T = 1154; its
    launches from `tower_launches`) and phase T's fp32 training run (B =
    F32_BATCH, T = F32_BATCH x 577; `train_shapes`), each timed on seeded
    inputs of that shape (K4 with its weights' parts made once, as the
    tower does); the training run's shapes under autograd, as that run
    calls them (K3's forward then also writes its log-sum-exp)."""
    from reverso_tpu_torch.ops.attention import flash_attention_heads
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp, split_mlp_weights
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    gen = torch.Generator(device="cuda").manual_seed(23)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale
    counts = collections.Counter(shape_launches)
    counts[("fused_mlp_split", (2 * 577, 1024, 4096))] += tower_launches["fused_mlp_split"]
    counts[("flash_heads_split", (2, 577, 1024, 16))] += tower_launches["flash_heads_split"]
    counts.update(train_shapes)
    mlp, heads = [], []
    for (name, shape), n in sorted(counts.items()):
        grad = (name, shape) in train_shapes
        if name == "fused_mlp_split":
            t, w, hid = shape
            w1, b1 = randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.02)
            w2, b2 = randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.02)
            parts, x = split_mlp_weights(w1, w2), randn(t, w)
            if grad:
                x, w1, b1, w2, b2 = (p.requires_grad_(True) for p in (x, w1, b1, w2, b2))
            mlp.append(dict(shape=f"T={t} W={w} H={hid} fp32{' (training)' * grad}",
                            launches=n,
                            ms=cuda_ms(lambda: fused_mlp(x, w1, b1, w2, b2, parts=parts)),
                            bound_ms=mlp_bound(t, w, hid, 4, "float32_split")[0]))
        else:
            b, s, w, h = shape
            cos, sin = (torch.from_numpy(a).cuda()
                        for a in rope_2d_tables(int(np.sqrt(s - 1)), w // h))
            q, k, v = (randn(b, s, w).requires_grad_(grad) for _ in range(3))
            heads.append(dict(shape=f"B={b} S={s} W={w} H={h} fp32 RoPE"
                                    f"{' (training: with lse)' * grad}", launches=n,
                              ms=cuda_ms(lambda: flash_attention_heads(q, k, v, heads=h,
                                                                       cos=cos, sin=sin)),
                              bound_ms=heads_bound(b, s, w, h, 4, "float32_split")[0]))
    return mlp, heads


def k8_path_shapes(torch, shape_launches: dict, inputs: dict) -> list:
    """K8 at each shape the region path ran it at, on that path's own
    inputs (the first call at each shape, captured by `captured_deform`):
    its launches there, max abs error against the plain version (1e-5 in
    fp32, as the uniform row), ms and bound."""
    from reverso_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_ref

    out = []
    for key, n in sorted(shape_launches.items(), key=lambda kv: -kv[0][1][1]):
        _, (b, lq, shapes, h, d, p, dtype) = key
        value, shp, loc, wt = inputs[key[1]]
        got = ms_deform_attn(value, shp, loc, wt)
        err = max_err(got, ms_deform_attn_ref(value, shp, loc, wt))
        tol = 1e-5 if dtype == "torch.float32" else 2e-2
        check(err <= tol, f"ms_deform on the path's inputs B={b} Lq={lq}: max abs err {err}")
        lv = value.shape[1]
        out.append(dict(shape=f"B={b} Lq={lq} Lv={lv} levels {list(shapes)} H={h} D={d} "
                              f"P={p} {dtype} (the model's locations)",
                        launches=n, max_abs_err=err,
                        ms=cuda_ms(lambda: ms_deform_attn(value, shp, loc, wt)),
                        bound_ms=k8_bound(b, lv, lq, h, d, len(shp), p,
                                          value.element_size())[0]))
    return out


def topk_bound(kind: str, q: int, n: int, d: int, k: int, masked: bool) -> tuple[float, str]:
    """A top-k scan's least time: the rows (bf16, fp32, int8 or packed
    signs), the mask, the queries (bf16; fp32; int8's two digits) and the
    [Q, k] results once; 2 Q N d operations (bf16: binary's +-1 rows too;
    fp32 at the split rate; int8 twice, one per query digit); K12: its int8
    rows, row scales, one digit and query scales, 2 Q N d int8 operations."""
    if kind == "topk_stream_f32":
        return bound(n * d * 4 + (n if masked else 0) + q * d * 4 + q * k * 8, 2 * q * n * d,
                     "float32_split")
    if kind == "topk_int8_rows":
        return bound(n * d + n * 4 + q * d + q * 4 + q * k * 8, 2 * q * n * d, "int8")
    if kind == "topk_int8":
        return bound(n * d + (n if masked else 0) + 2 * q * d + q * k * 8, 2 * 2 * q * n * d,
                     "int8")
    rows = n * d // 8 if kind == "topk_binary" else n * d * 2
    return bound(rows + (n if masked else 0) + q * d * 2 + q * k * 8, 2 * q * n * d, "bfloat16")


def topk_path_shapes(torch, shape_launches: dict) -> dict:
    """K1, K2 (bf16 and fp32 rows), K9, K10 and K12 at each shape (Q, N, d,
    k, masked) a path ran them at: seeded unit rows of that shape (the mask
    keeps 10% of the rows, as the capacity path's `{"folder": 3}` filter),
    held against the plain version (1e-4 bf16, 1e-5 fp32, 2e-4 binary, bit
    for bit int8), timed by CUDA events, with the launches and bound.
    Returns {counter: [...]} ("topk_stream_f32": K1 and K2 on fp32 rows)."""
    from reverso_tpu_torch.ops.binary import binary_topk, binary_topk_ref, pack_signs
    from reverso_tpu_torch.ops.topk import (cosine_topk, cosine_topk_int8_exact,
                                            cosine_topk_int8_ref, cosine_topk_ref,
                                            quantize_db_int8)
    from reverso_tpu_torch.ops.topk_int8 import (quantize_queries, quantize_rows,
                                                 topk_int8_rows, topk_int8_rows_ref)

    seed = 31
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    data = {}
    for nth, ((kind, (q, n, d, k, masked)), launches) in enumerate(
            sorted(shape_launches.items())):
        # the generator's state at this shape: `seed`, drawn on through the
        # shapes before it in this order
        at = f"{seed}, shape {nth} in sorted order"
        if (n, d) not in data:
            data.clear()
            x = torch.randn(n, d, generator=gen, device="cuda")
            x /= x.norm(dim=1, keepdim=True)
            data[(n, d)] = x
        x = data[(n, d)]
        qs = x[torch.arange(q, device="cuda") * max(1, n // q)].clone()
        qs += 0.05 * torch.randn(qs.shape, generator=gen, device="cuda")
        qs /= qs.norm(dim=1, keepdim=True)
        mask = (torch.arange(n, device="cuda") % 10 == 3) if masked else None
        if kind == "topk_int8":
            v8, sc = quantize_db_int8(x)
            call = lambda: cosine_topk_int8_exact(v8, sc, qs, k, row_mask=mask)
            s, i = call()
            rs, ri = cosine_topk_int8_ref(v8, sc, qs, k, row_mask=mask)
            check(torch.equal(i, ri) and torch.equal(s, rs),
                  f"K9 at {(q, n, d, k)} differs (seed {at})")
            err = 0.0
        elif kind == "topk_int8_rows":
            r8, rsc = quantize_rows(x)
            q8, qsc = quantize_queries(qs)
            call = lambda: topk_int8_rows(r8, rsc, q8, qsc, k)
            s, i = call()
            rs, ri = topk_int8_rows_ref(r8, rsc, q8, qsc, k)
            check(torch.equal(i, ri) and torch.equal(s, rs),
                  f"K12 at {(q, n, d, k)} differs (seed {at})")
            err = 0.0
        elif kind == "topk_binary":
            packed = torch.cat([pack_signs(x[lo:lo + 65536]) for lo in range(0, n, 65536)])
            call = lambda: binary_topk(packed, qs, k, d, row_mask=mask)
            s, i = call()
            rs, ri = binary_topk_ref(packed, qs, k, d, row_mask=mask)
            topk_agree(rs, ri, s, i, 2e-4, f"{kind} at {(q, n, d, k, masked)}", at)
        else:
            f32 = kind == "topk_stream_f32"
            db, qb = (x, qs) if f32 else (x.to(torch.bfloat16), qs.to(torch.bfloat16))
            call = lambda: cosine_topk(db, qb, k, row_mask=mask)
            s, i = call()
            rs, ri = cosine_topk_ref(db, qb, k, row_mask=mask)
            topk_agree(rs, ri, s, i, 1e-5 if f32 else 1e-4, f"{kind} at {(q, n, d, k, masked)}",
                       at)
        if kind not in ("topk_int8", "topk_int8_rows"):
            fin = torch.isfinite(rs)
            err = float((torch.where(fin, s, 0) - torch.where(fin, rs, 0)).abs().max())
        out.setdefault(kind, []).append(dict(
            shape=f"Q={q} N={n} d={d} k={k}{' masked (10% kept)' if masked else ''}",
            launches=launches, max_abs_err=err, ms=cuda_ms(call, iters=10),
            bound_ms=topk_bound(kind, q, n, d, k, masked)[0]))
        del s, i, rs, ri
    data.clear()
    return out


def copy_soak(torch, iters: int) -> int:
    """`python3 chip_smoke.py --copy-soak [ITERS]`: K1 and K2 at d = 1025 on
    bf16 and fp32 rows (no 16-byte row: the kernel's producer copies the
    rows) and on the same values zero-padded to 1032 / 1028 (TMA), over
    1,000,000 seeded unit rows, Q = 64 and 256, k = 10, unmasked and with
    10% of the rows kept, for three seeds (the rows and queries made as
    `topk_path_shapes` makes them): `iters` launches of each form back to
    back, each held against the plain scan (`topk_agree`: 1e-4 bf16, 1e-5
    fp32) and bit for bit against the first launch of its form. Prints one
    JSON line of launches and mismatches by form; returns 1 if any launch
    disagreed."""
    import torch.nn.functional as F
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref

    n, d, k = 1_000_000, 1025, 10
    out = {}
    for seed in (31, 32, 33):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, d, generator=gen, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        for dtype, pitch, tol in ((torch.bfloat16, 1032, 1e-4), (torch.float32, 1028, 1e-5)):
            db = x.to(dtype)
            padded = F.pad(db, (0, pitch - d))
            for qn in (64, 256):
                qs = x[torch.arange(qn, device="cuda") * (n // qn)].clone()
                qs += 0.05 * torch.randn(qs.shape, generator=gen, device="cuda")
                qs /= qs.norm(dim=1, keepdim=True)
                for masked in (False, True):
                    mask = (torch.arange(n, device="cuda") % 10 == 3) if masked else None
                    rs, ri = cosine_topk_ref(db, qs, k, row_mask=mask)
                    for form, mat, qq in (("copy", db, qs), ("tma", padded, F.pad(qs, (0, pitch - d)))):
                        runs = [cosine_topk(mat, qq, k, row_mask=mask) for _ in range(iters)]
                        torch.cuda.synchronize()
                        key = f"{form} {str(dtype)[6:]} Q={qn}{' masked' if masked else ''}"
                        row = out.setdefault(key, dict(launches=0, vs_plain=0, vs_first=0))
                        for s, i in runs:
                            row["launches"] += 1
                            try:
                                topk_agree(rs, ri, s, i, tol, f"{key} seed {seed}")
                            except AssertionError as e:
                                row["vs_plain"] += 1
                                print(f"copy soak: {e}", flush=True)
                            row["vs_first"] += int(not (torch.equal(s, runs[0][0])
                                                        and torch.equal(i, runs[0][1])))
                        del runs
            del db, padded
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"copy_soak": out}), flush=True)
    return int(any(r["vs_plain"] or r["vs_first"] for r in out.values()))


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


# rows the redesign order lists apart: kernels a PR already redesigned
# (by PR); rows whose library call computes another function are not held
# against that call, only ranked by their cost
REDESIGNED = {"flash_heads": 5, "flash_attn": 5, "flash_attn_relbias": 6, "fused_mlp": 6,
              "fused_mlp_int8": 7, "ms_deform": 7, "topk_stream": 8, "topk_masked": 8,
              "topk_binary": 8, "topk_int8": 9, "topk_int8_rows": 9, "flash_attn_f32": 10,
              "flash_attn_relbias_f32": 10, "fused_mlp_f32": 11, "flash_heads_f32": 11,
              "topk_stream_f32": 12, "ivf_scan": 15, "flash_heads_bwd": 18,
              "fused_mlp_bwd": 18, "flash_heads_bwd_f32": 20, "fused_mlp_bwd_f32": 20}
OTHER_FUNCTION = {"flash_heads": "library call without RoPE",
                  "flash_heads_f32": "library call without RoPE",
                  "flash_heads_bwd": "library call without RoPE",
                  "flash_heads_bwd_f32": "library call without RoPE"}


def sync_ms(torch, fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# kernel_times: captured device time over the call's; profiled: the capture's span over
# the call's
KERNEL_SUM_RANGE = (0.8, 1.1)
# kernel-name patterns of device time, in match order
KERNEL_GROUPS = (("flash_heads_bwd (K3 backward)", "hbwd"),
                 ("fused_mlp_bwd (K4 backward)", "mbwd"),
                 ("ms_deform (K8)", "ms_deform"),
                 ("flash_tc (K3/K6/K7, tensor cores: bf16 and split mode)", "flash_tc"),
                 ("fused_mlp_wgmma (K4, tensor cores)", "fused_mlp_wgmma"),
                 ("fused_mlp_split (K4 fp32, split GEMMs)", "fused_mlp_split"),
                 ("split_parts (K4 fp32: the split pass)", "split_parts"),
                 ("fused_mlp_int8 (K5: q8 quantizer, GEMMs)", "mlp_q8"),
                 ("topk (K1, K2, K9-K12)", "topk"), ("convolution", "conv"),
                 ("matmul", "gemm"), ("matmul", "cutlass"), ("matmul", "nvjet"),
                 ("matmul", "Kernel2"))


def profiled(torch, fn) -> dict:
    """One profiled call of `fn` (after a warm-up call): device busy share
    of the host wall, device time by kernel group and each group's share
    of the device time. The capture is held as `kernel_times` holds its
    own: the span of the captured device events (the first one's start to
    the last one's end) must lie within KERNEL_SUM_RANGE of the call's span
    by CUDA events recorded around it, or the busy share and the times are
    None, with the reason under `capture_check` (a session that lost
    events, all of them or at either end, reads short). The sum of kernel
    times cannot be held against the call here: the call's idle gaps are
    what the busy share measures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    call_ms = start.elapsed_time(stop)
    groups: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.lower()
        group = next((g for g, pat in KERNEL_GROUPS if pat.lower() in name), "other")
        groups[group] = groups.get(group, 0.0) + ev.time_range.elapsed_us() / 1e3
    extent_ms = (max(e for _, e in spans) - min(b for b, _ in spans)) / 1e3 if spans else 0.0
    ratio = extent_ms / call_ms
    lo, hi = KERNEL_SUM_RANGE
    capture = dict(extent_ms=extent_ms, call_ms=call_ms, ratio=ratio, reason=None)
    if not lo <= ratio <= hi:
        capture["reason"] = (f"the captured device events span {extent_ms:.3f} ms against the "
                             f"call's {call_ms:.3f} ms by CUDA events ({ratio:.3f}x, outside "
                             f"{lo}-{hi}x): a partial capture, not printed as measured")
        return dict(wall_ms=wall_ms, device_busy_ms=None, busy_share=None, kernel_ms=None,
                    kernel_share=None, capture_check=capture)
    busy, end = 0.0, float("-inf")
    for b, e in sorted(spans):          # union of device intervals
        busy += max(0.0, e - max(b, end))
        end = max(end, e)
    busy_ms = busy / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
                kernel_ms={k: round(v, 3) for k, v in sorted(groups.items())},
                kernel_share={k: round(v / busy_ms, 4) for k, v in sorted(groups.items())},
                capture_check=capture)


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
    # K8's inputs at each shape the path runs it at (a copy of the first
    # call's, a few per build)
    deform_inputs: dict = {}
    capturing = captured_deform(deform_inputs)
    capturing.__enter__()
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
    k8_shapes = {k: n for k, n in kernels.shape_launches.items() if k[0] == "ms_deform"}
    capturing.__exit__(None, None, None)
    print(f"launches on the region path: {launches}; K8 by shape "
          f"{[(k[1], n) for k, n in k8_shapes.items()]}", flush=True)
    for name in ("ms_deform", "flash_attn_relbias", "flash_heads", "fused_mlp",
                 "topk_stream"):
        check(launches[name] > 0, f"kernel {name} never launched on the region path")
    check(launches["flash_attn_relbias_tc"] == launches["flash_attn_relbias"],
          "a SAM global layer missed the tensor-core core")

    # 8 photos' detections on the default route (SAM's global layers on
    # the bf16 core, bf16 operands) against the split mode (fp32 operands):
    # DINO's boxes are the same, SAM's masks agree pixel by pixel (random-
    # init mask logits hover near zero, so some signs flip)
    prompts = ["person", "car", "building"]
    imgs8 = [np.asarray(Image.open(os.path.join(folder, f"photo_{j:03d}.png")))
             for j in range(8)]
    on_tc = det.detect_batch(imgs8, prompts)
    with split_relbias():
        on_cc = det.detect_batch(imgs8, prompts)
    check(all(np.array_equal(a.boxes, c.boxes) for a, c in zip(on_tc, on_cc)),
          "the two routes gave different boxes")
    same = sum(int((a.masks == c.masks).sum()) for a, c in zip(on_tc, on_cc))
    total = sum(a.masks.size for a in on_tc)
    mask_agreement = same / total
    print(f"region masks, bf16-operand vs split-mode rel-bias route on 8 photos: boxes equal, "
          f"{mask_agreement} of {total} mask pixels agree", flush=True)

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
    prof = profiled(torch, lambda: det.detect_batch(imgs, ["person", "car", "building"]))
    print(f"profiled detect_batch of 4 images: {json.dumps(prof)}", flush=True)
    m = engine.metrics
    out = dict(build_s=build_s, detect_img_s=m.rate("detect"), embed_img_s=m.rate("embed"),
               detect_s=m.seconds.get("detect", 0.0), embed_s=m.seconds.get("embed", 0.0),
               append_s=m.seconds.get("append", 0.0),
               dino_batch4_ms=dino_ms, sam_batch4_8boxes_ms=sam_ms, rows=int(vecs.shape[0]),
               mask_agreement_vs_split=mask_agreement)
    print(f"region slice: {json.dumps(out)}", flush=True)
    return launches, det, k8_shapes, deform_inputs


def roi_run(root: str, det) -> dict:
    """ROI pooling at full width: `region_embed_mode="region"` over the same
    32 photos and seeded detector as `region_run`."""
    from PIL import Image
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.compat import SimpleReverso
    from reverso_tpu_torch.config import StoreConfig, default_config
    from reverso_tpu_torch.store import VectorStore

    folder = os.path.join(root, "photos")
    n_img, max_regions = 32, det.cfg.max_regions
    cfg = default_config()
    cfg = cfg.replace(store=StoreConfig(root_dir=os.path.join(root, "roi_db")),
                      detector=det.cfg,
                      ingest=dataclasses.replace(cfg.ingest, region_embed_mode="region"))
    sr = SimpleReverso(cfg, detector=det, device="cuda")
    engine = sr._engine
    engine.encoder
    kernels.reset_counts()
    t0 = time.perf_counter()
    transcript = sr.create_database(folder, "roi", text_prompt="person . car . building")
    build_s = time.perf_counter() - t0
    check("ready for searching" in transcript, f"ROI build failed:\n{transcript}")
    print(sr.load_database("roi"), flush=True)
    store = VectorStore.open(cfg.store.root_dir, "roi")
    vecs = np.asarray(store.vectors())
    check(vecs.shape == (n_img * max_regions, cfg.model.embed_dim) and np.isfinite(vecs).all(),
          f"stored ROI vectors {vecs.shape}")
    check(np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3),
          "stored ROI vectors are not unit norm")
    names = [p["filename"] for p in store.payloads(list(range(store.count)))]
    distinct = {nm: len({tuple(np.round(v, 4)) for v, m in zip(vecs, names) if m == nm})
                for nm in set(names)}
    tie_tol = 5e-3
    per_query = []
    for j in (0, 5, 18, 31):
        fname = f"photo_{j:03d}.png"
        img = Image.open(os.path.join(folder, fname))
        n = sr.detect_regions(img, "person . car . building")
        embs, metas = sr.extract_embeddings(img)
        check(len(embs) == n == max_regions, f"{fname}: {len(embs)} ROI embeddings")
        e = np.stack(embs)
        per_query.append(len({tuple(np.round(v, 4)) for v in e}))
        text, items = sr.search_similar(0.0, max_regions)
        own = [it for it in items if it["filename"] == fname]
        check(bool(own) and own[0]["score"] >= items[0]["score"] - tie_tol,
              f"ROI {fname}: own rows not at rank 0 within {tie_tol}:\n{text}")
    # The PE pool attends over a mask's support (patch cells with any mask
    # pixel), so regions whose masks touch the same cells pool alike; this
    # random-init SAM's masks may touch every cell. The same ROI query with
    # eight horizontal bands as the masks: one embedding per distinct support.
    regions = engine.detected_regions
    cover = [float(np.mean(m)) for m in regions.masks]
    bands = np.zeros_like(regions.masks)
    h = bands.shape[1]
    for r in range(len(bands)):
        bands[r, r * h // len(bands):(r + 1) * h // len(bands)] = True
    engine.detected_regions = dataclasses.replace(regions, masks=bands)
    e = np.stack(sr.extract_embeddings(img)[0])
    supports = len({tuple(r) for r in engine.encoder.pool_masks([bands], max_regions)[0] > 0})
    distinct_embs = len({tuple(np.round(v, 4)) for v in e})
    launches = dict(kernels.launches)
    print(f"launches on the ROI path: {launches}", flush=True)
    for name in ("ms_deform", "flash_attn_relbias", "flash_heads", "fused_mlp", "topk_stream"):
        check(launches[name] > 0, f"kernel {name} never launched on the ROI path")
    check(launches["flash_attn_relbias_tc"] == launches["flash_attn_relbias"]
          and launches["fused_mlp_tc"] == launches["fused_mlp"],
          "the ROI path missed a tensor-core kernel")
    out = dict(build_s=build_s, rows=int(vecs.shape[0]),
               distinct_rows_per_image_min=min(distinct.values()),
               distinct_rows_per_image_max=max(distinct.values()),
               distinct_query_regions=per_query, last_query_mask_cover=cover,
               band_mask_supports=supports, band_mask_distinct_embeddings=distinct_embs,
               roi_embed_img_s=engine.metrics.rate("roi_embed"))
    print(f"roi slice: {json.dumps(out)}", flush=True)
    check(distinct_embs == supports >= 2, "distinct regions gave one embedding")
    return launches


def ivf_layout(torch, gen, n: int, n_cl: int, q: int, nprobe: int):
    """A random compact IVF layout of n rows in n_cl clusters and, per
    query, nprobe distinct probed clusters: (offsets, counts, base, cnt)."""
    counts = torch.bincount(torch.randint(0, n_cl, (n,), generator=gen, device="cuda"),
                            minlength=n_cl)
    offsets = torch.cumsum(counts, 0) - counts
    probes = torch.stack([torch.randperm(n_cl, generator=gen, device="cuda")[:nprobe]
                          for _ in range(q)])
    return offsets, counts, offsets[probes].int().contiguous(), counts[probes].int().contiguous()


def ivf_bound(torch, base, cnt, d: int, itemsize: int, digits: int, dtype: str):
    """K11's bound from this run's probes: the rows of the distinct probed
    clusters read once and the queries (two bytes a dimension: bf16, or
    int8's two digits; fp32 four), 2 * d operations per probed row (per
    digit)."""
    pairs = torch.stack([base.reshape(-1), cnt.reshape(-1)], 1).unique(dim=0)
    nbytes = float(pairs[:, 1].sum()) * d * itemsize + base.shape[0] * d * max(itemsize, 2)
    ops = 2.0 * digits * float(cnt.sum()) * d
    return bound(nbytes, ops, dtype) + (nbytes, ops)


@contextlib.contextmanager
def ivf_inputs(captured: dict):
    """Inside the block, keep the inputs of the first K11 launch at each
    `kernels.shape_launches` key that the IVF index makes (its call of
    `ivf_probe_scan` in `store/ivf.py`), to time and check each shape a
    path ran on that path's own inputs."""
    import reverso_tpu_torch.store.ivf as ivf_mod
    from reverso_tpu_torch.ops.ivf_scan import launch_key
    real = ivf_mod.ivf_probe_scan

    def capture(mat, queries, qdig, row_scale, base, cnt, **kw):
        key = launch_key(mat, base, k=kw["k"], int8=kw["int8"],
                         masked=kw.get("mask_sorted") is not None)
        captured.setdefault(key, (mat, queries, qdig, row_scale, base, cnt, kw))
        return real(mat, queries, qdig, row_scale, base, cnt, **kw)

    ivf_mod.ivf_probe_scan = capture
    try:
        yield captured
    finally:
        ivf_mod.ivf_probe_scan = real


def ivf_path_shapes(torch, counts: dict, captured: dict, path: str) -> list:
    """K11's `by_shape` entries for one path: each (Q, nprobe, d, k,
    masked, mode) it ran, with the launches the path made there (`counts`,
    read before this launches anything), held against
    `ivf_probe_scan_ref` on the captured inputs (int8 bit for bit, bf16
    and fp32 within 1e-4) and timed on them."""
    from reverso_tpu_torch.ops.ivf_scan import ivf_probe_scan, ivf_probe_scan_ref
    check(set(counts) == set(captured),
          f"K11 shapes {sorted(counts)} but inputs captured at {sorted(captured)}")
    out = []
    for key in sorted(captured):
        mat, qq, qdig, row_scale, base, cnt, kw = captured[key]
        qn, nprobe, d, k, masked, mode = key[1]
        fn = lambda: ivf_probe_scan(mat, qq, qdig, row_scale, base, cnt, **kw)
        s, pos = fn()
        rs, rpos = ivf_probe_scan_ref(mat, qq, qdig, row_scale, base, cnt, **kw)
        if mode == "int8":
            torch.cuda.synchronize()
            check(torch.equal(pos, rpos) and torch.equal(s, rs),
                  f"K11 at {key} differs from its plain version")
        else:
            topk_agree(rs, rpos, s, pos, 1e-4, f"K11 at {key}")
        fin = torch.isfinite(rs)
        b_ms, b_by = ivf_bound(torch, base, cnt, d, mat.element_size(),
                               2 if mode == "int8" else 1, mode)[:2]
        out.append(dict(
            shape=f"Q={qn} nprobe={nprobe} d={d} k={k} {mode}{' masked' if masked else ''} "
                  f"({path} path)",
            launches=counts[key],
            max_abs_err=float((torch.where(fin, s, 0) - torch.where(fin, rs, 0)).abs().max()),
            ms=cuda_ms(fn, iters=10), bound_ms=b_ms, bound_by=b_by))
        del s, pos, rs, rpos
    return out


def ivf_search_parts(torch, ivf, queries, k: int, nprobe: int, row_mask, reps: int = 5) -> dict:
    """`IVFIndex.search`'s host time by part at one batch, each part ended
    by a synchronise (medians of `reps` runs, ms): the centroid probe (the
    queries to the card, centroid scores and top-nprobe, the probed
    clusters' rows and counts, int8's digits), `_sorted_mask`, the plan
    and K11 (`ivf_probe_scan`), the id map and spill dedup. The steps are
    the search's own, in its order; their result must equal `search`'s."""
    import reverso_tpu_torch.store.ivf as ivf_mod
    from reverso_tpu_torch.ops.topk import int8_query_digits

    parts = collections.defaultdict(list)

    def once():
        t = [time.perf_counter()]

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            parts[name].append((now - t[0]) * 1e3)
            t[0] = now

        probes = min(nprobe, ivf.n_clusters)
        q32 = torch.as_tensor(np.asarray(queries, np.float32)).to(ivf.device)
        q = q32.to(ivf._dtype)
        _, top_c = ivf_mod._select_topk(ivf_mod._scores(q, ivf.centroids), probes)
        base, cnt = ivf.offsets[top_c], ivf.counts[top_c]
        qdig = row_scale = None
        if ivf._int8:
            q_hi, q_lo, c2 = int8_query_digits(q32)
            qdig = torch.stack([q_hi, q_lo])
            row_scale = c2 * torch.tensor(ivf.db_scale, dtype=torch.float32, device=ivf.device)
        lap("centroid_probe")
        mask = ivf._sorted_mask(row_mask) if row_mask is not None else None
        lap("sorted_mask")
        dedup = ivf.n_spill > 0
        k_eff = min(k, probes * ivf.cmax)
        k_fetch = min(2 * k, probes * ivf.cmax) if dedup else k_eff
        sc, pos = ivf_mod.ivf_probe_scan(ivf.matrix, q, qdig, row_scale, base, cnt, k=k_fetch,
                                         cmax=ivf.cmax, int8=ivf._int8, mask_sorted=mask)
        lap("plan_k11")
        pos = pos[:, :k_fetch].long()
        ids = torch.where(pos >= 0, ivf.row_ids[pos.clamp(min=0)], -1)
        ids = torch.where(torch.isneginf(sc[:, :k_fetch]), -1, ids)
        sc = sc[:, :k_fetch]
        if dedup:
            sc, ids = ivf_mod._dedup_keep_first(sc, ids)
            sc, sel = ivf_mod._select_topk(sc, k_eff)
            ids = ids.gather(1, sel)
        lap("id_map_dedup")
        return sc, ids

    once()
    parts.clear()
    for _ in range(reps):
        sc, ids = once()
    rs, ri = ivf.search(queries, k, nprobe=nprobe, row_mask=row_mask)
    check(torch.equal(ids.to(torch.int32), ri[:, :ids.shape[1]]) and
          torch.equal(sc, rs[:, :sc.shape[1]]), "the timed parts differ from IVFIndex.search")
    out = {name: float(np.median(v)) for name, v in parts.items()}
    out["sum"] = sum(out.values())
    return out


def capacity_kernel_checks(torch, gen) -> dict:
    """K2, K9, K10 at 1M x 1024 (Q = 256) and K11 at 1024 clusters, nprobe
    16, Q = 1 and 64, bf16, int8 and fp32, against their plain versions on
    the card, K11 over every cluster at Q = 64 against K1 over the same
    rows, plus small ragged cases."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.binary import binary_topk, binary_topk_ref, pack_signs
    from reverso_tpu_torch.ops.ivf_scan import (check_plan, ivf_geometry, ivf_plan_cuda,
                                                ivf_probe_scan, ivf_probe_scan_ref)
    from reverso_tpu_torch.ops.topk import (cosine_topk, cosine_topk_int8_exact,
                                            cosine_topk_int8_ref, cosine_topk_ref,
                                            int8_query_digits, quantize_db_int8)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}
    n, d, q, k = 1_000_000, 1024, 256, 10
    x = torch.randn(n, d, generator=gen, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    x[777_777] = x[3]                                       # a tie: lower row first
    qf = x[torch.arange(q, device=dev) * 3001].clone()
    qf += 0.05 * torch.randn(qf.shape, generator=gen, device=dev)
    qf /= qf.norm(dim=1, keepdim=True)
    qf[0] = x[3]
    mask = torch.rand(n, generator=gen, device=dev) >= 0.3  # 30% of the rows masked
    mask[3] = mask[777_777] = True

    # K2: masked bf16 scan
    db, qs = x.to(bf16), qf.to(bf16)
    tol = 1e-4   # fp32 sums of exact bf16 products, in another order
    s, i = cosine_topk(db, qs, k, row_mask=mask)
    rs, ri = cosine_topk_ref(db, qs, k, row_mask=mask)
    topk_agree(rs, ri, s, i, tol)
    check(bool(mask[i.long()].all()), "K2 returned a masked row")
    check(i[0, :2].tolist() == [3, 777_777], f"K2 tie order {i[0, :2].tolist()}")
    err = float((s - rs).abs().max())
    small = db[:1000].clone()
    none = torch.zeros(1000, dtype=torch.bool, device=dev)
    s2, i2 = cosine_topk(small, qs[:5], 20, row_mask=none)
    check(bool((i2 == -1).all()) and bool(torch.isneginf(s2).all()),
          "K2: every row masked must give (-inf, -1)")
    some = none.clone()
    some[[3, 500, 999]] = True
    s2, i2 = cosine_topk(small, qs[:5], 20, n_valid=999, row_mask=some)
    r2s, r2i = cosine_topk_ref(small, qs[:5], 20, n_valid=999, row_mask=some)
    topk_agree(r2s, r2i, s2, i2, tol)
    check(bool((i2[:, 2:] == -1).all()), "K2: k > kept rows must pad with -1")
    rows["topk_masked"] = dict(
        source="reverso_tpu_torch/csrc/topk_stream.cu",
        replaces="reverso_tpu/ops/topk.py:458",
        max_abs_err=err, shape="N=1,000,000 d=1024 Q=256 k=10 bf16, 30% of rows masked",
        ms=cuda_ms(lambda: cosine_topk(db, qs, k, row_mask=mask)),
        plain_ms=cuda_ms(lambda: cosine_topk_ref(db, qs, k, row_mask=mask), iters=3),
        library="none: no single PyTorch call (a matmul, a masked fill and a topk)",
        library_ms=None)
    rows["topk_masked"]["bound_ms"], rows["topk_masked"]["bound_by"] = bound(
        n * d * 2 + n + q * d * 2 + q * k * 8, 2 * q * n * d, "bfloat16")
    print(f"topk_masked: max abs score err {err} (tol {tol})", flush=True)
    del db

    # K9: int8 rows, ids and scores equal to the plain version's bit for bit
    v8, scale = quantize_db_int8(x)
    for m in (None, mask):
        s, i = cosine_topk_int8_exact(v8, scale, qf, k, row_mask=m)
        rs, ri = cosine_topk_int8_ref(v8, scale, qf, k, row_mask=m)
        torch.cuda.synchronize()
        check(torch.equal(i, ri) and torch.equal(s, rs),
              f"K9 (mask {m is not None}) differs from its plain version: ids "
              f"{int((i != ri).sum())}, max score diff {float((s - rs).abs().max())}")
    check(i[0, :2].tolist() == [3, 777_777], f"K9 tie order {i[0, :2].tolist()}")
    for nv, kk, qn in ((30, 40, 70), (999, 128, 65), (1001, 10, 3)):   # k > n_valid; ragged
        s2, i2 = cosine_topk_int8_exact(v8[:1001], scale, qf[:qn], kk, n_valid=nv)
        r2s, r2i = cosine_topk_int8_ref(v8[:1001], scale, qf[:qn], kk, n_valid=nv)
        check(torch.equal(i2, r2i) and torch.equal(s2, r2s),
              f"K9 ragged case n_valid={nv} k={kk} Q={qn} differs")
    rows["topk_int8"] = dict(
        source="reverso_tpu_torch/csrc/topk_stream.cu",
        replaces="reverso_tpu/ops/topk.py:420",
        max_abs_err=0.0, shape="N=1,000,000 d=1024 Q=256 k=10 int8 (two query digits)",
        ms=cuda_ms(lambda: cosine_topk_int8_exact(v8, scale, qf, k)),
        plain_ms=cuda_ms(lambda: cosine_topk_int8_ref(v8, scale, qf, k), iters=3),
        library="none: no single PyTorch call (int8 products need two matmuls)",
        library_ms=None)
    rows["topk_int8"]["bound_ms"], rows["topk_int8"]["bound_by"] = bound(
        n * d + 2 * q * d + q * k * 8, 2 * 2 * q * n * d, "int8")
    print("topk_int8: ids and scores equal the plain version's bit for bit", flush=True)
    del v8

    # K10: packed signs (128 MB), k_fetch = 30
    center = x.mean(0)
    packed = torch.cat([pack_signs(x[lo:lo + 65536] - center) for lo in range(0, n, 65536)])
    kf = 30
    btol = 2e-4   # fp32 sums of 1024 exact +-bf16(q_i) terms in another order
    s, i = binary_topk(packed, qf, kf, d, row_mask=mask)
    rs, ri = binary_topk_ref(packed, qf, kf, d, row_mask=mask)
    topk_agree(rs, ri, s, i, btol)
    s, i = binary_topk(packed, qf, kf, d)
    rs, ri = binary_topk_ref(packed, qf, kf, d)
    topk_agree(rs, ri, s, i, btol)
    err = float((s - rs).abs().max())
    s2, i2 = binary_topk(packed[:1000], qf[:3], 20, d, row_mask=none)
    check(bool((i2 == -1).all()), "K10: every row masked must give -1")
    rows["topk_binary"] = dict(
        source="reverso_tpu_torch/csrc/topk_stream.cu",
        replaces="reverso_tpu/ops/topk.py:399",
        max_abs_err=err, shape="N=1,000,000 x 128 B packed (d=1024) Q=256 k=30",
        ms=cuda_ms(lambda: binary_topk(packed, qf, kf, d)),
        plain_ms=cuda_ms(lambda: binary_topk_ref(packed, qf, kf, d), iters=2),
        library="none: no single PyTorch call (unpack, a matmul and a topk)",
        library_ms=None)
    rows["topk_binary"]["bound_ms"], rows["topk_binary"]["bound_by"] = bound(
        n * d // 8 + q * d * 2 + q * kf * 8, 2 * q * n * d, "bfloat16")
    print(f"topk_binary: max abs score err {err} (tol {btol})", flush=True)
    del packed

    # K11: 1024 clusters, nprobe 16, bf16, int8 and fp32 (x itself, the
    # split mode at full width); the plan kernel's table at full size
    n_cl, nprobe = 1024, 16
    offsets, counts, base, cnt = ivf_layout(torch, gen, n, n_cl, 64, nprobe)
    cmax = int(counts.max())
    sorted_bf16 = x.to(bf16)
    v8, scale = quantize_db_int8(x)
    ivf = {}
    for qn in (1, 64):
        qq = qf[:qn]
        q_hi, q_lo, c2 = int8_query_digits(qq)
        qdig, rsc = torch.stack([q_hi, q_lo]), c2 * scale
        for mode, args in (("bf16", (sorted_bf16, qq.to(bf16), None, None)),
                           ("int8", (v8, qq, qdig, rsc)), ("fp32", (x, qq, None, None))):
            kw = dict(k=k, cmax=cmax, int8=mode == "int8")
            fn = lambda a=args, b=base[:qn], c=cnt[:qn]: ivf_probe_scan(*a, b, c, **kw)
            s, pos = fn()
            rs, rpos = ivf_probe_scan_ref(*args, base[:qn], cnt[:qn], **kw)
            if mode == "int8":
                check(torch.equal(pos, rpos) and torch.equal(s, rs),
                      f"K11 int8 Q={qn} differs from its plain version")
            else:
                topk_agree(rs, rpos, s, pos, tol, f"K11 {mode} Q={qn}")
            item = {"bf16": 2, "int8": 1, "fp32": 4}[mode]
            b_ms, b_by, nbytes, ops = ivf_bound(
                torch, base[:qn], cnt[:qn], d, item, 2 if mode == "int8" else 1,
                {"bf16": "bfloat16", "int8": "int8", "fp32": "float32_split"}[mode])
            ivf[(mode, qn)] = dict(
                ms=cuda_ms(fn, iters=10), err=float((s - rs).abs().max()),
                plain_ms=cuda_ms(lambda a=args, b=base[:qn], c=cnt[:qn]:
                                 ivf_probe_scan_ref(*a, b, c, **kw), iters=2),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops)
            print(f"ivf_scan {mode} Q={qn}: {json.dumps(ivf[(mode, qn)])}", flush=True)
    # every cluster at Q = 64 (the exactness check's shape): the plan's
    # table against its contract, K11 against the exact scan of the same
    # rows (K1), and the two times side by side
    allp = torch.arange(n_cl, device=dev)[None].expand(64, n_cl)
    base_all, cnt_all = offsets[allp].int().contiguous(), counts[allp].int().contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b_, c_ in ((base, cnt), (base_all, cnt_all)):
        n_block, rps, splits = ivf_geometry(64, b_.shape[1], k, cmax, n, wg=0, sms=sms)
        check_plan(b_, c_, *ivf_plan_cuda(b_, c_, n_block=n_block, rps=rps, splits=splits),
                   n_block=n_block, rps=rps)
    qs = qf[:64].to(bf16)
    fn_all = lambda: ivf_probe_scan(sorted_bf16, qs, None, None, base_all, cnt_all, k=k,
                                    cmax=cmax, int8=False)
    s, pos = fn_all()
    rs, ri = cosine_topk_ref(sorted_bf16, qs, k)
    topk_agree(rs, ri, s, pos, tol, "K11 over every cluster against the exact scan")
    all_ms = cuda_ms(fn_all, iters=10)
    k1_ms = cuda_ms(lambda: cosine_topk(sorted_bf16, qs, k), iters=10)
    print(f"ivf_scan every cluster, Q=64: {all_ms:.4f} ms; K1 over the same rows at Q=64: "
          f"{k1_ms:.4f} ms; ratio {all_ms / k1_ms:.3f} (plan checked at nprobe 16 and "
          f"1024)", flush=True)
    # masked, an empty cluster and a spill duplicate, small
    lay = torch.tensor([0, 1, 37, 300, 5, 64], device=dev)
    offs = torch.cumsum(lay, 0) - lay
    mat = x[:int(lay.sum())].to(bf16).clone()
    mat[int(offs[4])] = mat[int(offs[3]) + 7]                  # spill copy
    b2 = offs[torch.tensor([[0, 3, 4, 1], [2, 5, 3, 4]], device=dev)].int()
    c2_ = lay[torch.tensor([[0, 3, 4, 1], [2, 5, 3, 4]], device=dev)].int()
    msk = torch.rand(mat.shape[0], generator=gen, device=dev) < 0.8
    q2 = torch.stack([mat[int(offs[3]) + 7], mat[0]]).contiguous()
    kw = dict(k=20, cmax=300, int8=False, mask_sorted=msk)
    s2, p2 = ivf_probe_scan(mat, q2, None, None, b2, c2_, **kw)
    r2s, r2p = ivf_probe_scan_ref(mat, q2, None, None, b2, c2_, **kw)
    topk_agree(r2s, r2p, s2, p2, tol)
    main = ivf[("bf16", 64)]
    rows["ivf_scan"] = dict(
        source="reverso_tpu_torch/csrc/ivf_scan.cu",
        replaces="reverso_tpu/ops/ivf_scan.py:70",
        max_abs_err=max(v["err"] for v in ivf.values()),
        shape="1M x 1024 in 1024 clusters, nprobe 16, Q=64, k=10, bf16 "
              f"(Q=1 bf16 {ivf[('bf16', 1)]['ms']:.4f} ms, Q=64 int8 "
              f"{ivf[('int8', 64)]['ms']:.4f} ms, Q=1 int8 {ivf[('int8', 1)]['ms']:.4f} ms, "
              f"Q=64 fp32 {ivf[('fp32', 64)]['ms']:.4f} ms, Q=1 fp32 "
              f"{ivf[('fp32', 1)]['ms']:.4f} ms; every cluster at Q=64 {all_ms:.4f} ms, "
              f"K1 there {k1_ms:.4f} ms)",
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], fp32=ivf[("fp32", 64)], fp32_q1=ivf[("fp32", 1)],
        every_cluster_ms=all_ms, k1_same_rows_ms=k1_ms,
        library="none: no single PyTorch call (a gather, a batched matmul and a topk)",
        library_ms=None)
    del x, sorted_bf16, v8
    return rows


def capacity_data(n: int, d: int, seed: int):
    """Chunks of `n` clustered unit rows (4,096 centers plus noise) from a
    numpy seed, with their payloads."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4096, d), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    for lo in range(0, n, 65536):
        m = min(65536, n - lo)
        x = centers[rng.integers(0, 4096, m)]
        x += rng.standard_normal((m, d), dtype=np.float32) * np.float32(0.6 / np.sqrt(d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        conf = rng.random(m)
        yield x, [{"folder": (lo + j) % 10, "confidence": float(conf[j])}
                  for j in range(m)]


def capacity_run(root: str) -> dict:
    """The capacity indexes and filtered search through `Reverso` on the
    card, on a 1,000,000 x 1024 store: (g, first) the float32 store, K1
    and K2 on fp32 rows; (a) bf16 exact with payload filters and count; (b)
    deleted vectors; (c) int8; (d) binary + rescore; (e) IVF at the
    defaults, built, cached and reloaded, its search's host time by part
    at Q = 1 and 64 (`ivf_search_parts`); (f) IVF int8 with spill and
    balance. Returns (a)-(f)'s launches, top-k shapes and K11's by_shape
    rows (`ivf_path_shapes`), then (g)'s launches and shapes."""
    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import SearchConfig, StoreConfig, default_config
    from reverso_tpu_torch.engine import Reverso
    from reverso_tpu_torch.ops.topk import cosine_topk_int8_ref, cosine_topk_ref
    from reverso_tpu_torch.store import VectorStore

    n, d, k = 1_000_000, 1024, 10
    t0 = time.perf_counter()
    with VectorStore.create(root, "capacity", d) as store:
        for x, pays in capacity_data(n, d, seed=3):
            store.append(x, pays)
    store_s = time.perf_counter() - t0
    vecs = np.asarray(VectorStore.open(root, "capacity").vectors())
    qsel = np.arange(64) * 15_601
    rng = np.random.default_rng(4)
    queries = vecs[qsel] + rng.standard_normal((64, d), dtype=np.float32) * np.float32(0.02)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    print(f"capacity store: {n} x {d} in {store_s:.1f} s", flush=True)

    def engine(dtype="bfloat16", **search):
        cfg = default_config().replace(
            store=StoreConfig(root_dir=root, dtype=dtype),
            search=dataclasses.replace(SearchConfig(), **search))
        eng = Reverso(cfg, device="cuda")
        check("Loaded" in eng.load_database("capacity"), "load_database failed")
        return eng

    def timed_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        lat = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            lat.append((time.perf_counter() - t) * 1e3)
        return float(np.median(lat))

    q_dev = torch.from_numpy(queries).cuda()
    out = {"store_s": store_s}

    # (g) the float32 store (`StoreConfig(dtype="float32")`, the reference's
    # strict-parity mode): the 4.1 GB of fp32 rows on the card, K1 and K2 on
    # fp32 rows, each search held against the plain scan of the same matrix.
    # Run first, while the store has no deleted rows (so that the unfiltered
    # search is K1's plain mode), and counted on its own
    kernels.reset_counts()
    eng = engine("float32")
    index = eng._get_index()
    check(index.matrix.dtype == torch.float32 and tuple(index.matrix.shape) == (n, d),
          f"float32 store: {index.matrix.dtype} {tuple(index.matrix.shape)}")
    f32_err = 0.0
    for filt in (None, {"folder": 3}):
        mask = None if filt is None else torch.from_numpy(eng._filter_mask(filt)).cuda()
        s, i = eng.search_batch(queries, k, filter=filt)
        rs, ri = cosine_topk_ref(index.matrix, q_dev, k, row_mask=mask)
        topk_agree(rs, ri, torch.from_numpy(s), torch.from_numpy(i), 1e-5)
        f32_err = max(f32_err, max_err(torch.from_numpy(s), rs.cpu()))
        if filt is not None:
            check(bool((i[i >= 0] % 10 == 3).all()),
                  "float32 store: filter {folder: 3} let a row through")
    text, items = eng.search_similar(-2.0, 5, embeddings=queries, query_index=3)
    rs, ri = cosine_topk_ref(index.matrix, q_dev[3:4], 5)
    topk_agree(rs, ri, torch.tensor([[it["score"] for it in items]]),
               torch.tensor([[it["id"] for it in items]], dtype=torch.int32), 1e-5)
    out["f32_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k))
    out["f32_filtered_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k,
                                                                        filter={"folder": 3}))
    out["f32_search1_ms"] = timed_ms(lambda: eng.search_similar(-2.0, 5, embeddings=queries,
                                                                query_index=3))
    out["f32_max_abs_err"] = f32_err
    f32_launches = dict(kernels.launches)
    f32_shapes = {key: c for key, c in kernels.shape_launches.items()
                  if key[0] == "topk_stream_f32"}
    print(f"(g) float32 store: max abs score err {f32_err} (tol 1e-5); launches "
          f"{ {key: c for key, c in f32_launches.items() if c} }; by shape "
          f"{[(key, c) for key, c in f32_shapes.items()]}", flush=True)
    check(f32_launches["topk_stream_f32"] > 0 and f32_launches["topk_stream_f32"] ==
          f32_launches["topk_stream"] + f32_launches["topk_masked"],
          "a float32-store search missed the fp32 scan")
    del eng, index
    torch.cuda.empty_cache()

    kernels.reset_counts()
    # (a) bf16 exact, filtered; the gate: the exact plain scan of the subset
    eng = engine()
    folder3 = np.arange(n) % 10 == 3
    index = eng._get_index()
    for filt in ({"folder": 3}, "confidence>=0.5"):
        mask = eng._filter_mask(filt)
        s, i = eng.search_batch(queries, k, filter=filt)
        rs, ri = cosine_topk_ref(index.matrix, q_dev, k, row_mask=torch.from_numpy(mask).cuda())
        topk_agree(rs, ri, torch.from_numpy(s), torch.from_numpy(i), 1e-4)
        check(bool(mask[i[i >= 0]].all()), f"filter {filt} let a row through")
    check(eng.count(filter={"folder": 3}) == int(folder3.sum()), "count(folder=3)")
    text, items = eng.search_similar(0.0, 5, embeddings=queries, query_index=3,
                                     filter={"folder": 3})
    check(len(items) == 5 and all(it["payload"]["folder"] == 3 for it in items),
          f"search_similar(filter=) gave {text}")
    out["filtered_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k,
                                                                    filter={"folder": 3}))
    print(f"(a) filtered bf16: count(folder=3) {eng.count(filter={'folder': 3})}, "
          f"count(confidence>=0.5) {eng.count(filter='confidence>=0.5')}", flush=True)
    del eng, index

    # (b) 1% of the rows deleted with VectorStore.delete_vector_rows
    gone = np.random.default_rng(5).choice(n, n // 100, replace=False)
    gone = np.union1d(gone, qsel[:8])                      # some queries' own rows
    with VectorStore.open(root, "capacity", writable=True) as w:
        w.delete_vector_rows(gone.tolist())
    presence = np.ones(n, bool)
    presence[gone] = False
    pres_dev = torch.from_numpy(presence).cuda()
    eng = engine()
    s, i = eng.search_batch(queries, k)
    rs, ri = cosine_topk_ref(eng._get_index()._ix.matrix, q_dev, k, row_mask=pres_dev)
    topk_agree(rs, ri, torch.from_numpy(s), torch.from_numpy(i), 1e-4)
    check(bool(presence[i[i >= 0]].all()), "a deleted vector came back")
    bf16_matrix = eng._get_index()._ix.matrix
    out["deleted_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k))
    del eng

    # exact fp32 top-10 of the remaining rows: the recall reference
    f32 = torch.empty((n, d), device="cuda")
    for lo in range(0, n, 65536):
        f32[lo:lo + 65536] = torch.from_numpy(np.array(vecs[lo:lo + 65536]))
    _, exact_i = cosine_topk_ref(f32, q_dev, k, row_mask=pres_dev)
    exact_i = exact_i.cpu().numpy()
    del f32

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, exact_i)]))

    # (c) int8, with and without a filter: ids equal the plain K9's
    eng = engine("int8")
    ix = eng._get_index()._ix
    for filt in (None, {"folder": 3}):
        mask = presence if filt is None else presence & eng._filter_mask(filt)
        s, i = eng.search_batch(queries, k, filter=filt)
        rs, ri = cosine_topk_int8_ref(ix.matrix, ix.scale, q_dev, k,
                                      row_mask=torch.from_numpy(mask).cuda())
        check(np.array_equal(i, ri.cpu().numpy()) and np.array_equal(s, rs.cpu().numpy()),
              f"int8 engine (filter {filt}) differs from the plain K9")
    out["int8_recall10"] = recall(eng.search_batch(queries, k)[1])
    out["int8_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k))
    del eng, ix

    # (d) binary + rescore (oversampling 3)
    eng = engine("binary")
    s, i = eng.search_batch(queries, k)
    check(bool(presence[i[i >= 0]].all()), "binary: a deleted vector came back")
    out["binary_rescore_recall10"] = recall(i)
    out["binary_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k))
    del eng

    # (e) and (f) with K11's inputs kept at each shape they ran it at
    ivf_captured = {}
    with ivf_inputs(ivf_captured):
        # (e) IVF at the defaults: build + cache, then reload from the cache
        ivf_cfg = dict(index="ivf")
        t0 = time.perf_counter()
        eng = engine(**ivf_cfg)
        eng._get_index()
        out["ivf_build_s"] = time.perf_counter() - t0
        s, i = eng.search_batch(queries, k)
        out["ivf_recall10_nprobe16"] = recall(i)
        out["ivf_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k))
        out["ivf_search1_ms"] = timed_ms(lambda: eng.search_batch(queries[:1], k))
        ivf = eng._get_index()._ix._ivf
        out["ivf_search_parts_ms"] = {
            f"Q={qn}": ivf_search_parts(torch, ivf, queries[:qn], k,
                                        eng._get_index()._ix.nprobe, presence)
            for qn in (1, 64)}
        check(ivf.n_clusters == 1024, f"IVF clusters {ivf.n_clusters}")
        s_all, i_all = ivf.search(queries, k, nprobe=ivf.n_clusters, row_mask=presence)
        rs, ri = cosine_topk_ref(bf16_matrix, q_dev, k, row_mask=pres_dev)
        topk_agree(rs, ri, s_all, i_all, 1e-4)
        cache = [f for f in os.listdir(os.path.join(root, "capacity", "index"))
                 if f.startswith("ivf_c1024_")]
        check(len(cache) == 1, f"IVF cache files {cache}")
        del eng, ivf
        t0 = time.perf_counter()
        eng = engine(**ivf_cfg)
        eng._get_index()
        out["ivf_reload_s"] = time.perf_counter() - t0
        check(np.array_equal(eng.search_batch(queries, k)[1], i), "reloaded IVF ids differ")
        del eng

        # (f) IVF int8 with spill 0.1 and balance 2.0, filtered too
        t0 = time.perf_counter()
        eng = engine("int8", index="ivf", ivf_spill=0.1, ivf_balance=2.0)
        ivf = eng._get_index()._ix._ivf
        out["ivf_int8_build_s"] = time.perf_counter() - t0
        s, i = eng.search_batch(queries, k)
        for row in i:
            real = row[row >= 0]
            check(len(set(real.tolist())) == len(real), "spill dedup returned an id twice")
        out["ivf_int8_spill_recall10_nprobe16"] = recall(i)
        s, i = eng.search_batch(queries, k, filter={"folder": 3})
        check(bool((i[i >= 0] % 10 == 3).all()), "filtered IVF let a row through")
        out["ivf_int8_search64_ms"] = timed_ms(lambda: eng.search_batch(queries, k))
        out["ivf_int8"] = dict(n_clusters=ivf.n_clusters, n_spill=ivf.n_spill, cmax=ivf.cmax)
        del eng, ivf
    launches = dict(kernels.launches)
    topk_shapes = {k: n for k, n in kernels.shape_launches.items()
                   if k[0] in ("topk_masked", "topk_int8", "topk_binary")}
    ivf_counts = {k: n for k, n in kernels.shape_launches.items() if k[0] == "ivf_scan"}
    print(f"launches on the capacity path: {launches}; plain dispatches "
          f"{kernels.plain_dispatches}; by shape {[(k, n) for k, n in topk_shapes.items()]}",
          flush=True)
    for name in ("topk_masked", "topk_int8", "topk_binary", "ivf_scan"):
        check(launches[name] > 0, f"kernel {name} never launched on the capacity path")
    check(all(v == 0 for v in kernels.plain_dispatches.values()),
          "a capacity search took a plain shape rule")
    print(f"capacity slice: {json.dumps(out)}", flush=True)
    ivf_rows = ivf_path_shapes(torch, ivf_counts, ivf_captured, "capacity")
    ivf_captured.clear()
    return launches, topk_shapes, ivf_rows, f32_launches, f32_shapes


def topk_agree_scaled(ref_s, ref_i, s, i, tol: float) -> None:
    """`topk_agree` with the tolerance scaled per query by max(1, the
    largest |score| of the reference's row): scores that grow with the
    rows' norms (euclid ranking keys, L1 distances, MaxSim sums)."""
    import torch
    ref_s, ref_i, s, i = (torch.as_tensor(t).cpu() for t in (ref_s, ref_i, s, i))
    fin = torch.isfinite(ref_s)
    scale = torch.where(fin, ref_s.double(), 0).abs().amax(1, keepdim=True).clamp(min=1.0)
    topk_agree(ref_s.double() / scale, ref_i, s.double() / scale, i, tol)


def openai_clip_state_dict(sd: dict) -> dict:
    """The port tower's state dict -> the OpenAI-CLIP / perception_models
    `visual.*` scheme (fused in_proj, [W, E] proj), fp32 CPU tensors."""
    import torch
    sd = {k: v.detach().float().cpu() for k, v in sd.items()}
    out = {"visual.conv1.weight": sd["patch_embed.weight"],
           "visual.class_embedding": sd["cls_token"].reshape(-1),
           "visual.positional_embedding": sd["pos_embed"][0],
           "visual.proj": sd["proj.weight"].t().contiguous()}
    for ours, theirs in (("patch_embed.bias", "conv1.bias"), ("ln_pre.weight", "ln_pre.weight"),
                         ("ln_pre.bias", "ln_pre.bias"), ("ln_post.weight", "ln_post.weight"),
                         ("ln_post.bias", "ln_post.bias"), ("attn_pool.probe", "attn_pool.probe"),
                         ("attn_pool.ln.weight", "attn_pool.layernorm.weight"),
                         ("attn_pool.ln.bias", "attn_pool.layernorm.bias")):
        if ours in sd:
            out[f"visual.{theirs}"] = sd[ours]

    def attn(ours, theirs):
        for part in ("weight", "bias"):
            out[f"visual.{theirs}.in_proj_{part}"] = torch.cat(
                [sd[f"{ours}.{c}_proj.{part}"] for c in "qkv"])
            out[f"visual.{theirs}.out_proj.{part}"] = sd[f"{ours}.out_proj.{part}"]

    if "attn_pool.probe" in sd:
        attn("attn_pool", "attn_pool.attn")
    i = 0
    while f"blocks.{i}.ln1.weight" in sd:
        b, lp = f"blocks.{i}", f"visual.transformer.resblocks.{i}"
        for ours, theirs in (("ln1", "ln_1"), ("ln2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                             ("mlp.fc2", "mlp.c_proj")):
            for part in ("weight", "bias"):
                out[f"{lp}.{theirs}.{part}"] = sd[f"{b}.{ours}.{part}"]
        attn(f"{b}.attn", f"transformer.resblocks.{i}.attn")
        if f"{b}.ls1.gamma" in sd:
            out[f"{lp}.ls_1.gamma"] = sd[f"{b}.ls1.gamma"]
            out[f"{lp}.ls_2.gamma"] = sd[f"{b}.ls2.gamma"]
        i += 1
    return out


def hf_clip_state_dict(sd: dict) -> dict:
    """The port's CLIP tower state dict -> HF `CLIPVisionModelWithProjection`
    names (separate q/k/v, `pre_layrnorm`, `visual_projection`), fp32 CPU
    tensors."""
    sd = {k: v.detach().float().cpu() for k, v in sd.items()}
    v = "vision_model"
    out = {f"{v}.embeddings.patch_embedding.weight": sd["patch_embed.weight"],
           f"{v}.embeddings.class_embedding": sd["cls_token"].reshape(-1),
           f"{v}.embeddings.position_embedding.weight": sd["pos_embed"][0],
           "visual_projection.weight": sd["proj.weight"]}
    for part in ("weight", "bias"):
        out[f"{v}.pre_layrnorm.{part}"] = sd[f"ln_pre.{part}"]
        out[f"{v}.post_layernorm.{part}"] = sd[f"ln_post.{part}"]
    i = 0
    while f"blocks.{i}.ln1.weight" in sd:
        b, lp = f"blocks.{i}", f"{v}.encoder.layers.{i}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                             ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2"),
                             ("attn.q_proj", "self_attn.q_proj"), ("attn.k_proj", "self_attn.k_proj"),
                             ("attn.v_proj", "self_attn.v_proj"),
                             ("attn.out_proj", "self_attn.out_proj")):
            for part in ("weight", "bias"):
                out[f"{lp}.{theirs}.{part}"] = sd[f"{b}.{ours}.{part}"]
        i += 1
    return out


def loaders_run(root: str) -> tuple:
    """(L) The vision-checkpoint loaders at full width, on phase 5's 256
    images: a seeded PE-Core-L14-336 written in the `openai_clip` scheme
    with `torch.save` and loaded with `PerceptionEncoder.from_torch` embeds
    bit for bit as the same weights loaded directly (B = 64, bf16); a seeded
    CLIP-L14-336 in the `hf_clip` scheme (an HF directory with
    `pytorch_model.bin`; family "clip": K3 without RoPE, K4 with
    quick_gelu), its bf16 embeddings against the fp32 tower of the same
    weights (min cosine 0.99, the bf16-vs-fp32 gate of phase 4); then a
    store built from the CLIP tower through `create_database(use_direct_pe=
    True)` and searched (K1). Returns the CLIP path's launches, its K3/K4
    shapes (the bf16 embedding run and the build) and its K1 shapes."""
    import torch
    from PIL import Image
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.compat import SimpleReverso
    from reverso_tpu_torch.config import MODEL_PRESETS, StoreConfig, default_config
    from reverso_tpu_torch.ingest.images import preprocess_pil
    from reverso_tpu_torch.models.pe import PerceptionEncoder
    from reverso_tpu_torch.store import VectorStore

    folder = os.path.join(root, "images")
    names = sorted(os.listdir(folder))
    pe_cfg, clip_cfg = MODEL_PRESETS["PE-Core-L14-336"], MODEL_PRESETS["CLIP-L14-336"]
    check(pe_cfg.image_size == clip_cfg.image_size == 336 and not clip_cfg.use_rope,
          "loader presets changed")
    px = np.stack([preprocess_pil(Image.open(os.path.join(folder, f)).convert("RGB"), 336)
                   for f in names])

    def embed(enc):
        return np.concatenate([enc.encode_image(px[lo:lo + 64]) for lo in range(0, len(px), 64)])

    out = {}
    direct = PerceptionEncoder(pe_cfg, seed=31, device="cuda")
    path = os.path.join(root, "pe_core_l14_openai.pt")
    torch.save(openai_clip_state_dict(direct.module.state_dict()), path)
    t0 = time.perf_counter()
    loaded = PerceptionEncoder.from_torch(path, pe_cfg, device="cuda")
    out["pe_from_torch_s"] = time.perf_counter() - t0
    check(loaded.family == "pe", f"from_torch family {loaded.family}")
    a, b = embed(direct), embed(loaded)
    check(a.shape == (256, 1024) and np.isfinite(a).all(), "PE loader embeddings")
    check(np.array_equal(a, b), "PE-Core-L14-336 through from_torch (openai_clip) differs "
                                "from the same weights loaded directly")
    os.remove(path)
    del direct, loaded
    torch.cuda.empty_cache()

    src = PerceptionEncoder(clip_cfg, family="clip", seed=32, device="cpu")
    hf_dir = os.path.join(root, "clip_l14_336_hf")
    os.makedirs(hf_dir)
    torch.save(hf_clip_state_dict(src.module.state_dict()),
               os.path.join(hf_dir, "pytorch_model.bin"))
    del src
    t0 = time.perf_counter()
    clip = PerceptionEncoder.from_torch(hf_dir, clip_cfg, device="cuda")
    out["clip_from_torch_s"] = time.perf_counter() - t0
    check(clip.family == "clip", f"from_torch family {clip.family}")
    kernels.reset_counts()
    e16 = embed(clip)
    launches = dict(kernels.launches)
    shapes = {k: n for k, n in kernels.shape_launches.items()
              if k[0] in ("flash_heads_tc", "fused_mlp_tc")}
    check(shapes == {("flash_heads_tc", (64, 577, 1024, 16, False)): 96,
                     ("fused_mlp_tc", (36928, 1024, 4096, "quick_gelu")): 96},
          f"CLIP bf16 embedding: K3/K4 launches by shape {shapes}")
    clip32 = PerceptionEncoder.from_torch(hf_dir, dataclasses.replace(clip_cfg, dtype="float32"),
                                          device="cuda")
    e32 = embed(clip32)
    del clip32
    torch.cuda.empty_cache()
    cos = (e16 * e32).sum(1)
    out.update(clip_min_cosine_vs_fp32=float(cos.min()), clip_mean_cosine_vs_fp32=float(cos.mean()))
    check(e16.shape == (256, 768) and np.isfinite(e16).all(), "CLIP embeddings")
    check(float(cos.min()) >= 0.99, f"CLIP-L14-336 bf16 drifts from fp32: {cos.min()}")

    cfg = default_config().replace(model=clip_cfg,
                                   store=StoreConfig(root_dir=os.path.join(root, "db_clip")))
    sr = SimpleReverso(cfg, encoder=clip, device="cuda")
    kernels.reset_counts()
    t0 = time.perf_counter()
    transcript = sr.create_database(folder, "clip", use_direct_pe=True)
    out["clip_build_s"] = time.perf_counter() - t0
    check("ready for searching" in transcript, f"CLIP build failed:\n{transcript}")
    sr.load_database("clip")
    vecs = np.asarray(VectorStore.open(cfg.store.root_dir, "clip").vectors())
    check(vecs.shape == (256, 768), f"CLIP store {vecs.shape}")
    tie_tol = 5e-3   # batch-1 vs batch-64 bf16 forwards round differently
    for j in (0, 101):
        fname = f"img_{j:04d}.png"
        sr.process_image_direct_pe(Image.open(os.path.join(folder, fname)))
        text, items = sr.search_similar(0.0, 5)
        own = [it for it in items if it["filename"] == fname]
        check(bool(own) and own[0]["score"] >= items[0]["score"] - tie_tol,
              f"CLIP store {fname}: own row not at rank 0 within {tie_tol}:\n{text}")
    s, ids = sr._engine.search_batch(vecs[:64], 5)
    check(all(r in ids[r] for r in range(64)), "CLIP store search_batch: an own row is missing")
    build = dict(kernels.launches)
    check(build["topk_stream"] > 0, "K1 never launched on the CLIP store")
    for key, n in kernels.shape_launches.items():
        if key[0] in ("flash_heads_tc", "fused_mlp_tc"):
            shapes[key] = shapes.get(key, 0) + n
    topk_shapes = {key: n for key, n in kernels.shape_launches.items() if key[0] == "topk_stream"}
    launches["topk_stream"] = build["topk_stream"]
    print(f"loaders: {json.dumps(out)}; CLIP K3/K4 by shape {sorted(shapes.items())}",
          flush=True)
    del sr, clip
    torch.cuda.empty_cache()
    return launches, shapes, topk_shapes


def tc_path_shapes(torch, shape_launches: dict) -> tuple:
    """K3 and K4 in bf16 at each shape the direct-embed, entry-point and
    training paths (PE, RoPE, gelu) and the CLIP loader path (no RoPE,
    quick_gelu) ran them at: their
    launches there, held against the plain version on seeded inputs of that
    shape (K3 within 2e-2 absolute, K4 within 2e-2 of max(1, |y|) for each
    element: the gates of `kernel_checks`), ms on the same inputs (the RoPE
    tables on the card, as the tower caches them) and bound."""
    from reverso_tpu_torch.ops.attention import flash_attention_heads, flash_attention_heads_ref
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp, mlp_ref
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    gen = torch.Generator(device="cuda").manual_seed(29)
    randn = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda")
                                       * scale).to(torch.bfloat16)
    tol = 2e-2
    heads, mlp = [], []
    for (name, shape), n in sorted(shape_launches.items(), key=lambda kv: str(kv)):
        if name == "flash_heads_tc":
            b, s, w, h, rope = shape
            what = f"B={b} S={s} W={w} H={h} bf16 {'RoPE' if rope else 'no RoPE'}"
            q, k, v = randn(b, s, w), randn(b, s, w), randn(b, s, w)
            cos = sin = None
            if rope:
                cos, sin = (torch.from_numpy(a).cuda() for a in rope_2d_tables(
                    int(np.sqrt(s - 1)), w // h, cls_token=True))
            call = lambda: flash_attention_heads(q, k, v, heads=h, cos=cos, sin=sin)
            err = max_err(call(), flash_attention_heads_ref(q, k, v, heads=h, cos=cos, sin=sin))
            check(err <= tol, f"flash_heads {what}: max abs err {err} > {tol}")
            heads.append(dict(shape=what, launches=n, max_abs_err=err, ms=cuda_ms(call),
                              bound_ms=heads_bound(b, s, w, h, 2, "bfloat16")[0]))
            del q, k, v
        elif name == "fused_mlp_tc":
            t, w, hid, act = shape
            what = f"T={t} W={w} H={hid} bf16 {act}"
            w1, b1 = randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.02)
            w2, b2 = randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.02)
            x = randn(t, w)
            call = lambda: fused_mlp(x, w1, b1, w2, b2, act=act)
            ref = mlp_ref(x, w1, b1, w2, b2, act=act).float()
            diff = (call().float() - ref).abs()
            err = float(diff.max())
            check(bool((diff <= tol * ref.abs().clamp(min=1.0)).all()),
                  f"fused_mlp {what}: max abs err {err} (tol {tol} of max(1, |y|))")
            del diff, ref
            mlp.append(dict(shape=what, launches=n, max_abs_err=err, ms=cuda_ms(call),
                            bound_ms=mlp_bound(t, w, hid, 2, "bfloat16")[0]))
            del x
    return heads, mlp


def capacity_rows(root: str):
    """The capacity phase's 1,000,000 x 1024 unit rows (its store's vectors
    file, mapped), a seeded per-row norm in [0.5, 2] applied (fp32, host),
    and 256 queries: scaled rows plus noise of norm 0.02."""
    from reverso_tpu_torch.store import VectorStore

    unit = np.asarray(VectorStore.open(root, "capacity").vectors())
    rng = np.random.default_rng(41)
    norms = rng.uniform(0.5, 2.0, (len(unit), 1)).astype(np.float32)
    rows = np.empty(unit.shape, np.float32)
    for lo in range(0, len(unit), 65536):
        rows[lo:lo + 65536] = unit[lo:lo + 65536] * norms[lo:lo + 65536]
    sel = np.arange(256) * 3_889
    d = unit.shape[1]
    q = rows[sel] + rng.standard_normal((256, d), dtype=np.float32) * np.float32(0.02 / np.sqrt(d))
    return unit, rows, q


def euclid_run(rows: np.ndarray, queries: np.ndarray) -> tuple:
    """(E) Euclid at capacity: the capacity rows with per-row norms in
    [0.5, 2], as bf16 and fp32 `DeviceIndex(distance="euclid")` (the
    `[x, ||x||^2]` rows, d + 1 = 1025 columns zero-padded to a 16-byte row:
    1032 bf16, 1028 fp32; K1/K2): Q = 64 and Q = 1, k = 10, plain and with
    10% of the rows kept. Each search is then held against
    the kernel on the same augmented queries (the same ids, and the
    distances `-sqrt(max(||q||^2 - key, 0))` of its keys bit for bit) and
    those keys against the plain scan of the same matrix on the card (the
    K1/K2 gate of that dtype, 1e-4 bf16 and 1e-5 fp32, of a query's
    largest |key| where that passes 1: the keys reach ||q||^2 <= 4, the
    gates are set for unit scores; ids by the tie-margin rule). Then the
    same searches timed, and K1 on the padded rows timed against the
    unpadded d = 1025 rows (the producer's copy) at Q = 64 and 256.
    Returns the path's launches and top-k shapes (read before the
    comparison launches)."""
    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref
    from reverso_tpu_torch.store import DeviceIndex

    n, d = rows.shape
    keep = torch.from_numpy(np.arange(n) % 10 == 3).cuda()
    out, errs, results = {}, {}, []
    kernels.reset_counts()
    indexes = {dtype: DeviceIndex(rows, dtype=dtype, distance="euclid")
               for dtype in ("bfloat16", "float32")}
    for dtype, ix in indexes.items():
        pitch = 1032 if dtype == "bfloat16" else 1028
        check(tuple(ix.matrix.shape) == (n, pitch) and ix.dim == d + 1,
              f"euclid matrix {tuple(ix.matrix.shape)}")
        for qn in (64, 1):
            qt = torch.from_numpy(queries[:qn]).cuda()
            for mask in (None, keep):
                results.append((dtype, qt, mask, *ix.search(qt, 10, row_mask=mask)))
    launches = dict(kernels.launches)
    shapes = {key: c for key, c in kernels.shape_launches.items()
              if key[0] in ("topk_stream", "topk_masked", "topk_stream_f32")}
    # bf16 and fp32, Q = 64 and 1: four plain (K1) and four masked (K2)
    # launches, the four on fp32 rows counted under topk_stream_f32 too
    check(launches["topk_stream"] == launches["topk_masked"] == launches["topk_stream_f32"] == 4,
          f"euclid launches {launches}")
    for dtype, qt, mask, s, i in results:
        ix = indexes[dtype]
        qa = torch.nn.functional.pad(torch.cat([2 * qt, -torch.ones_like(qt[:, :1])], 1),
                                     (0, ix.matrix.shape[1] - d - 1))
        ks, ki = cosine_topk(ix.matrix, qa, 10, row_mask=mask)
        dist2 = torch.clamp((qt * qt).sum(1, keepdim=True) - ks, min=0.0)
        check(torch.equal(ki, i) and torch.equal(
            s, torch.where(ki >= 0, -torch.sqrt(dist2), float("-inf"))),
            "euclid: the search differs from the kernel on its augmented queries")
        rs, ri = cosine_topk_ref(ix.matrix, qa, 10, row_mask=mask)
        topk_agree_scaled(rs, ri, ks, ki, 1e-4 if dtype == "bfloat16" else 1e-5)
        fin = torch.isfinite(rs)
        errs[dtype] = max(errs.get(dtype, 0.0), float(
            ((torch.where(fin, ks, 0) - torch.where(fin, rs, 0)).abs()
             / torch.where(fin, rs, 0).abs().amax(1, keepdim=True).clamp(min=1.0)).max()))
        if mask is not None:
            check(bool((i[i >= 0] % 10 == 3).all()), "euclid: the mask let a row through")
        else:
            check(bool((i[:, 0] == torch.arange(len(qt), device="cuda") * 3_889).all()),
                  "euclid: a query's own row is not its nearest")
    for dtype, ix in indexes.items():
        q64 = torch.from_numpy(queries[:64]).cuda()
        out[f"{dtype}_search64_ms"] = sync_ms(torch, lambda: ix.search(q64, 10))
        out[f"{dtype}_search64_10pct_ms"] = sync_ms(torch, lambda: ix.search(q64, 10, row_mask=keep))
        out[f"{dtype}_search1_ms"] = sync_ms(torch, lambda: ix.search(q64[:1], 10))
        # K1 on the padded rows against the unpadded d = 1025 rows (the
        # producer's copy: a row of 1025 values is not a 16-byte pitch)
        pitch = ix.matrix.shape[1]
        unpadded = ix.matrix[:, :d + 1].contiguous()
        for qn in (64, 256):
            qt = torch.from_numpy(queries[:qn]).cuda()
            qa = torch.cat([2 * qt, -torch.ones_like(qt[:, :1])], 1)
            qp = torch.nn.functional.pad(qa, (0, pitch - d - 1))
            s1, i1 = cosine_topk(unpadded, qa, 10)
            s2, i2 = cosine_topk(ix.matrix, qp, 10)
            topk_agree_scaled(s1, i1, s2, i2, 1e-4 if dtype == "bfloat16" else 1e-5)
            out[f"{dtype}_k1_d1025_q{qn}_ms"] = cuda_ms(lambda: cosine_topk(unpadded, qa, 10))
            out[f"{dtype}_k1_d{pitch}_q{qn}_ms"] = cuda_ms(lambda: cosine_topk(ix.matrix, qp, 10))
            out[f"{dtype}_k1_d{pitch}_q{qn}_bound_ms"] = topk_bound(
                "topk_stream_f32" if dtype == "float32" else "topk_stream", qn, n, d + 1, 10,
                False)[0]
        del unpadded
        torch.cuda.empty_cache()
    indexes.clear()
    results.clear()
    torch.cuda.empty_cache()
    print(f"euclid 1M x 1024 ([x, ||x||^2] rows padded to 1032 / 1028): key max err (of max(1, |key|)) {errs} (gates "
          f"1e-4 bf16, 1e-5 fp32); launches {json.dumps({k: v for k, v in launches.items() if v})}; "
          f"{json.dumps(out)}", flush=True)
    return launches, shapes


def _l1_broadcast(db, q32, k, chunk):
    """The chunked L1 scan with the [Q, chunk, d] broadcast in place of
    `torch.cdist` (timed beside `ops/l1.py::manhattan_topk`)."""
    from reverso_tpu_torch.ops.topk import scan_topk

    return scan_topk(lambda lo, hi: -(q32[:, None, :] - db[lo:hi].float()[None]).abs().sum(-1),
                     db.shape[0], q32.shape[0], k, db.device, chunk=chunk)


def manhattan_run(rows: np.ndarray, queries: np.ndarray) -> dict:
    """(M) Manhattan over the euclid rows (bf16, the default store dtype) at
    Q = 16, k = 10: on a 65,536-row subset held against the numpy
    `manhattan_topk_host` of the same bf16 values (scores within 1e-5 of
    the query's largest |score|, ids by the tie-margin rule), then timed at
    full size with `torch.cdist(p=1)` chunks (the op) and with the
    broadcast |q - x| sum beside it, each holding the other's ids."""
    import torch
    from reverso_tpu_torch.ops.l1 import _CHUNK_ELEMS, manhattan_topk, manhattan_topk_host
    from reverso_tpu_torch.store import DeviceIndex

    q16 = queries[:16]
    qt = torch.from_numpy(q16).cuda()
    sub = DeviceIndex(rows[:65536], distance="manhattan")
    s, i = sub.search(q16, 10)
    hs, hi = manhattan_topk_host(sub.matrix.float().cpu().numpy(), q16, 10)
    topk_agree_scaled(hs, hi, s, i, 1e-5)
    s, i = sub.search(q16, 10, row_mask=np.arange(65536) % 10 == 3)
    check(bool((i[i >= 0] % 10 == 3).all()), "manhattan: the mask let a row through")
    del sub
    ix = DeviceIndex(rows, distance="manhattan")
    chunk = _CHUNK_ELEMS // 1024
    s1, i1 = manhattan_topk(ix.matrix, qt, 10)
    s2, i2 = _l1_broadcast(ix.matrix, qt, 10, chunk)
    topk_agree_scaled(s1, i1, s2, i2, 1e-5)
    check(bool((i1[:, 0] == torch.arange(16, device="cuda") * 3_889).all()),
          "manhattan: a query's own row is not its nearest")
    out = dict(cdist_ms=cuda_ms(lambda: manhattan_topk(ix.matrix, qt, 10), iters=3),
               broadcast_ms=cuda_ms(lambda: _l1_broadcast(ix.matrix, qt, 10, chunk), iters=3),
               search16_ms=sync_ms(torch, lambda: ix.search(q16, 10)),
               bound_ms=bound(ix.matrix.numel() * 2 + 16 * 1024 * 4 + 16 * 10 * 8,
                              3 * 16 * ix.matrix.numel(), "float32")[0])
    del ix
    torch.cuda.empty_cache()
    print(f"manhattan 1M x 1024 bf16, Q=16, k=10: {json.dumps(out)}", flush=True)
    return out


def pq_run(unit: np.ndarray, queries: np.ndarray) -> dict:
    """(P) PQ over the capacity rows at m = 128 (d / 8): `train_pq` on
    65,536 samples for 25 iterations, `pq_encode` of the 1M rows and
    `pq_topk`, each timed; the card's proxy search held against the same
    search on the CPU on a 65,536-row subset (1e-5, the tie-margin rule);
    recall@10 after the exact rescore (oversampling 3) against the exact
    fp32 top-10, beside binary + rescore's on the same rows."""
    import torch
    from reverso_tpu_torch.engine import _BinaryRescoreAdapter
    from reverso_tpu_torch.ops.pq import pq_encode, pq_topk, train_pq
    from reverso_tpu_torch.ops.topk import cosine_topk_ref
    from reverso_tpu_torch.store import BinaryIndex, PQIndex
    from reverso_tpu_torch.store.index import default_pq_m

    n, d = unit.shape
    m = default_pq_m(d)
    check(m == 128, f"default pq m {m}")
    q = unit[np.arange(64) * 15_601] + queries[:64] * np.float32(0.01)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = torch.from_numpy(q).cuda()
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb = train_pq(unit, m, iters=25, sample=65536, seed=0)
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = pq_encode(unit, cb)
    out["encode_s"] = time.perf_counter() - t0
    pqi = PQIndex(unit, m=m, codebooks=cb, codes=codes)
    cpu_sub = PQIndex(unit[:65536], m=m, codebooks=cb, codes=codes[:65536], device="cpu")
    gpu_sub = PQIndex(unit[:65536], m=m, codebooks=cb, codes=codes[:65536])
    s, i = gpu_sub.search(q, 30)
    cs, ci = cpu_sub.search(q, 30)
    topk_agree(cs, ci, s.cpu(), i.cpu(), 1e-5)
    del cpu_sub, gpu_sub
    out["search64_k30_ms"] = cuda_ms(lambda: pq_topk(pqi.matrix, pqi._cb_dev, qt, 30))
    f32 = torch.empty((n, d), device="cuda")
    for lo in range(0, n, 65536):
        f32[lo:lo + 65536] = torch.from_numpy(np.array(unit[lo:lo + 65536]))
    exact = cosine_topk_ref(f32, qt, 10)[1].cpu().numpy()
    del f32

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, exact)]))

    ad = _BinaryRescoreAdapter(pqi, unit, oversampling=3.0)
    ids = ad.search(q, 10)[1]
    check(all(len(set(r)) == 10 for r in ids), "pq + rescore: an id came back twice")
    out["recall10_rescore"] = recall(ids)
    out["rescore_search64_ms"] = sync_ms(torch, lambda: ad.search(q, 10))
    bad = _BinaryRescoreAdapter(BinaryIndex(unit), unit, oversampling=3.0)
    out["binary_recall10_rescore"] = recall(bad.search(q, 10)[1])
    out["nbytes"] = pqi.nbytes
    del pqi, ad, bad
    torch.cuda.empty_cache()
    print(f"pq 1M x 1024, m = 128: {json.dumps(out)}", flush=True)
    return out


def combine_run(unit: np.ndarray) -> dict:
    """(C) The example-combine searches over the 1M capacity rows in bf16
    and int8 (`DeviceIndex.best_score` with 4 positives and 2 negatives,
    `discover` with a target and 2 pairs, `context` with 2 pairs), timed at
    full size, and on a 65,536-row subset held against their numpy host
    twins on the same stored values (1e-4 bf16, 1e-5 int8 dequantized in
    fp32; the tie-margin rule); `matrix_topk` at S = 4096 against the numpy
    product, timed."""
    import torch
    from reverso_tpu_torch.ops.recommend import (best_score_topk_host, context_topk_host,
                                                 discover_topk_host, matrix_topk)
    from reverso_tpu_torch.store import DeviceIndex

    pos = np.array(unit[[11, 5_000, 70_000, 900_000]])
    neg = np.array(unit[[123, 456_789]])
    calls = {"best_score": (lambda ix: ix.best_score(pos, neg, k=10),
                            lambda mat, ex: best_score_topk_host(mat, ex(pos), ex(neg), 10)),
             "discover": (lambda ix: ix.discover(pos[0], pos[1:3], neg, k=10),
                          lambda mat, ex: discover_topk_host(mat, ex(pos[0]), ex(pos[1:3]),
                                                             ex(neg), 10)),
             "context": (lambda ix: ix.context(pos[:2], neg, k=10),
                         lambda mat, ex: context_topk_host(mat, ex(pos[:2]), ex(neg), 10))}
    out = {}
    for dtype, tol in (("bfloat16", 1e-4), ("int8", 1e-5)):
        sub = DeviceIndex(unit[:65536], dtype=dtype)
        mat = sub.matrix.float()
        if dtype == "int8":
            mat *= sub.scale
            ex = lambda a: np.asarray(a, np.float32)
        else:
            ex = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()
        mat = mat.cpu().numpy()
        for name, (dev_fn, host_fn) in calls.items():
            s, i = dev_fn(sub)
            hs, hi = host_fn(mat, ex)
            topk_agree_scaled(hs, hi, s, i, tol)
        del sub, mat
        ix = DeviceIndex(unit, dtype=dtype)
        for name, (dev_fn, _) in calls.items():
            s, i = dev_fn(ix)
            check(bool((i >= 0).all()) and bool(torch.isfinite(s).all()), f"{name} {dtype}")
            out[f"{name}_{dtype}_ms"] = sync_ms(torch, lambda: dev_fn(ix))
        del ix
        torch.cuda.empty_cache()
    sample = torch.from_numpy(np.array(unit[:4096])).cuda()
    s, i = matrix_topk(sample, 10)
    g = sample.double() @ sample.double().t()
    g.fill_diagonal_(float("-inf"))
    rs, ri = torch.topk(g, 10, dim=1)
    topk_agree(rs.float(), ri.int(), s, i, 1e-5)
    out["matrix_topk_s4096_ms"] = cuda_ms(lambda: matrix_topk(sample, 10))
    print(f"example combines 1M x 1024: {json.dumps(out)}", flush=True)
    return out


def multivec_points(unit: np.ndarray, n_points: int, seed: int):
    """`n_points` points of 1 to 8 sub-vectors each (a region's embeddings
    per sub-vector): the capacity rows in order, grouped."""
    counts = np.random.default_rng(seed).integers(1, 9, n_points)
    indptr = np.cumsum(counts)
    return np.array(unit[:indptr[-1]]), indptr


def maxsim_run(unit: np.ndarray) -> dict:
    """(X) MaxSim: 100,000 points of 1 to 8 sub-vectors of d = 1024 in a
    bf16 `MultiVecIndex`, Q = 16 queries of Tq = 4 (a point's regions plus
    noise), k = 10: the scores of the returned points against
    `maxsim_score_rows` of their bf16 rows (1e-4 of the largest |score|),
    the ranking against the exact host MaxSim of every point (the
    tie-margin rule), timed."""
    import torch
    from reverso_tpu_torch.ops.multivec import maxsim_score_rows
    from reverso_tpu_torch.store import MultiVecIndex

    subs, indptr = multivec_points(unit, 100_000, seed=43)
    mv = MultiVecIndex(subs, indptr)
    rows16 = mv.matrix.float().cpu().numpy()
    starts = np.concatenate([[0], indptr[:-1]])
    rng = np.random.default_rng(44)
    pts = rng.choice(100_000, 16, replace=False)
    qlist = [subs[starts[p] + rng.integers(0, indptr[p] - starts[p], 4)]
             + rng.standard_normal((4, 1024), dtype=np.float32) * np.float32(0.01) for p in pts]
    s, i = mv.search(qlist, 10)
    # exact host MaxSim of every point over the same bf16 rows
    exact = np.zeros((16, 100_000), np.float32)
    for r, q in enumerate(qlist):
        dots = q @ rows16.T                                     # [4, M]
        exact[r] = np.maximum.reduceat(dots, starts, axis=1).sum(0)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    topk_agree_scaled(np.take_along_axis(exact, order, 1), order, s, i, 1e-4)
    for r, q in enumerate(qlist):
        want = maxsim_score_rows([rows16[starts[p]:indptr[p]] for p in i[r]], q)
        check(float(np.abs(want - s[r]).max()) <= 1e-4 * max(1.0, float(np.abs(want).max())),
              "MaxSim scores differ from maxsim_score_rows")
    check(bool((i[:, 0] == pts).all()), "MaxSim: a query's own point is not its best")
    out = dict(points=100_000, sub_vectors=int(indptr[-1]),
               search16_ms=sync_ms(torch, lambda: mv.search(qlist, 10)))
    del mv
    torch.cuda.empty_cache()
    print(f"MaxSim: {json.dumps(out)}", flush=True)
    return out


def engine_stores_run(root: str, unit: np.ndarray, rows: np.ndarray, queries: np.ndarray) -> dict:
    """(S) Engine level: 100,000-row stores built through
    `VectorStore.append` (10,000 rows a call, payloads {"folder": i % 10})
    - euclid and manhattan over the scaled rows, pq over the unit rows, and
    a store with a multivector space "regions" (1 to 8 sub-vectors a
    point) - each searched through `Reverso.search_batch` at Q = 16, k = 10,
    with no filter and with {"folder": 3}, held against the same index on
    the CPU (euclid and manhattan from the store's rows, pq from the cache
    the card's build wrote, MaxSim from the store's sub-vectors). Returns
    the path's launches and K1/K2 shapes (the euclid store's)."""
    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import SearchConfig, StoreConfig, default_config
    from reverso_tpu_torch.engine import Reverso, _BinaryRescoreAdapter
    from reverso_tpu_torch.store import DeviceIndex, MultiVecIndex, PQIndex, VectorStore

    n, d = 100_000, unit.shape[1]
    pays = [{"folder": j % 10} for j in range(n)]
    subs, indptr = multivec_points(unit, n, seed=45)
    starts = np.concatenate([[0], indptr[:-1]])
    multi_rows = [subs[starts[j]:indptr[j]] for j in range(n)]
    stores = {"euclid": ("euclid", "bfloat16", rows[:n]),
              "manhattan": ("manhattan", "bfloat16", rows[:n]),
              "pq": ("cosine", "pq", unit[:n]), "multi": ("cosine", "bfloat16", unit[:n])}
    out = {}
    kernels.reset_counts()
    for name, (distance, dtype, data) in stores.items():
        t0 = time.perf_counter()
        with VectorStore.create(root, f"e_{name}", d, distance=distance,
                                multi={"regions": d} if name == "multi" else None) as st:
            for lo in range(0, n, 10_000):
                st.append(data[lo:lo + 10_000], pays[lo:lo + 10_000],
                          multi_vectors={"regions": multi_rows[lo:lo + 10_000]}
                          if name == "multi" else None)
        out[f"{name}_append_s"] = time.perf_counter() - t0
        cfg = default_config().replace(
            store=StoreConfig(root_dir=root, dtype=dtype),
            search=dataclasses.replace(SearchConfig(), pq_oversampling=3.0))
        eng = Reverso(cfg, device="cuda")
        check("Loaded" in eng.load_database(f"e_{name}"), f"load e_{name}")
        using = "regions" if name == "multi" else ""
        q = (np.stack([multi_rows[j][:1].repeat(4, 0) + queries[r, None] * np.float32(0.005)
                       for r, j in enumerate(np.arange(16) * 6_007)])
             if name == "multi" else np.array(data[np.arange(16) * 6_007]) + queries[:16] * np.float32(0.01))
        stored = np.asarray(VectorStore.open(root, f"e_{name}").vectors())
        if name == "pq":
            cache = os.path.join(root, f"e_{name}", "index")
            eng.search_batch(q, 10)
            files = os.listdir(cache)
            check(len(files) == 1 and files[0].startswith("pq_m128_100000_"), f"pq cache {files}")
            ref = _BinaryRescoreAdapter(PQIndex.load_cache(stored, os.path.join(cache, files[0]),
                                                           device="cpu"), stored, oversampling=3.0)
        elif name == "multi":
            ref = MultiVecIndex(*VectorStore.open(root, f"e_{name}").multivectors("regions"),
                                device="cpu")
        else:
            ref = DeviceIndex(stored, dtype=dtype, distance=distance, device="cpu")
        for filt in (None, {"folder": 3}):
            mask = None if filt is None else eng._filter_mask(filt)
            s, i = eng.search_batch(q, 10, filter=filt, using=using)
            rs, ri = ref.search(q, 10, row_mask=mask)
            rs, ri = (np.asarray(a.cpu() if hasattr(a, "cpu") else a) for a in (rs, ri))
            if name == "euclid":   # the ranking keys ||q||^2 - score^2, as in (E)
                qq = (q * q).sum(1, keepdims=True)
                topk_agree_scaled(qq - rs * rs, ri, qq - s * s, i, 1e-5)
            else:
                topk_agree_scaled(rs, ri, s, i, 1e-5)
            check(i.shape == (16, 10) and bool((i >= 0).all()), f"e_{name}: empty slots")
            if filt is not None:
                check(bool((i % 10 == 3).all()), f"e_{name}: the filter let a row through")
        s, i = eng.search_batch(q, 10, using=using)
        own = np.arange(16) * 6_007
        # pq ranks candidates by the codebook proxy: the own row within the
        # top 10 after the rescore; every exact index: at rank 0
        check(bool((i == own[:, None]).any(1).all()) if name == "pq"
              else bool((i[:, 0] == own).all()), f"e_{name}: a query's own row is not its best")
        out[f"{name}_search16_ms"] = sync_ms(torch, lambda: eng.search_batch(q, 10, using=using))
        out[f"{name}_filtered_search16_ms"] = sync_ms(
            torch, lambda: eng.search_batch(q, 10, filter={"folder": 3}, using=using))
        del eng, ref, stored
        torch.cuda.empty_cache()
    launches = dict(kernels.launches)
    shapes = {key: c for key, c in kernels.shape_launches.items()
              if key[0] in ("topk_stream", "topk_masked")}
    check(launches["topk_stream"] > 0 and launches["topk_masked"] > 0,
          f"the euclid store missed K1/K2: {launches}")
    print(f"engine stores (100k rows): {json.dumps(out)}", flush=True)
    return launches, shapes


def groups_agree(groups, scores: np.ndarray, key_of, n_groups: int, group_size: int,
                 tol: float, what: str) -> None:
    """`search_groups` output against a numpy group-by over `scores` (one
    query's score per row): every group's hits share its key, number
    min(group_size, rows with that key) and carry the key's best scores
    (within `tol`); the groups are the best `n_groups` keys by best score
    (a key whose best score is within `tol` of the cut may trade places)."""
    order = np.lexsort((np.arange(len(scores)), -scores))
    best, tops = {}, {}
    for r in order:
        kv = key_of(int(r))
        if kv is None:
            continue
        tops.setdefault(kv, [])
        if len(tops[kv]) < group_size:
            tops[kv].append(float(scores[r]))
        best.setdefault(kv, float(scores[r]))
    ranked = sorted(best.items(), key=lambda kv: -kv[1])
    cut = ranked[min(n_groups, len(ranked)) - 1][1]
    check(len(groups) == min(n_groups, len(ranked)), f"{what}: {len(groups)} groups")
    prev = np.inf
    for g in groups:
        kv, hits = g["key"], g["hits"]
        check(kv in best, f"{what}: unknown group {kv!r}")
        check(all(key_of(h["id"]) == kv for h in hits), f"{what}: a hit outside its group")
        got = [h["score"] for h in hits]
        check(len(got) == len(tops[kv]), f"{what}: group {kv!r} has {len(got)} hits")
        check(float(np.abs(np.asarray(got) - tops[kv]).max()) <= tol,
              f"{what}: group {kv!r} scores {got} vs {tops[kv]}")
        check(got[0] <= prev + tol and best[kv] >= cut - tol, f"{what}: group order")
        prev = got[0]


def surface_run(root: str) -> tuple:
    """(U) The query and write surface through `Reverso` on phase 7's
    1,000,000 x 1024 store (payloads {"folder": i % 10, "confidence": u},
    1% of the vectors deleted, its IVF cache): `query_batch` on the int8,
    binary + rescore and IVF engines (K9, K10, K11) against each engine's
    own `search_batch`; then, with the deleted rows written back
    (`update_vectors` through the store), on the bf16 engine:
    `query_batch` of 64 filtered and 64 plain requests (one K2 and one K1
    launch), each against its own `query()` and the plain scan of its
    subset; 16 hybrid requests (two dense branches under different
    filters, RRF): one scan a (space, limit, branch filter, global
    filter) group, each against its own `query()`; the other query forms
    at 1M, timed, and held against numpy twins on a 65,536-row store of
    the same rows; `search_groups` by filename on phase 6's region store;
    the mutations (upsert, update and delete vectors, delete points, set
    payload, one mixed `update_batch`), each timed with the time to its
    first search; the batcher (`warmup()`, then 64 threads of 8 queries).
    Returns (launches, top-k shapes, K11's by_shape rows, the numbers)."""
    import threading

    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import SearchConfig, StoreConfig, default_config
    from reverso_tpu_torch.engine import Reverso
    from reverso_tpu_torch.ops.recommend import (average_query, best_score_topk_host,
                                                 context_topk_host, discover_topk_host,
                                                 sum_scores_query)
    from reverso_tpu_torch.ops.topk import cosine_topk_ref
    from reverso_tpu_torch.store import VectorStore

    n, d, k = 1_000_000, 1024, 10
    kernels.reset_counts()
    t_phase = time.perf_counter()
    out = {}

    def engine(db="capacity", dtype="bfloat16", **search):
        cfg = default_config().replace(
            store=StoreConfig(root_dir=root, dtype=dtype),
            search=dataclasses.replace(SearchConfig(), **search))
        eng = Reverso(cfg, device="cuda")
        check("Loaded" in eng.load_database(db), f"load {db}")
        return eng

    def host_ms(fn):
        t = time.perf_counter()
        res = fn()
        return res, (time.perf_counter() - t) * 1e3

    def since(before):
        return {key: v - before.get(key, 0) for key, v in kernels.launches.items()
                if v != before.get(key, 0)}

    def arrays(hits, width):
        s = np.full((1, width), -np.inf, np.float32)
        i = np.full((1, width), -1, np.int32)
        for j, h in enumerate(hits[:width]):
            s[0, j], i[0, j] = h["score"], h["id"]
        return s, i

    vecs = np.asarray(VectorStore.open(root, "capacity").vectors())
    rng = np.random.default_rng(61)
    sel = np.arange(256) * 3_877 + 5
    q256 = vecs[sel] + rng.standard_normal((256, d), dtype=np.float32) * np.float32(0.02)
    q256 /= np.linalg.norm(q256, axis=1, keepdims=True)

    # (1) query_batch on the capacity engines; the store still holds
    # phase 7's deleted rows, so every scan is masked. K11's inputs are
    # captured at each shape, to time it against its plain version there
    captured = {}
    with ivf_inputs(captured):
        for dtype, search, counter in (("int8", {}, "topk_int8"),
                                       ("binary", {}, "topk_binary"),
                                       ("bfloat16", {"index": "ivf"}, "ivf_scan")):
            eng = engine(dtype=dtype, **search)
            _, index_ms = host_ms(eng._get_index)
            eng.count({"folder": 3})                  # the filter's payload column
            reqs = ([{"query": q256[j], "k": k} for j in range(32)]
                    + [{"query": q256[j], "k": k, "filter": {"folder": 3}}
                       for j in range(32, 64)])
            before = dict(kernels.launches)
            res, ms = host_ms(lambda: eng.query_batch(reqs, with_payload=False))
            got = since(before)
            check(got.get(counter, 0) == 2, f"{dtype} {search}: query_batch launches {got}")
            for rows, filt in ((slice(0, 32), None), (slice(32, 64), {"folder": 3})):
                s, i = eng.search_batch(q256[rows], k, filter=filt)
                for r, hits in zip(range(rows.start, rows.stop), res[rows]):
                    hs, hi = arrays(hits, k)
                    fin = hi[0] >= 0
                    check(np.array_equal(hi[0][fin], i[r - rows.start][:fin.sum()])
                          and np.allclose(hs[0][fin], s[r - rows.start][:fin.sum()],
                                          atol=1e-6),
                          f"{dtype} {search}: query_batch differs from search_batch")
            out[f"{counter}_query_batch64_ms"] = ms
            out[f"{counter}_index_ms"] = index_ms
            del eng
            torch.cuda.empty_cache()

    # (2) write the deleted rows back (update_vectors resurrects them), so
    # that a plain scan is K1's plain mode
    with VectorStore.open(root, "capacity", writable=True) as w:
        gone = w.deleted_rows()
        w.update_vectors(gone.tolist(), np.array(vecs[gone]))
        check(w.deleted_rows().size == 0, "deleted rows remain")

    eng = engine()
    index, ms = host_ms(eng._get_index)
    out["bf16_index_build_ms"] = ms
    folder = np.arange(n) % 10
    q_dev = torch.from_numpy(q256).cuda()

    # (3) query_batch: 64 requests that share {"folder": 3}, 64 without
    reqs = ([{"query": q256[j], "k": k, "filter": {"folder": 3}} for j in range(64)]
            + [{"query": q256[j], "k": k} for j in range(64, 128)])
    eng.query_batch(reqs[:2])                                   # warm the columns
    before = dict(kernels.launches)
    res, out["query_batch128_ms"] = host_ms(lambda: eng.query_batch(reqs))
    got = since(before)
    check(got == {"topk_masked": 1, "topk_stream": 1}, f"query_batch launches {got}")
    mask3 = torch.from_numpy(folder == 3).cuda()
    rs, ri = cosine_topk_ref(index.matrix, q_dev[:128], k)
    rsm, rim = cosine_topk_ref(index.matrix, q_dev[:64], k, row_mask=mask3)
    t = time.perf_counter()
    seq = [eng.query(**r) for r in reqs]
    out["sequential_query128_ms"] = (time.perf_counter() - t) * 1e3
    for j in range(len(reqs)):
        hs, hi = arrays(res[j], k)
        ss, si = arrays(seq[j], k)
        topk_agree(torch.from_numpy(ss), torch.from_numpy(si), torch.from_numpy(hs),
                   torch.from_numpy(hi), 1e-4, f"query_batch request {j} vs query()")
        ref = (rsm[j:j + 1], rim[j:j + 1]) if j < 64 else (rs[j:j + 1], ri[j:j + 1])
        topk_agree(*ref, torch.from_numpy(hs), torch.from_numpy(hi), 1e-4,
                   f"query_batch request {j} vs the plain scan")
        check(j >= 64 or bool((folder[hi[0]] == 3).all()), "a filtered hit outside folder 3")

    # (4) hybrid: 16 requests of two dense branches under different filters
    # (the confidence column read first, and timed on its own)
    _, out["confidence_column_ms"] = host_ms(lambda: eng.count("confidence>=0.5"))
    hyb = [{"prefetch": [{"query": q256[j], "limit": 20, "filter": {"folder": 1}},
                         {"query": q256[j + 16], "limit": 20,
                          "filter": "confidence>=0.5"}], "k": k}
           for j in range(128, 144)]
    before = dict(kernels.launches)
    res, out["hybrid16_ms"] = host_ms(lambda: eng.query_batch(hyb))
    got = since(before)
    check(got == {"topk_masked": 2}, f"hybrid query_batch launches {got}")
    for j, r in enumerate(hyb):
        check([h["id"] for h in res[j]] == [h["id"] for h in eng.query(**r)],
              f"hybrid request {j} differs from its query()")
        check(len(res[j]) == k, f"hybrid request {j}: {len(res[j])} hits")

    # (5) the other query forms at 1M (timed), then against numpy twins
    p, m = [11, 5_000, 60_000], [123]
    forms = {
        "recommend_average": dict(query={"recommend": {
            "positive": p[:2], "negative": m, "strategy": "average_vector"}}, k=k),
        "recommend_sum_scores": dict(query={"recommend": {
            "positive": p, "negative": m, "strategy": "sum_scores"}}, k=k),
        "recommend_best_score": dict(query={"recommend": {
            "positive": p, "negative": m, "strategy": "best_score"}}, k=k),
        "discover": dict(query={"discover": {"target": p[0], "context": [
            {"positive": p[1], "negative": m[0]}, {"positive": p[2], "negative": 7}]}}, k=k),
        "context": dict(query={"context": [(p[1], m[0]), (p[2], 7)]}, k=k),
        "mmr": dict(query={"nearest": q256[200], "mmr": {"diversity": 0.5}},
                    prefetch=[{"query": q256[200], "limit": 100}], k=k),
        "formula": dict(query={"formula": {"sum": ["$score", {"mult": [0.05, "confidence"]}]}},
                        prefetch=[{"query": q256[201], "limit": 50}], k=k),
        "order_by": dict(query={"order_by": {"key": "confidence", "direction": "desc"}}, k=k),
        "random": dict(query={"sample": "random"}, k=20, seed=7),
    }
    reads = {
        "scroll": lambda e: e.scroll({"folder": 3}, limit=100),
        "retrieve": lambda e: e.retrieve([5, 70, 65_535], with_vectors=True),
        "facet": lambda e: e.facet("folder"),
        "search_matrix": lambda e: e.search_matrix(sample=64, limit=3, seed=1),
        "search_groups": lambda e: e.search_groups(-1.0, 10, embeddings=q256[202:203],
                                                   group_by="folder", group_size=3),
    }
    for name, kw in forms.items():
        res, out[f"{name}_ms"] = host_ms(lambda: eng.query(**kw))
        check(len(res) == kw["k"] and all(np.isfinite(h["score"]) for h in res),
              f"{name} at 1M: {len(res)} hits")
    for name, fn in reads.items():
        res, out[f"{name}_ms"] = host_ms(lambda: fn(eng))
        check(bool(res), f"{name} at 1M returned nothing")

    sub_n = 65_536
    sub_pays = VectorStore.open(root, "capacity").payloads(list(range(sub_n)))
    with VectorStore.create(root, "u_sub", d) as st:
        st.append(np.array(vecs[:sub_n]), sub_pays)
    sub = engine("u_sub")
    mat = sub._get_index().matrix[:, :d].float().cpu().numpy().astype(np.float64)
    raw = np.array(vecs[:sub_n], np.float64)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()
    sfolder = folder[:sub_n]
    sconf = np.array([pl["confidence"] for pl in sub_pays], np.float64)

    def twin(scores, width, drop=()):
        s = np.array(scores, np.float64)
        s[list(drop)] = -np.inf
        o = np.lexsort((np.arange(len(s)), -s))[:width]
        return s[None, o], o[None].astype(np.int32)

    def agree(name, got, ref, tol=1e-4):
        hs, hi = arrays(got, ref[1].shape[1])
        topk_agree_scaled(ref[0], ref[1], hs, hi, tol)
        print(f"U twin {name}: ok", flush=True)

    ex = lambda ids: raw[ids]
    agree("recommend_average", sub.query(**forms["recommend_average"]),
          twin(mat @ bf(average_query(ex(p[:2]), ex(m))), k, p[:2] + m))
    agree("recommend_sum_scores", sub.query(**forms["recommend_sum_scores"]),
          twin(mat @ bf(sum_scores_query(ex(p), ex(m))), k, p + m))
    keep = np.ones(sub_n, bool)
    keep[p + m] = False
    agree("recommend_best_score", sub.query(**forms["recommend_best_score"]),
          best_score_topk_host(mat, bf(ex(p)), bf(ex(m)), k, row_mask=keep))
    keep[7] = False
    agree("discover", sub.query(**forms["discover"]),
          discover_topk_host(mat, bf(ex(p[0])), bf(ex(p[1:])), bf(ex([m[0], 7])), k,
                             row_mask=keep))
    keep[p[0]] = True
    agree("context", sub.query(**forms["context"]),
          context_topk_host(mat, bf(ex(p[1:])), bf(ex([m[0], 7])), k, row_mask=keep))
    # MMR over the 100-row prefetch pool: relevance is the exact fp32
    # rescore; each pick must maximize the objective over the pool
    qv = q256[200].astype(np.float64)
    pool_s, pool = twin(mat @ bf(qv), 100)
    got = sub.query(**forms["mmr"])
    rel = raw @ qv
    chosen, max_sim = [], np.full(sub_n, -np.inf)
    for step, h in enumerate(got):
        check(pool_s[0, -1] - 1e-4 <= mat[h["id"]] @ bf(qv), "MMR picked outside the pool")
        check(abs(h["score"] - rel[h["id"]]) <= 1e-5, "MMR relevance is not the exact rescore")
        cand = [c for c in pool[0] if c not in chosen]
        obj = rel[cand] if step == 0 else 0.5 * rel[cand] - 0.5 * max_sim[cand]
        mine = rel[h["id"]] if step == 0 else 0.5 * rel[h["id"]] - 0.5 * max_sim[h["id"]]
        check(mine >= obj.max() - 1e-4, f"MMR step {step} is not the best objective")
        chosen.append(h["id"])
        max_sim = np.maximum(max_sim, raw @ raw[h["id"]])
    print("U twin mmr: ok", flush=True)
    cs, ci = twin(mat @ bf(q256[201]), 50)
    val = cs[0] + 0.05 * sconf[ci[0]]
    o = np.lexsort((ci[0], -val))[:k]
    agree("formula", sub.query(**forms["formula"]), (val[None, o], ci[:, o]))
    got = sub.query(**forms["order_by"])
    want = np.lexsort((np.arange(sub_n), -sconf))[:k]
    check([h["id"] for h in got] == want.tolist(), "order_by differs from the numpy sort")
    def distinct_draw(seed, count):
        """The engine's seeded draw of `count` distinct rows, in numpy."""
        draw = np.random.default_rng(seed)
        pick, seen = [], set()
        while len(pick) < count:
            for v in draw.integers(0, sub_n, size=2 * (count - len(pick))):
                if int(v) not in seen:
                    seen.add(int(v))
                    pick.append(int(v))
                    if len(pick) == count:
                        break
        return pick

    check([h["id"] for h in sub.query(**forms["random"])] == distinct_draw(7, 20),
          "the seeded sample differs from its numpy draw")
    pts, nxt = reads["scroll"](sub)
    f3 = np.nonzero(sfolder == 3)[0]
    check([pt["id"] for pt in pts] == f3[:100].tolist() and nxt == int(f3[100]), "scroll")
    pts = reads["retrieve"](sub)
    check([pt["id"] for pt in pts] == [5, 70, 65_535] and all(
        np.array_equal(np.asarray(pt["vector"]), vecs[pt["id"]]) and
        pt["payload"]["folder"] == pt["id"] % 10 for pt in pts), "retrieve")
    vals, cnts = np.unique(sfolder, return_counts=True)
    want = sorted(zip(vals.tolist(), cnts.tolist()), key=lambda vc: (-vc[1], str(vc[0])))
    check([(f["value"], f["count"]) for f in reads["facet"](sub)] == want, "facet")
    ids = np.sort(distinct_draw(1, 64))
    g = np.asarray(vecs[ids], np.float64) @ np.asarray(vecs[ids], np.float64).T
    np.fill_diagonal(g, -np.inf)
    order = np.argsort(-g, axis=1, kind="stable")[:, :3]
    pairs = reads["search_matrix"](sub)
    ps = np.array([pr["score"] for pr in pairs], np.float32).reshape(64, 3)
    pc = np.searchsorted(ids, [pr["id_b"] for pr in pairs]).reshape(64, 3)
    check([pr["id_a"] for pr in pairs[::3]] == ids.tolist(), "search_matrix rows")
    topk_agree_scaled(np.take_along_axis(g, order, 1), order, ps, pc, 1e-5)
    groups = reads["search_groups"](sub)[1]
    groups_agree(groups, mat @ bf(q256[202]), lambda r: int(sfolder[r]), 10, 3, 1e-4,
                 "search_groups by folder")
    print("U twins: every form agrees", flush=True)
    del sub, mat, raw

    # (6) search_groups by filename on phase 6's region store
    cfg = default_config().replace(store=StoreConfig(root_dir=os.path.join(root, "region_db")))
    reng = Reverso(cfg, device="cuda")
    check("Loaded" in reng.load_database("regions"), "load the region store")
    rstore = VectorStore.open(cfg.store.root_dir, "regions")
    rvec = np.asarray(rstore.vectors())
    names = [pl.get("filename") for pl in rstore.payloads(list(range(rstore.count)))]
    rmat = reng._get_index().matrix[:, :d].float().cpu().numpy().astype(np.float64)
    for r in (0, len(rvec) // 2):
        text, groups = reng.search_groups(-1.0, 5, embeddings=rvec[r:r + 1],
                                          group_by="filename", group_size=3)
        groups_agree(groups, rmat @ bf(rvec[r]), lambda i: names[i], 5, 3, 1e-4,
                     "search_groups by filename")
    out["region_groups_rows"] = int(rstore.count)
    del reng, rmat

    # (7) the mutations, each timed, then the time to its first search
    count0 = n
    new = rng.standard_normal((1_000, d), dtype=np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    new_pays = [{"folder": j % 10, "confidence": 0.5} for j in range(1_000)]
    status, out["upsert1000_ms"] = host_ms(lambda: eng.upsert_points(new, new_pays))
    check(status.startswith("✅ Upserted 1000 points"), status)
    (s, i), out["upsert1000_first_search_ms"] = host_ms(lambda: eng.search_batch(new, 1))
    check(bool((i[:, 0] == np.arange(count0, count0 + 1_000)).all()),
          "an upserted row is not its own top-1")
    upd = np.arange(100) * 9_973 + 7
    newv = rng.standard_normal((100, d), dtype=np.float32)
    newv /= np.linalg.norm(newv, axis=1, keepdims=True)
    status, out["update_vectors100_ms"] = host_ms(lambda: eng.update_vectors(upd.tolist(), newv))
    check(status.startswith("✅ Updated vectors of 100"), status)
    (s, i), out["update_vectors100_first_search_ms"] = host_ms(
        lambda: eng.search_batch(newv, 1))
    check(bool((i[:, 0] == upd).all()), "an updated row does not find itself")
    dele = np.arange(100) * 9_967 + 11
    qd = np.array(vecs[dele])
    status, out["delete_vectors100_ms"] = host_ms(lambda: eng.delete_vectors(dele.tolist()))
    check(status.startswith("✅ Deleted vectors ('') of 100"), status)
    (s, i), out["delete_vectors100_first_search_ms"] = host_ms(
        lambda: eng.search_batch(qd, k))
    s2, i2 = eng.search_batch(qd, k, filter={"folder": 1})
    check(not (set(i.ravel().tolist()) | set(i2.ravel().tolist())) & set(dele.tolist()),
          "a deleted vector came back")
    n9 = int((folder == 9).sum()) + sum(pl["folder"] == 9 for pl in new_pays)
    count1 = count0 + 1_000
    status, out["delete_points_folder9_ms"] = host_ms(
        lambda: eng.delete_points(filter={"folder": 9}))
    check(status == f"✅ Deleted {n9} points from capacity", status)
    _, out["delete_points_first_search_ms"] = host_ms(lambda: eng.search_batch(q256[:64], k))
    check(eng.count() == count1 - n9 and eng.count({"folder": 9}) == 0,
          f"count after delete_points: {eng.count()} vs {count1 - n9}")
    count2 = count1 - n9
    before_index = eng._get_index()
    tagged = np.arange(1_000) * 887
    status, out["set_payload1000_ms"] = host_ms(
        lambda: eng.set_payload({"tag": "u"}, points=tagged.tolist()))
    check(status.startswith("✅ Updated payload of 1000"), status)
    check(eng._indexes[""][1] is before_index, "a payload-only mutation dropped the index")
    (s, i), out["set_payload_first_search_ms"] = host_ms(
        lambda: eng.search_batch(q256[:64], k, filter={"tag": "u"}))
    check(eng.count({"tag": "u"}) == 1_000 and set(i[i >= 0].tolist()) <= set(tagged.tolist()),
          "the tag filter does not select exactly the tagged rows")
    check(eng._get_index() is before_index, "the index was rebuilt after a payload mutation")
    b_new = rng.standard_normal((10, d), dtype=np.float32)
    b_new /= np.linalg.norm(b_new, axis=1, keepdims=True)
    b_upd = rng.standard_normal((2, d), dtype=np.float32)
    b_upd /= np.linalg.norm(b_upd, axis=1, keepdims=True)
    batch = [{"upsert": {"vectors": b_new, "payloads": [{"folder": 4}] * 10}},
             {"update_vectors": {"points": [5, 6], "vectors": b_upd}},
             {"delete_vectors": {"points": [7, 8]}},
             {"set_payload": {"payload": {"batch": 1}, "points": [9, 10]}},
             {"delete": {"points": [11]}}]
    status, out["update_batch_ms"] = host_ms(lambda: eng.update_batch(batch))
    check(status.startswith("✅ Applied 5 operations"), status)
    (s, i), out["update_batch_first_search_ms"] = host_ms(
        lambda: eng.search_batch(np.concatenate([b_new, b_upd]), 1))
    count3 = count2 + 10 - 1
    check(eng.count() == count3 and bool(
        (i[:10, 0] == np.arange(count3 - 10, count3)).all())
        and i[10:, 0].tolist() == [5, 6], f"update_batch: {i[:, 0]}")
    check(eng.count({"batch": 1}) == 2, "update_batch set_payload")

    # (8) the batcher: warmup(), then 64 threads of 8 single queries
    out["warmup"], out["warmup_ms"] = host_ms(eng.warmup)
    check(out["warmup"] == "warmed: encoder, search", out["warmup"])
    qb = q256[:64].repeat(8, 0) + rng.standard_normal((512, d), dtype=np.float32) * \
        np.float32(0.01)
    qb /= np.linalg.norm(qb, axis=1, keepdims=True)
    want_s, want_i = (np.concatenate(a) for a in zip(
        eng.search_batch(qb[:256], k), eng.search_batch(qb[256:], k)))
    searcher = eng.searcher
    stats0 = searcher.stats()
    shapes0 = collections.Counter(kernels.shape_launches)
    lat = [0.0] * 512
    got = [None] * 512
    barrier = threading.Barrier(64)

    def client(t):
        barrier.wait()
        for j in range(8):
            r = t * 8 + j
            t0 = time.perf_counter()
            got[r] = searcher.search(qb[r], k)
            lat[r] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client, args=(t,)) for t in range(64)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    out["batcher512_wall_ms"] = (time.perf_counter() - t0) * 1e3
    check(not any(th.is_alive() for th in threads), "a batcher client hung")
    stats = searcher.stats()
    served = stats["served"] - stats0["served"]
    launched = stats["launches"] - stats0["launches"]
    check(served == 512 and launched < served, f"batcher: {launched} launches, {served} served")
    for r in range(512):
        topk_agree(torch.from_numpy(want_s[r:r + 1]), torch.from_numpy(want_i[r:r + 1]),
                   torch.from_numpy(got[r][0][None]), torch.from_numpy(got[r][1][None]), 1e-4,
                   f"batcher request {r} vs search_batch")
    buckets = collections.Counter()
    for (kind, shape), c in (collections.Counter(kernels.shape_launches) - shapes0).items():
        if kind in ("topk_stream", "topk_masked"):
            buckets[f"Q={shape[0]} k={shape[3]}"] += c
    out["batcher"] = dict(launches=launched, served=served, shed=stats["shed"],
                          p50_ms=float(np.percentile(lat, 50)),
                          p99_ms=float(np.percentile(lat, 99)), batches=dict(buckets))
    searcher.close()
    del eng, index
    torch.cuda.empty_cache()

    launches = dict(kernels.launches)
    shapes = {key: c for key, c in kernels.shape_launches.items()
              if key[0] in ("topk_stream", "topk_masked", "topk_int8", "topk_binary")}
    ivf_counts = {key: c for key, c in kernels.shape_launches.items() if key[0] == "ivf_scan"}
    for name in ("topk_stream", "topk_masked", "topk_int8", "topk_binary", "ivf_scan"):
        check(launches[name] > 0, f"kernel {name} never launched on the surface path")
    out["launches"] = {key: c for key, c in launches.items() if c}
    out["plain_dispatches"] = dict(kernels.plain_dispatches)

    ivf_rows = ivf_path_shapes(torch, ivf_counts, captured, "surface")
    captured.clear()
    out["phase_s"] = time.perf_counter() - t_phase
    return launches, shapes, ivf_rows, out


def write_clip_bpe(folder: str, words) -> tuple:
    """A CLIP BPE vocab and merges of the published size (49,408 entries):
    the 256 byte symbols and their `</w>` forms, one merge chain per word of
    `words` (so each tokenizes to one id), fillers, then <|startoftext|> at
    49,406 and <|endoftext|> at 49,407, where `ClipTextConfig` pools.
    Returns (vocab path, merges path)."""
    from reverso_tpu_torch.detect.clipbpe import bytes_to_unicode
    b2u = bytes_to_unicode()
    syms = [b2u[b] for b in range(256)]
    vocab = {s: i for i, s in enumerate(syms + [s + "</w>" for s in syms])}
    merges = []
    for w in words:
        pieces = [b2u[b] for b in w.encode()]
        pieces[-1] += "</w>"
        head = pieces[0]
        for nxt in pieces[1:]:
            if (head, nxt) not in merges:
                merges.append((head, nxt))
            head += nxt
            vocab.setdefault(head, len(vocab))
    for i in range(len(vocab), 49406):
        vocab[f"<|filler{i}|>"] = i
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    paths = (os.path.join(folder, "vocab.json"), os.path.join(folder, "merges.txt"))
    with open(paths[0], "w") as f:
        json.dump(vocab, f)
    with open(paths[1], "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return paths


def write_hsv_clip(path: str, scenes: int, frames_per_scene: int) -> None:
    """An MJPG clip of `scenes` flat colors (plus noise), 15 fps."""
    import cv2
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 15, (96, 64))
    check(w.isOpened(), "cv2.VideoWriter did not open")
    rng = np.random.default_rng(4)
    palette = [(0, 0, 120), (0, 230, 0), (120, 0, 120), (0, 120, 230)]
    for s in range(scenes):
        for _ in range(frames_per_scene):
            frame = np.full((64, 96, 3), palette[s % len(palette)], np.uint8)
            w.write(frame + rng.integers(0, 10, frame.shape, dtype=np.uint8))
    w.release()


def entry_points_run(root: str) -> tuple:
    """(EP) The entry points on the card, as a user starts them: (a)
    `reverso_tpu_torch.cli.main` in this process (its default device,
    CUDA): `build` of 128 synthetic PNGs with `--direct-pe` at the default
    PE-Core-L14-336 (bf16, seeded), `search` of one of them (top-1 must be
    that file) and the same search under a payload filter; (b) the same
    search in a subprocess with `jax` and `flax` blocked, which must load
    no module of the JAX package; (c) the CLIP text tower at
    `ClipTextConfig()`'s full width (768 wide, 12 layers, 12 heads,
    context 77, vocab 49,408, into 1024), seeded, in fp32, written with
    `save_params` and loaded through `REVERSO_CLIP_TEXT_CKPT` on a
    synthetic vocab of the published size: 64 prompts on the card against
    the same tower on the CPU, `search-text` through the CLI, the forward
    timed at B = 1 and 64; (d) the web UI (`create_server`) over a card
    engine: /api/about, a detect + search, a filtered search and a text
    search over HTTP, ids against the engine's direct calls, each
    request's ms; (e) `content_scores_batched` on a seeded [600, 144, 256,
    3] HSV stack against a numpy loop, and, where OpenCV imports, `video
    local` on a written clip and a `build` of its frames. The counts are
    set to 0 at the start and read at the end, less the launches of the
    engine's direct calls that (d) holds the UI against: K3, K4, K1 and
    K2 must each have launched under the CLI. Returns (launches, K3 and
    K4 launches by shape, K1 and K2 launches by shape, numbers)."""
    import base64
    import io
    import threading
    import urllib.request
    from contextlib import redirect_stdout

    import torch
    from reverso_tpu_torch import cli, kernels
    from reverso_tpu_torch.ingest.video import content_scores_batched, content_scores_tensor
    from reverso_tpu_torch.models.checkpoint import save_params
    from reverso_tpu_torch.models.cliptext import ClipTextConfig, TextEmbedder
    from reverso_tpu_torch.models.convert import flax_params_from_text
    from reverso_tpu_torch.models.pe import resolve_device
    from reverso_tpu_torch.ui.server import create_server

    dev = resolve_device(None)    # the entry points' default: the card
    kernels.reset_counts()
    t_phase = time.perf_counter()
    out = {}
    folder = os.path.join(root, "ep_images")
    os.makedirs(folder)
    make_images(folder, 128, seed=3)
    db_root = os.path.join(root, "ep_db")
    query, qname = os.path.join(folder, "img_0041.png"), "img_0041.png"

    def run_cli(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            rc = cli.main(["--db-root", db_root] + list(argv))
        return rc, buf.getvalue(), (time.perf_counter() - t0) * 1e3

    # (a) the command line in this process
    rc, text, out["cli_build_ms"] = run_cli("build", folder, "--name", "cli", "--direct-pe")
    check(rc == 0 and "ready for searching" in text, f"cli build: rc {rc}: {text}")
    rc, text, out["cli_search_ms"] = run_cli("search", query, "--name", "cli", "--json",
                                             "--threshold", "-1", "--top-k", "5")
    hits = json.loads(text)
    check(rc == 0 and len(hits) == 5 and hits[0]["filename"] == qname,
          f"cli search: top-1 is not {qname}: {hits}")
    rc, text, out["cli_search_filtered_ms"] = run_cli(
        "search", query, "--name", "cli", "--json", "--threshold", "-1", "--top-k", "5",
        "--filter", f"filename!={qname}")
    fhits = json.loads(text)
    check(rc == 0 and len(fhits) == 5 and qname not in [h["filename"] for h in fhits]
          and [h["filename"] for h in fhits] == [h["filename"] for h in hits[1:]]
          + [fhits[-1]["filename"]], f"cli filtered search: {fhits} against {hits}")
    cli_launches = dict(kernels.launches)
    print(f"entry points: cli build {out['cli_build_ms']:.1f} ms, search "
          f"{out['cli_search_ms']:.1f} ms, filtered {out['cli_search_filtered_ms']:.1f} ms "
          f"(each with its engine and seeded tower); top-5 {[h['filename'] for h in hits]}",
          flush=True)

    # (b) the same search in a process with JAX blocked
    code = ("import sys, json; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "from reverso_tpu_torch import cli\n"
            f"rc = cli.main(['--db-root', {db_root!r}, 'search', {query!r}, '--name', 'cli',"
            " '--json', '--threshold', '-1', '--top-k', '5'])\n"
            "assert rc == 0, rc\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'reverso_tpu'], 'jax pkg'\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    out["subprocess_search_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"jax-blocked cli search failed:\n{proc.stderr[-3000:]}")
    sub_hits = json.loads(proc.stdout)
    check([h["filename"] for h in sub_hits] == [h["filename"] for h in hits],
          f"jax-blocked cli search: {sub_hits} against {hits}")

    # (c) the text tower at full width, fp32
    cfg = ClipTextConfig()
    check((cfg.width, cfg.depth, cfg.num_heads, cfg.context_length, cfg.embed_dim,
           cfg.vocab_size, cfg.dtype) == (768, 12, 12, 77, 1024, 49408, "float32"),
          f"ClipTextConfig() changed: {cfg}")
    colors = ["red", "blue", "green", "white", "black", "yellow", "grey", "orange"]
    things = ["car", "person", "building", "street", "truck", "boat", "tree", "sign"]
    words = colors + things + ["a", "at", "night", "near", "the", "with"]
    vocab, merges = write_clip_bpe(root, words)
    prompts = [f"a {c} {t} at night" if i % 2 else f"the {c} {t} near a {things[i % 8]}"
               for i, (c, t) in enumerate((c, t) for c in colors for t in things)]
    t0 = time.perf_counter()
    seeded = TextEmbedder(cfg, None, None, device="cpu", seed=7)
    ckpt = os.path.join(root, "cliptext.msgpack")
    save_params(ckpt, flax_params_from_text(seeded.module.state_dict()),
                meta={"config": dataclasses.asdict(cfg)})
    del seeded
    out["text_write_s"] = time.perf_counter() - t0
    os.environ.update(REVERSO_CLIP_TEXT_CKPT=ckpt, REVERSO_CLIP_VOCAB=vocab,
                      REVERSO_CLIP_MERGES=merges)
    t0 = time.perf_counter()
    card = TextEmbedder.from_pretrained(ckpt, vocab, merges)
    out["text_load_s"] = time.perf_counter() - t0
    host = TextEmbedder.from_pretrained(ckpt, vocab, merges, device="cpu")
    check(card.device == dev and card.tokenizer.eot == cfg.eot_token_id
          and card.tokenizer.sot == 49406, "tokenizer's sot / eot ids")
    ids = card.tokenizer(prompts)
    eot_at = (ids == cfg.eot_token_id).argmax(1)
    check(len(prompts) == 64 and bool((eot_at > 3).all())
          and all((r[1:e] != 0).all() for r, e in zip(ids, eot_at)),
          f"prompts tokenized to unknown pieces or no eot: {ids[:4]}")
    got, want = card.embed(prompts), host.embed(prompts)
    err = float(np.abs(got - want).max())
    out["text_max_abs_err"] = err
    check(got.shape == (64, cfg.embed_dim) and np.isfinite(got).all()
          and np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5), "text embeddings")
    check(err <= 2e-5, f"text tower card vs CPU: max abs err {err:.3g} > 2e-5 (fp32)")
    ids_dev = torch.as_tensor(ids.astype(np.int64), device=dev)
    with torch.inference_mode():
        out["text_fwd_ms_b1"] = cuda_ms(lambda: card.module(ids_dev[:1]))
        out["text_fwd_ms_b64"] = cuda_ms(lambda: card.module(ids_dev))
    # the least time of a forward: its fp32 products (projections, the MLP,
    # the full L x L scores and PV, the pooled projection) at the CUDA
    # cores' rate, or its weights read once
    n_params = sum(p.numel() for p in card.module.parameters())
    for b in (1, 64):
        toks, w, l = b * cfg.context_length, cfg.width, cfg.context_length
        ops = cfg.depth * toks * (24 * w * w + 4 * l * w) + 2 * b * w * cfg.embed_dim
        out[f"text_bound_ms_b{b}"], out[f"text_bound_by_b{b}"] = bound(
            4 * n_params + 8 * toks + 4 * b * cfg.embed_dim, ops, "float32")
    rc, text, out["cli_search_text_ms"] = run_cli("search-text", prompts[1], "--name", "cli",
                                                  "--json", "--threshold", "-1", "--top-k", "5")
    thits = json.loads(text)
    check(rc == 0 and len(thits) == 5 and all(np.isfinite(h["score"]) for h in thits),
          f"cli search-text: {thits}")
    print(f"entry points: text tower fp32 card vs CPU max abs err {err:.3g}; forward "
          f"{out['text_fwd_ms_b1']:.4f} ms at B = 1, {out['text_fwd_ms_b64']:.4f} ms at B = 64; "
          f"search-text {out['cli_search_text_ms']:.1f} ms", flush=True)

    # (d) the web UI over a card engine
    engine = cli._make_engine(cli.build_parser().parse_args(["--db-root", db_root, "list"]))
    check(engine.device == dev and engine.text_embedder is not None, "UI engine")
    check(engine.load_database("cli").startswith("✅"), "UI engine: load cli")
    srv = create_server(engine, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def request(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, method="GET" if data is None
                                     else "POST", headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = json.loads(r.read())
        return reply, (time.perf_counter() - t0) * 1e3

    try:
        about, out["ui_about_ms"] = request("/api/about")
        check(about.get("backend") == dev.type, f"/api/about: {about}")
        with open(query, "rb") as f:
            image = base64.b64encode(f.read()).decode()
        det, out["ui_detect_ms"] = request("/api/query/detect",
                                           {"image": image, "direct_pe": True})
        res, out["ui_search_ms"] = request("/api/query/search", {
            "token": det["token"], "threshold": -1.0, "max_results": 5})
        flt = {"must_not": [{"key": "filename", "match": {"value": qname}}]}
        fres, out["ui_search_filtered_ms"] = request("/api/query/search", {
            "token": det["token"], "threshold": -1.0, "max_results": 5, "filter": flt})
        tres, out["ui_search_text_ms"] = request("/api/query/search_text", {
            "text": prompts[1], "threshold": -1.0, "max_results": 5})
        from PIL import Image
        # the engine's direct calls only check the UI's ids: their launches
        # are taken out of the phase's counts
        before = (collections.Counter(kernels.launches),
                  collections.Counter(kernels.shape_launches))
        engine.process_image_direct_pe(Image.open(query))
        direct = engine.search_similar(-1.0, 5)[1]
        direct_f = engine.search_similar(-1.0, 5, filter=flt)[1]
        direct_t = engine.search_by_text(prompts[1], -1.0, 5)[1]
        check_launches = collections.Counter(kernels.launches) - before[0]
        check_shapes = collections.Counter(kernels.shape_launches) - before[1]
        for what, ui, eng in (("search", res["results"], direct),
                              ("filtered search", fres["results"], direct_f),
                              ("text search", tres["results"], direct_t)):
            check(len(ui) == 5 and [r["id"] for r in ui] == [it["id"] for it in eng],
                  f"UI {what}: {[r['id'] for r in ui]} against the engine's "
                  f"{[it['id'] for it in eng]}")
        check(res["results"][0]["filename"] == qname, f"UI search top-1: {res['results'][0]}")
    finally:
        srv.shutdown()
        thread.join(timeout=10)
        engine.searcher.close()
    print(f"entry points: UI about {out['ui_about_ms']:.1f} ms, detect {out['ui_detect_ms']:.1f}, "
          f"search {out['ui_search_ms']:.1f}, filtered {out['ui_search_filtered_ms']:.1f}, "
          f"text {out['ui_search_text_ms']:.1f} ms", flush=True)
    del engine, card, host

    # (e) the video scorer on the card, and OpenCV where it imports
    rng = np.random.default_rng(6)     # two scenes: a still image each, plus noise
    scenes = rng.integers(0, 246, (2, 1, 144, 256, 3), dtype=np.uint8)
    hsv = rng.integers(0, 10, (600, 144, 256, 3), dtype=np.uint8)
    hsv[:300] += scenes[0]
    hsv[300:] += scenes[1]
    scores = content_scores_batched(hsv)
    loop = np.array([np.abs(hsv[i + 1].astype(np.int16) - hsv[i]).mean(axis=(0, 1)).sum() / 3.0
                     for i in range(len(hsv) - 1)])
    out["scorer_max_abs_err"] = float(np.abs(scores - loop).max())
    check(scores.shape == (599,) and out["scorer_max_abs_err"] <= 1e-4
          and int(scores.argmax()) == 299,
          f"content_scores_batched: max abs err {out['scorer_max_abs_err']:.3g}")
    out["scorer_ms"] = sync_ms(torch, lambda: content_scores_batched(hsv))
    hsv_dev = torch.as_tensor(hsv, device=dev)
    out["scorer_device_ms"] = cuda_ms(lambda: content_scores_tensor(hsv_dev))
    out["scorer_bound_ms"], out["scorer_bound_by"] = bound(hsv.nbytes + 4 * (len(hsv) - 1),
                                                           3 * hsv.size, "float32")
    del hsv_dev
    try:
        import cv2
        out["cv2"] = cv2.__version__
    except ImportError:
        out["cv2"] = None
    if out["cv2"]:
        vids, frames = os.path.join(root, "ep_vids"), os.path.join(root, "ep_frames")
        os.makedirs(vids)
        write_hsv_clip(os.path.join(vids, "clip.avi"), scenes=3, frames_per_scene=20)
        rc, text, out["cli_video_local_ms"] = run_cli("video", "local", vids, frames)
        check(rc == 0 and text.startswith("✅ Completed!"), f"cli video local: {text}")
        out["video_frames"] = len(os.listdir(frames))
        rc, text, out["cli_build_frames_ms"] = run_cli("build", frames, "--name", "frames",
                                                       "--direct-pe")
        check(rc == 0 and out["video_frames"] > 0 and "ready for searching" in text,
              f"cli build of the video frames: {text}")
    print(f"entry points: scorer {out['scorer_ms']:.3f} ms (call), "
          f"{out['scorer_device_ms']:.4f} ms on the card, max abs err "
          f"{out['scorer_max_abs_err']:.3g}; cv2 {out['cv2']}", flush=True)

    launches = collections.Counter(kernels.launches) - check_launches
    shapes = collections.Counter(kernels.shape_launches) - check_shapes
    for name, label in (("flash_heads_tc", "K3"), ("fused_mlp_tc", "K4"),
                        ("topk_stream", "K1"), ("topk_masked", "K2")):
        out[f"{label}_launches"] = launches[name]
        out[f"{label}_check_launches"] = check_launches[name]
        check(cli_launches[name] > 0, f"{label} ({name}) never launched under the CLI")
    tc_shapes = {k: n for k, n in shapes.items() if k[0] in ("flash_heads_tc", "fused_mlp_tc")}
    topk_shapes = {k: n for k, n in shapes.items() if k[0] in ("topk_stream", "topk_masked")}
    check(sum(topk_shapes.values()) == launches["topk_stream"] + launches["topk_masked"],
          f"EP top-k launches by shape {topk_shapes} against {dict(launches)}")
    out["shapes"] = {f"{k[0]} {k[1]}": n for k, n in sorted(shapes.items(), key=str)}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"entry points (EP) numbers: {json.dumps(out)}", flush=True)
    return launches, tc_shapes, topk_shapes, out


# the learning rate of phase T's PE-L14 run. AdamW's first steps move each
# of the tower's 304M parameters by about the learning rate whatever its
# gradient; at the CLI's default 1e-4 a random init's first step pushed the
# embeddings together (the loss rose from 0.403 to 0.636, then fell back
# to 0.488 by step 5), so the check that the loss falls runs at 1e-5. The
# phase also runs the same 5 steps at 1e-4 on the kernels and on the plain
# tower (`plain_tower`) and prints both, the witness that the rise is the
# optimizer's and not the kernels'
TRAIN_LR = 1e-5
WITNESS_LR = 1e-4
BWD_COUNTERS = ("flash_heads_bwd", "fused_mlp_bwd")


def train_views(torch, cfg) -> tuple:
    """Phase T's two seeded views of B = 16 images on the card (a flip plus
    noise, as the CLI makes them)."""
    rng = np.random.default_rng(17)
    a = rng.standard_normal((16, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    b = a[:, :, ::-1, :] + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    return torch.from_numpy(a).cuda(), torch.from_numpy(np.ascontiguousarray(b)).cuda()


@contextlib.contextmanager
def plain_tower():
    """The tower's attention and MLP on their plain versions
    (`flash_attention_heads_ref`, `mlp_ref`) with PyTorch's autograd, each
    recomputed in the backward (`torch.utils.checkpoint`) so that 24 blocks
    of [B, H, S, S] scores fit on the card, and its norm sites on
    `add_layernorm_ref`: the harness's plain reference for phase T's
    witness, not a route of the port."""
    from torch.utils.checkpoint import checkpoint
    from reverso_tpu_torch.models import vit
    from reverso_tpu_torch.ops.attention import flash_attention_heads_ref
    from reverso_tpu_torch.ops.fused_mlp import mlp_ref
    from reverso_tpu_torch.ops.norm import add_layernorm_ref

    saved = vit.flash_attention_heads, vit.fused_mlp, vit.add_layernorm
    vit.add_layernorm = add_layernorm_ref
    vit.flash_attention_heads = lambda q, k, v, **kw: checkpoint(
        flash_attention_heads_ref, q, k, v, use_reentrant=False, **kw)
    vit.fused_mlp = lambda x, w1, b1, w2, b2, act, parts: checkpoint(
        mlp_ref, x, w1, b1, w2, b2, act, use_reentrant=False)
    try:
        yield
    finally:
        vit.flash_attention_heads, vit.fused_mlp, vit.add_layernorm = saved


def heads_bwd_bound(b: int, s: int, w: int, heads: int, itemsize: int,
                    dtype: str) -> tuple[float, str]:
    """K3's backward's least time on [B, S, W]: q, k, v and dO read and dq,
    dk, dv written once, the two fp32 RoPE tables read once; five products
    of B H S^2 hd multiply-adds (s, dP, dv, dq, dk), 10 B H S^2 hd
    operations."""
    hd = w // heads
    return bound(7 * b * s * w * itemsize + 2 * s * hd * 4, 10 * b * heads * s * s * hd, dtype)


def mlp_bwd_bound(t: int, w: int, hid: int, itemsize: int, dtype: str,
                  kernel_only: bool = False) -> tuple[float, str]:
    """K4's backward's least time at [T, W] -> H -> W. The whole gradient:
    x, dY, W1, b1 and W2 read, dx, dW1, db1, dW2 and db2 written once; five
    products (z, dY W2, dW2, dW1, dx), 10 T W H operations. The kernel alone
    (`rv_fused_mlp_bwd_tc`, `rv_fused_mlp_bwd_split`): x, dY, W1, b1 and W2
    read, h and dz written; two products, 4 T W H."""
    reads = 2 * t * w + 2 * w * hid + hid
    if kernel_only:
        return bound((reads + 2 * t * hid) * itemsize, 4 * t * w * hid, dtype)
    return bound((reads + t * w + 2 * w * hid + hid + w) * itemsize, 10 * t * w * hid, dtype)


def ptxas_usage(source: str, namespace: str) -> dict:
    """ptxas's registers and spill bytes of each kernel of `source` (this
    run's build, `kernels.ptxas_log`) whose mangled name holds `namespace`,
    keyed by the kernel's name and template arguments."""
    import re

    from reverso_tpu_torch import kernels
    out, fn = {}, None
    for line in kernels.ptxas_log.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(namespace + r"(\d+)", fn or "")
        if not m:
            continue
        end = m.end() + int(m.group(1))   # the kernel's name, then its template arguments
        targ = re.match(r"I((?:Li\d+E)+)E", fn[end:])
        args = re.findall(r"Li(\d+)E", targ.group(1)) if targ else []
        name = fn[m.end():end] + (f"<{', '.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernel_times(torch, fn, call_ms: float, calls: int = 5) -> tuple:
    """Device ms per call of each kernel (and memset or copy) that `fn`
    launches, over `calls` profiled calls (after a warm-up call), by
    `torch.profiler`, held against `call_ms`, the same call's CUDA-event
    median: the sum per call must lie within KERNEL_SUM_RANGE of it (the
    launch gaps take the rest); a sum outside the range gives None with the
    reason instead of times. Late in the whole script a session has come
    back with none or only part of a call's device events (in several
    runs on an H100), so phase T takes them in a process of its own
    (`backward_kernel_times`). The session idles 50 ms at both ends.
    Returns (times by kernel or None, {sum_ms, call_ms, ratio, reason})."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    out: dict = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"\b(?:rv|at::native)::(?:\w+::)*(\w+(?:<[\w, ]+>)?)", ev.name)
        name = m.group(1) if m else ev.name[:48]
        out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / calls
    total = sum(out.values())
    ratio = total / call_ms
    lo, hi = KERNEL_SUM_RANGE
    note = dict(sum_ms=total, call_ms=call_ms, ratio=ratio, reason=None)
    if not lo <= ratio <= hi:
        note["reason"] = (f"the profiler caught {total:.4f} ms of device time a call against "
                          f"the call's {call_ms:.4f} ms by CUDA events ({ratio:.3f}x, outside "
                          f"{lo}-{hi}x): a partial capture, not printed as measured")
        return None, note
    return out, note


BWD_TOLS = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}   # train_kernel_checks' gates


def backward_row(key: tuple) -> str:
    """The kernel row of a backward launch key (`kernels.shape_launches`):
    flash_heads_bwd or fused_mlp_bwd, with _f32 for fp32."""
    return key[0] + ("_f32" if key[1][-1] == "torch.float32" else "")


def backward_case(torch, gen, key: tuple) -> dict:
    """One backward launch key, ("flash_heads_bwd", (B, S, W, heads, rope,
    dtype)) or ("fused_mlp_bwd", (T, W, H, act, dtype)), on seeded inputs
    of that shape: its gradients held against the autograd of the plain
    forward (each within BWD_TOLS of max(1, its largest plain value)); the
    median of 5 CUDA-event times (`beside`): K3's backward call, K4's whole
    backward (`torch.autograd.grad` through `FusedMLPFunction`) and its
    kernel alone; the bound; the kernel call's device time by kernel
    (`kernel_times`)."""
    from reverso_tpu_torch.ops.attention import (_heads_bwd_launch, _heads_launch,
                                                  flash_attention_heads_grad_ref)
    from reverso_tpu_torch.ops.fused_mlp import (_mlp_bwd_launch, fused_mlp, mlp_grad_ref,
                                                 split_mlp_weights)
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    name, shape = key
    dt = shape[-1]
    dtype = getattr(torch, dt.split(".")[-1])
    size, rate = (2, "bfloat16") if dtype == torch.bfloat16 else (4, "float32_split")
    randn = lambda *sh, scale=1.0: (torch.randn(*sh, generator=gen, device="cuda")
                                    * scale).to(dtype)

    def err_of(outs, refs):
        return max(float((o.float() - r.float()).abs().max()) / max(1.0, float(r.float().abs().max()))
                   for o, r in zip(outs, refs))

    out = {}
    if name == "flash_heads_bwd":
        b, s, w, heads, rope = shape[:5]
        hd = w // heads
        cos = sin = None
        tables = ()
        if rope:
            cos, sin = (torch.from_numpy(a).cuda() for a in rope_2d_tables(
                int(np.sqrt(s - 1)), hd, cls_token=True))
            tables = (cos, sin)
        q, k, v, do = (randn(b, s, w) for _ in range(4))
        lse = torch.empty((b * heads, s), dtype=torch.float32, device="cuda")
        o = _heads_launch(q, k, v, heads, tables, hd ** -0.5, s, lse)
        call = lambda: _heads_bwd_launch(q, k, v, do, heads, tables, hd ** -0.5, s, o, lse)
        out["max_abs_err"] = err_of(call(), flash_attention_heads_grad_ref(
            q, k, v, do, heads=heads, cos=cos, sin=sin))
        med, reps = beside(torch, {"ms": call})
        out["shape"] = f"B={b} S={s} W={w} H={heads} {dt[6:]}{' RoPE' * bool(rope)}"
        out["bound_ms"] = heads_bwd_bound(b, s, w, heads, size, rate)[0]
        kernel_call = call
    else:
        t, w, hid, act = shape[:4]
        x, dy = randn(t, w), randn(t, w)
        w1, b1 = randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.1)
        w2, b2 = randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.1)
        parts = split_mlp_weights(w1, w2) if dtype == torch.float32 else None
        leaves = [p.clone().requires_grad_(True) for p in (x, w1, b1, w2, b2)]
        y = fused_mlp(*leaves, act=act, parts=parts)
        whole = lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)
        kernel_call = lambda: _mlp_bwd_launch(x, w1, b1, w2, dy, act, parts)
        out["max_abs_err"] = err_of(whole(), mlp_grad_ref(x, w1, b1, w2, b2, dy, act=act))
        med, reps = beside(torch, {"ms": whole, "kernel_ms": kernel_call})
        out["shape"] = f"T={t} W={w} H={hid} {dt[6:]} {act}"
        out["bound_ms"] = mlp_bwd_bound(t, w, hid, size, rate)[0]
        out["kernel_bound_ms"] = mlp_bwd_bound(t, w, hid, size, rate, kernel_only=True)[0]
        out["kernel_ms"], out["kernel_repeats_ms"] = med["kernel_ms"], reps["kernel_ms"]
    out.update(ms=med["ms"], repeats_ms=reps["ms"], tolerance=BWD_TOLS[dt])
    times, note = kernel_times(torch, kernel_call, med.get("kernel_ms", med["ms"]))
    out.update(kernels_ms=times, kernels_ms_check=note)
    return out


def backward_kernel_times(torch, keys: list) -> int:
    """`python3 chip_smoke.py --backward-kernel-times KEYS`: `backward_case`
    for each backward launch key of the JSON list KEYS (the rows' own
    shapes, then every shape a path launched them at). Prints one JSON
    line [case, ...]. Run by `backward_kernel_times_apart`, a process of
    its own: late in the whole script a profiler session has come back
    with none or only part of a call's device events (in several runs on
    an H100)."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    cases = []
    for name, shape in keys:
        cases.append(backward_case(torch, gen, (name, tuple(shape))))
        torch.cuda.empty_cache()
    print(json.dumps(cases), flush=True)
    return 0


def backward_kernel_times_apart(keys) -> dict:
    """`backward_kernel_times` in a process of its own, on the library this
    run built: {key: case}. Fails if it fails, or if a case's error is
    above its tolerance."""
    keys = sorted(set(keys), key=str)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--backward-kernel-times", json.dumps(keys)],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"--backward-kernel-times: rc {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    cases = dict(zip(keys, json.loads(proc.stdout.strip().splitlines()[-1])))
    for key, case in cases.items():
        check(case["max_abs_err"] <= case["tolerance"],
              f"backward {key}: error {case['max_abs_err']} of max(1, |plain|) > "
              f"{case['tolerance']}")
    return cases


def beside(torch, fns: dict, repeats: int = 5) -> tuple:
    """Each of `fns` timed by `cuda_ms` in turn, `repeats` times over:
    ({name: median ms}, {name: [ms of each repeat]}), so that a kernel and
    its library call are taken beside each other in the same run."""
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            runs[name].append(cuda_ms(fn))
    return {name: float(np.median(v)) for name, v in runs.items()}, runs


def train_kernel_checks(torch) -> dict:
    """(T a, b) The backward kernels at the training path's shapes, through
    the wrappers under autograd, each gradient held against the autograd of
    the plain forward on the card (bf16: within 2e-2 of max(1, the largest
    plain gradient), the outputs rounded once against the plain version's
    intermediate roundings; fp32: 1e-4, sums in another order; fp32 also
    against the split route's own plain version), each on the route its
    `*_bwd_route` names, which its counter shows (and no other route's).
    (a) K3's backward at PE-L14's training shape, B = 16, S = 577, W =
    1024, 16 heads of 64 with RoPE, in bf16 (the wgmma + TMA kernels); the
    same at kv_valid = 300; PE-G14's head dim 96 at B = 2 in bf16; fp32 at
    B = 2 and at the fp32 training run's B = F32_BATCH (their split mode);
    head dim 72 (a multiple of 4, not of 16) at B = 2 in bf16 and in fp32
    with kv_valid = 300 (on the prep's copies zero-padded to 80: bf16 one
    part, fp32 the split mode's three). (b) K4's backward at T = 16 x 577 =
    9232, 1024 -> 4096 -> 1024: gelu and quick_gelu in bf16 and in fp32
    (the split mode, with the weights' parts as the tower caches them), and
    fp32 gelu at the fp32 training run's T = F32_BATCH x 577 (`f32_train_run`
    checks that its backward launches are at these shapes).
    Timed at the main shapes (K3 bf16 at B = 16 and fp32 at B = 2, K4 gelu
    in both): the backward by CUDA events, the median of 5 repeats each
    taken beside the library call (K3: SDPA's backward on [B, H, S, D]
    without RoPE, in the same dtype; K4: the cuBLAS route of the same five
    products and aten's gelu backward, and that route's part the kernel
    computes), the plain versions (the plain forward and its autograd; the
    split plain versions) and the bounds; K3's forward at B = 16 with and
    without its log-sum-exp output, in turns; ptxas's registers and spills
    of each backward kernel. Returns the four kernel rows: flash_heads_bwd,
    fused_mlp_bwd (bf16) and flash_heads_bwd_f32, fused_mlp_bwd_f32 (`main`
    adds each row's device time by kernel at its shape and its `by_shape`,
    from `backward_kernel_times_apart`)."""
    import torch.nn.functional as F
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (_heads_bwd_launch, _heads_launch,
                                                  flash_attention_heads,
                                                  flash_attention_heads_grad_ref,
                                                  flash_attention_heads_grad_split_ref,
                                                  heads_bwd_route)
    from reverso_tpu_torch.ops.fused_mlp import (_mlp_bwd_launch, fused_mlp, mlp_bwd_route,
                                                 mlp_grad_ref, mlp_grad_split_ref,
                                                 split_mlp_weights)
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(41)
    tols = {bf16: 2e-2, f32: 1e-4}

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def held(name, outs, refs, dtype):
        """Each gradient against its own scale; returns the largest error
        relative to max(1, its gradient's largest plain value) and the
        relative tolerance."""
        errs = [max_err(o, r) for o, r in zip(outs, refs)]
        scales = [max(1.0, float(r.float().abs().max())) for r in refs]
        rel = max(e / sc for e, sc in zip(errs, scales))
        check(all(torch.isfinite(o).all() for o in outs), f"{name}: non-finite gradient")
        check(rel <= tols[dtype], f"{name}: max abs err by gradient {errs} against scales "
                                  f"{scales}: {rel} of the scale > {tols[dtype]}")
        print(f"{name}: max abs err by gradient {errs}, of max(1, |plain|) {scales}: "
              f"at most {rel} (tolerance {tols[dtype]})", flush=True)
        return rel, tols[dtype]

    rows = {}
    # (a) K3's backward
    s = 577
    errors, k3, routes = {}, {}, {}
    counters = {"tc": "flash_heads_bwd_tc", "split": "flash_heads_bwd_split"}
    for dtype, b, w, kv in ((bf16, 16, 1024, None), (bf16, 16, 1024, 300), (bf16, 2, 1536, None),
                            (f32, 2, 1024, None), (f32, F32_BATCH, 1024, None),
                            (bf16, 2, 1152, None), (f32, 2, 1152, 300)):
        heads = 16
        hd = w // heads
        c, sn = rope_2d_tables(24, hd, cls_token=True)
        cos, sin = torch.from_numpy(c).to(dev), torch.from_numpy(sn).to(dev)
        q, k, v, do = (randn(b, s, w, dtype=dtype) for _ in range(4))
        kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=kv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        route = heads_bwd_route("cuda", dtype, hd)
        before = {name: kernels.launches[name] for name in ("flash_heads_bwd", *counters.values())}
        flash_attention_heads(*leaves, **kw).backward(do)
        check(kernels.launches["flash_heads_bwd"] == before["flash_heads_bwd"] + 1
              and all(kernels.launches[n] == before[n] + ((r == "split") == (route == "split"))
                      for r, n in counters.items()), f"K3 backward: not one {route} launch")
        refs = flash_attention_heads_grad_ref(q, k, v, do, **kw)
        torch.cuda.synchronize()
        case = f"B={b} W={w} hd={hd} {str(dtype)[6:]}{'' if kv is None else f' kv_valid={kv}'}"
        routes[case] = route
        errors[case] = held(f"K3 backward {case} ({route})", [t.grad for t in leaves], refs,
                            dtype)
        if kv is not None:
            check(not leaves[1].grad[:, kv:].any() and not leaves[2].grad[:, kv:].any(),
                  f"K3 backward {case}: keys past kv_valid have a gradient")
        if dtype == f32:   # the split route against its own plain version too
            split = flash_attention_heads_grad_split_ref(q, k, v, do, **kw)
            k3[(case, "split_err")] = held(f"K3 backward {case} against the split plain version",
                                           [t.grad for t in leaves], split, dtype)[0]
            del split
        if (dtype, b, w, kv) in ((bf16, 16, 1024, None), (f32, 2, 1024, None)):
            scale = hd ** -0.5
            lse = torch.empty((b * heads, s), dtype=f32, device=dev)
            o = _heads_launch(q, k, v, heads, (cos, sin), scale, s, lse)
            call = lambda: _heads_bwd_launch(q, k, v, do, heads, (cos, sin), scale, s, o, lse)
            fns = {"ms": call}
            # SDPA's backward on the same values as [B, H, S, D], without
            # RoPE (in fp32 too: the split route's library time)
            split = lambda t: t.reshape(b, s, heads, hd).transpose(1, 2).contiguous()
            qh, kh, vh = (split(t).requires_grad_(True) for t in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            doh = split(do)
            fns["library_ms"] = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                                            retain_graph=True)
            if dtype == bf16:
                # the forward with and without the log-sum-exp output, in turns
                fns["fwd_ms"] = lambda: _heads_launch(q, k, v, heads, (cos, sin), scale, s)
                fns["fwd_lse_ms"] = lambda: _heads_launch(q, k, v, heads, (cos, sin), scale, s,
                                                          lse)
            k3[dtype], k3[(dtype, "repeats")] = beside(torch, fns)
            k3[dtype]["plain_ms"] = cuda_ms(
                lambda: flash_attention_heads_grad_ref(q, k, v, do, **kw), iters=3)
            if dtype == f32:
                k3[dtype]["split_plain_ms"] = cuda_ms(
                    lambda: flash_attention_heads_grad_split_ref(q, k, v, do, **kw), iters=3)
            fns.clear()
            del qh, kh, vh, oh, doh, o, lse
        del q, k, v, do, leaves, refs
    main = "B=16 W=1024 hd=64 bfloat16"
    r = k3[bf16]
    ptx = ptxas_usage("flash_heads_bwd_tc.cu", "hbwd")
    rows["flash_heads_bwd"] = dict(
        source="reverso_tpu_torch/csrc/flash_heads_bwd_tc.cu",
        replaces="reverso_tpu/ops/attention.py:337",
        replaces_note="no TPU kernel: the gradient of K3, which has no backward in JAX",
        route_taken=f"{routes[main]} (wgmma + TMA: prep, dq and dk/dv kernels)",
        routes=routes,
        max_abs_err=errors[main][0], tolerance=errors[main][1],
        error_is="max abs err over dq, dk, dv, each over max(1, its largest plain value)",
        shape="B=16 S=577 W=1024 H=16 bf16 RoPE", ms=r["ms"], plain_ms=r["plain_ms"],
        library="SDPA's backward on [B, H, S, D] (no RoPE)", library_ms=r["library_ms"],
        repeats_ms=k3[(bf16, "repeats")]["ms"],
        library_repeats_ms=k3[(bf16, "repeats")]["library_ms"],
        forward_b16_ms=r["fwd_ms"], forward_b16_lse_ms=r["fwd_lse_ms"],
        forward_repeats_ms=k3[(bf16, "repeats")]["fwd_ms"],
        forward_lse_repeats_ms=k3[(bf16, "repeats")]["fwd_lse_ms"],
        ptxas={n: u for n, u in ptx.items() if not n.endswith(", 3>") and "split" not in n},
        errors={case: e for case, (e, _) in errors.items()})
    rows["flash_heads_bwd"]["bound_ms"], rows["flash_heads_bwd"]["bound_by"] = heads_bwd_bound(
        16, s, 1024, 16, 2, "bfloat16")
    main = "B=2 W=1024 hd=64 float32"
    r = k3[f32]
    rows["flash_heads_bwd_f32"] = dict(
        source="reverso_tpu_torch/csrc/flash_heads_bwd_tc.cu",
        replaces="reverso_tpu/ops/attention.py:337",
        replaces_note="no TPU kernel: the gradient of K3 in fp32, which has no backward in JAX",
        route_taken=f"{routes[main]} (wgmma + TMA on three bf16 parts a value: prep, dq and "
                    f"dk/dv kernels)",
        max_abs_err=errors[main][0], tolerance=errors[main][1],
        error_is="max abs err over dq, dk, dv, each over max(1, its largest plain value)",
        split_plain_err=k3[(main, "split_err")],
        shape="B=2 S=577 W=1024 H=16 fp32 RoPE", ms=r["ms"], plain_ms=r["plain_ms"],
        split_plain_ms=r["split_plain_ms"],
        library="SDPA's fp32 backward on [B, H, S, D] (no RoPE)", library_ms=r["library_ms"],
        repeats_ms=k3[(f32, "repeats")]["ms"],
        library_repeats_ms=k3[(f32, "repeats")]["library_ms"],
        ptxas={n: u for n, u in ptx.items() if n.endswith(", 3>") or "split" in n},
        errors={case: e for case, (e, _) in errors.items() if "float32" in case},
        split_plain_errors={case: k3[(case, "split_err")] for case in errors
                            if "float32" in case})
    rows["flash_heads_bwd_f32"]["bound_ms"], rows["flash_heads_bwd_f32"]["bound_by"] = \
        heads_bwd_bound(2, s, 1024, 16, 4, "float32_split")

    # (b) K4's backward
    tm, w, hid = 16 * 577, 1024, 4096
    errors, k4 = {}, {}
    for dtype, act, t in ((bf16, "gelu", tm), (f32, "gelu", tm), (bf16, "quick_gelu", tm),
                          (f32, "quick_gelu", tm), (f32, "gelu", F32_BATCH * 577)):
        x, dy = randn(t, w, dtype=dtype), randn(t, w, dtype=dtype)
        w1, b1 = randn(hid, w, dtype=dtype, scale=w ** -0.5), randn(hid, dtype=dtype, scale=0.1)
        w2, b2 = randn(w, hid, dtype=dtype, scale=hid ** -0.5), randn(w, dtype=dtype, scale=0.1)
        leaves = [p.clone().requires_grad_(True) for p in (x, w1, b1, w2, b2)]
        route = mlp_bwd_route("cuda", dtype, w, hid)
        # the fp32 tower's call: the weights' parts from its cache
        parts = split_mlp_weights(w1, w2) if dtype == f32 else None
        counter = "fused_mlp_bwd_split" if route == "split" else "fused_mlp_bwd_tc"
        other = "fused_mlp_bwd_tc" if route == "split" else "fused_mlp_bwd_split"
        n0, r0, o0 = (kernels.launches[n] for n in ("fused_mlp_bwd", counter, other))
        y = fused_mlp(*leaves, act=act, parts=parts)
        y.backward(dy, retain_graph=True)
        check(kernels.launches["fused_mlp_bwd"] == n0 + 1 and kernels.launches[counter] == r0 + 1
              and kernels.launches[other] == o0, f"K4 backward: not one {route} launch")
        refs = mlp_grad_ref(x, w1, b1, w2, b2, dy, act=act)
        torch.cuda.synchronize()
        case = f"T={t} {str(dtype)[6:]} {act}"
        errors[case] = held(f"K4 backward {case} ({route})", [p.grad for p in leaves], refs,
                            dtype)
        del refs
        if dtype == f32:   # the split route against its own plain version too
            split = mlp_grad_split_ref(x, w1, b1, w2, b2, dy, act=act)
            k4[(case, "split_err")] = held(f"K4 backward {case} against the split plain version",
                                           [p.grad for p in leaves], split, dtype)[0]
            del split
        if act == "gelu" and t == tm:
            def kernel_part():
                z = F.linear(x, w1, b1)
                return F.gelu(z), torch.ops.aten.gelu_backward(dy @ w2, z)

            def library():
                hh, dz = kernel_part()
                return (dz @ w1, dz.t() @ x, dz.sum(0), dy.t() @ hh, dy.sum(0))

            kernel = lambda: _mlp_bwd_launch(x, w1, b1, w2, dy, act, parts)
            k4[dtype], k4[(dtype, "repeats")] = beside(torch, {
                "kernel_ms": kernel,
                "kernel_library_ms": kernel_part,
                "ms": lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
                "library_ms": library})
            k4[dtype]["route"] = route
            if dtype == f32:
                k4[dtype]["split_plain_ms"] = cuda_ms(
                    lambda: mlp_grad_split_ref(x, w1, b1, w2, b2, dy, act=act), iters=3)
            k4[dtype]["plain_ms"] = cuda_ms(
                lambda: mlp_grad_ref(x, w1, b1, w2, b2, dy, act=act), iters=3)
        del x, dy, w1, b1, w2, b2, leaves, y, parts
    ptx = ptxas_usage("fused_mlp_bwd.cu", "mbwd")
    for dtype, name in ((bf16, "fused_mlp_bwd"), (f32, "fused_mlp_bwd_f32")):
        main = f"T={tm} {str(dtype)[6:]} gelu"
        r = k4[dtype]
        reps = k4[(dtype, "repeats")]
        size = 2 if dtype == bf16 else 4
        rate = "bfloat16" if dtype == bf16 else "float32_split"
        rows[name] = dict(
            source="reverso_tpu_torch/csrc/fused_mlp_bwd.cu",
            replaces="reverso_tpu/ops/fused_mlp.py:63",
            replaces_note="no TPU kernel: the gradient of K4, which has no backward in JAX",
            route_taken=(f"{r['route']} (wgmma + TMA, db1's partials fused)" if dtype == bf16
                         else f"{r['route']} (wgmma + TMA on three bf16 parts a value: the "
                              f"split pass of x and dY, the kernel; db1's partials fused)"),
            max_abs_err=errors[main][0], tolerance=errors[main][1],
            error_is="max abs err over dx, dW1, db1, dW2, db2, each over max(1, its largest "
                     "plain value)",
            shape=f"T={tm} 1024->4096->1024 {str(dtype)[6:]} gelu: the whole backward (the "
                  f"kernel, three torch.matmul products, two sums)",
            ms=r["ms"], plain_ms=r["plain_ms"],
            library=f"cuBLAS route: the same five products (F.linear, matmuls) and "
                    f"aten.gelu_backward{'' if dtype == bf16 else ', in fp32'}",
            library_ms=r["library_ms"],
            kernel_ms=r["kernel_ms"], kernel_library_ms=r["kernel_library_ms"],
            kernel_bound_ms=mlp_bwd_bound(tm, w, hid, size, rate, kernel_only=True)[0],
            repeats_ms=reps["ms"], library_repeats_ms=reps["library_ms"],
            kernel_repeats_ms=reps["kernel_ms"],
            kernel_library_repeats_ms=reps["kernel_library_ms"],
            ptxas={n: u for n, u in ptx.items() if ("split" in n) == (dtype == f32)},
            errors={case: e for case, (e, _) in errors.items() if str(dtype)[6:] in case})
        if dtype == f32:
            rows[name].update(split_plain_ms=r["split_plain_ms"],
                              split_plain_errors={case: k4[(case, "split_err")]
                                                  for case in errors if "float32" in case})
        rows[name]["bound_ms"], rows[name]["bound_by"] = mlp_bwd_bound(tm, w, hid, size, rate)
    k3r, k3f, k4r, k4f = (rows[n] for n in ("flash_heads_bwd", "flash_heads_bwd_f32",
                                            "fused_mlp_bwd", "fused_mlp_bwd_f32"))
    print(f"backward kernels: K3 {k3r['ms']} ms (SDPA's backward {k3r['library_ms']}), "
          f"K3 fp32 {k3f['ms']} ms (SDPA's fp32 backward {k3f['library_ms']}, bound "
          f"{k3f['bound_ms']}), K3 forward at B = 16 {k3r['forward_b16_ms']} / with lse "
          f"{k3r['forward_b16_lse_ms']}; K4 kernel {k4r['kernel_ms']} ms, whole {k4r['ms']} "
          f"(cuBLAS {k4r['library_ms']}); K4 fp32 kernel {k4f['kernel_ms']} ms (bound "
          f"{k4f['kernel_bound_ms']}, cuBLAS's part {k4f['kernel_library_ms']}), whole "
          f"{k4f['ms']} (cuBLAS {k4f['library_ms']}, bound {k4f['bound_ms']}); "
          f"ptxas {json.dumps(k3r['ptxas'])} "
          f"{json.dumps(k3f['ptxas'])} {json.dumps(k4r['ptxas'])} {json.dumps(k4f['ptxas'])}",
          flush=True)
    return rows


def train_run(root: str) -> tuple:
    """(T) Training on the card. (a, b) `train_kernel_checks`; then (c)
    `ClipTrainer(MODEL_PRESETS["PE-Core-L14-336"])` at full width and depth
    (bf16 activations, fp32 parameters, seed 5, learning rate `TRAIN_LR`)
    takes 5 AdamW steps on the
    same two seeded views of B = 16 images (a flip plus noise, as the CLI
    makes them): the loss finite and lower at step 5 than at step 1, every
    block's attention and MLP on K3 and K4 forward and backward (counts set
    to 0 just before and read just after), ms per step, the peak memory;
    (d) its state saved, restored into a trainer of another seed, and held
    bit for bit (params, AdamW's state, t, b, step), then one step of the
    restored trainer profiled; the witness for `TRAIN_LR`: the same 5
    steps from the same init at `WITNESS_LR` on the kernels and on
    `plain_tower`, both losses printed, their first step's held within 2e-2
    (the same forward, in bf16); (e) `reverso-torch train` in this process
    at the default PE-Core-L14-336 on 32 generated photos: 2 steps of 16
    with a checkpoint, then `--resume` for 1; between (d) and (e),
    `f32_train_run`: the fp32 tower on the split routes, forward and
    backward. Returns (rows, launches of (c), K3 and K4 forward launches of
    (c) by shape, numbers, launches of the fp32 run, its K3 and K4 forward
    launches by shape, the backward launches of (c) and the fp32 run by
    shape)."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    import torch
    from reverso_tpu_torch import cli, kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.train import ClipTrainer
    from reverso_tpu_torch.train.checkpoint import restore_train_state, save_train_state

    rows = train_kernel_checks(torch)
    torch.cuda.empty_cache()
    out = {}
    cfg = MODEL_PRESETS["PE-Core-L14-336"]
    check((cfg.width, cfg.depth, cfg.num_heads, cfg.seq_len, cfg.dtype)
          == (1024, 24, 16, 577, "bfloat16"), f"PE-Core-L14-336: {cfg}")
    va, vb = train_views(torch, cfg)
    t0 = time.perf_counter()
    tr = ClipTrainer(cfg, learning_rate=TRAIN_LR, seed=5)
    out["init_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    losses, step_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(tr.train_step(va, vb))   # the loss reaches the host: a sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    shapes = {f"{key[0]} {key[1]}": n for key, n in kernels.shape_launches.items()}
    tc_shapes = {key: n for key, n in kernels.shape_launches.items()
                 if key[0] in ("flash_heads_tc", "fused_mlp_tc")}
    bwd_shapes = collections.Counter({key: n for key, n in kernels.shape_launches.items()
                                      if key[0] in BWD_COUNTERS})
    out.update(losses=losses, step_ms=step_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches={k: n for k, n in launches.items() if n},
               launches_per_step={k: n / 5 for k, n in launches.items() if n},
               launches_by_shape=shapes)
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"PE-L14 training: loss not finite and falling: {losses}")
    per_step = 2 * cfg.depth   # two views, one call a block
    for name in ("flash_heads", "flash_heads_tc", "flash_heads_bwd", "flash_heads_bwd_tc",
                 "fused_mlp", "fused_mlp_tc", "fused_mlp_bwd", "fused_mlp_bwd_tc"):
        check(launches[name] == 5 * per_step, f"training: {name} launched {launches[name]} "
                                              f"times, not {5 * per_step}")
    check(launches["flash_attn"] == 0 and launches["fused_mlp_int8"] == 0,
          f"training: unexpected launches {launches}")
    norms = 2 * (2 * cfg.depth + 2)   # two views, the norm sites of a forward
    check(launches["add_layernorm"] == 5 * norms
          and kernels.plain_dispatches["norm_shape"] == 0,
          f"training: add_layernorm launched {launches['add_layernorm']} times, not "
          f"{5 * norms}, norm_shape {kernels.plain_dispatches['norm_shape']}")

    # (d) checkpoint: save, restore into another seed's trainer, bit for bit
    path = os.path.join(root, "train_ckpt", "state.pt")
    t0 = time.perf_counter()
    save_train_state(path, tr.state)
    out["save_s"] = time.perf_counter() - t0
    out["checkpoint_gb"] = os.path.getsize(path) / 1e9
    t2 = ClipTrainer(cfg, learning_rate=TRAIN_LR, seed=6)
    t0 = time.perf_counter()
    t2.state = restore_train_state(path, t2.state)
    out["restore_s"] = time.perf_counter() - t0
    same = all(torch.equal(p1, p2) for p1, p2 in zip(tr.module.parameters(),
                                                      t2.module.parameters()))
    s1, s2 = tr.opt.state_dict()["state"], t2.opt.state_dict()["state"]
    same_opt = s1.keys() == s2.keys() and all(
        torch.equal(s1[i][f], s2[i][f]) for i in s1 for f in ("exp_avg", "exp_avg_sq", "step"))
    check(same and same_opt and int(t2.step) == 5 and torch.equal(tr.t, t2.t)
          and torch.equal(tr.b, t2.b), "checkpoint: restored state differs")
    os.remove(path)   # 3.6 GB of disk
    del tr
    torch.cuda.empty_cache()
    out["profile_step"] = profiled(torch, lambda: t2.train_step(va, vb))
    del t2
    torch.cuda.empty_cache()

    # the witness for TRAIN_LR: 5 steps at WITNESS_LR, kernels and plain
    witness = {}
    for route in ("kernels", "plain"):
        tw = ClipTrainer(cfg, learning_rate=WITNESS_LR, seed=5)
        kernels.reset_counts()
        t0 = time.perf_counter()
        with plain_tower() if route == "plain" else contextlib.nullcontext():
            witness[route] = [tw.train_step(va, vb) for _ in range(5)]
        out[f"witness_{route}_s"] = time.perf_counter() - t0
        n = sum(kernels.launches[k] for k in ("flash_heads_tc", "fused_mlp_tc",
                                              "flash_heads_bwd", "fused_mlp_bwd"))
        check(n == (4 * 5 * per_step if route == "kernels" else 0),
              f"witness on the {route}: {n} launches of K3 and K4, forward and backward")
        del tw
        torch.cuda.empty_cache()
    out["witness_lr"] = WITNESS_LR
    out["witness_losses"] = witness
    print(f"training at lr {WITNESS_LR}: losses on the kernels {witness['kernels']}, on the "
          f"plain tower {witness['plain']}", flush=True)
    check(all(np.isfinite(v).all() for v in witness.values())
          and abs(witness["kernels"][0] - witness["plain"][0]) <= 2e-2,
          f"witness at lr {WITNESS_LR}: {witness}")
    out["f32"], f32_launches, f32_shapes, f32_bwd_shapes = f32_train_run(
        torch, cfg, va[:F32_BATCH], vb[:F32_BATCH])
    bwd_shapes.update(f32_bwd_shapes)
    del va, vb
    torch.cuda.empty_cache()

    # (e) the command line, in this process, on the card
    folder = os.path.join(root, "train_images")
    os.makedirs(folder)
    make_photos(folder, 32, seed=21)
    ckpt = os.path.join(root, "cli_ckpt", "state.pt")
    kernels.reset_counts()
    for argv, want in ((["--steps", "2"], "step 2/2 loss"),
                       (["--steps", "1", "--resume"], "resumed at step 2")):
        so, se = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(so), redirect_stderr(se):
            rc = cli.main(["train", folder, "--batch-size", "16", "--checkpoint", ckpt] + argv)
        out[f"cli {' '.join(argv)} s"] = time.perf_counter() - t0
        print(f"reverso-torch train {' '.join(argv)}: rc {rc}; {se.getvalue().strip()!r}; "
              f"{so.getvalue().strip()!r}", flush=True)
        check(rc == 0 and want in se.getvalue() and "final loss" in so.getvalue()
              and f"saved checkpoint to {ckpt}" in se.getvalue(),
              f"reverso-torch train {argv}: rc {rc}")
    cli_launches = dict(kernels.launches)
    check(cli_launches["flash_heads_bwd"] == 3 * per_step
          and cli_launches["fused_mlp_bwd"] == 3 * per_step,
          f"reverso-torch train: backward launches {cli_launches}")
    out["cli_launches"] = {k: n for k, n in cli_launches.items() if n}
    print(f"training (T) numbers: {json.dumps(out)}", flush=True)
    return rows, launches, tc_shapes, out, f32_launches, f32_shapes, bwd_shapes


F32_BATCH = 4   # images a view in phase T's fp32 run
F32_STEPS = 3


def f32_train_run(torch, cfg, va, vb) -> tuple:
    """(T f) The strict-parity fp32 tower fine-tuned on the card:
    `ClipTrainer` at `cfg` with `dtype="float32"` (full width and depth,
    seed 5, `TRAIN_LR`) takes F32_STEPS AdamW steps on the views va, vb;
    every block's attention and MLP on K3's and K4's fp32 split routes,
    forward and backward (48 launches a step of each, counts set to 0 just
    before and read just after; none on another backward route); the loss
    finite; ms per step and the peak memory; then one more step profiled
    (`profiled`: device busy share, time by kernel group). Its backward
    launches must be at the shapes `train_kernel_checks` held each kernel
    at (B = F32_BATCH, T = F32_BATCH x 577, gelu), so that each fp32
    backward of this run was compared one by one with its plain versions at
    1e-4. Its first step is held against the same step of `plain_tower`
    (the plain fp32 forwards under autograd) from the same init: both are
    fp32, the kernels' products carry fp32's 24 bits as six part products
    (the three dropped terms below 2^-23 of each) and sum in another order,
    so across 24 blocks forward and back the loss agrees within 1e-4 of
    max(1, |loss|) and the gradient, all leaves together, within 1e-3 of
    its norm. The control behind that limit: the same first step of the
    bf16 tower from the same init (one bf16 part a value, the precision a
    split route that lost its lower parts would have), held the same way
    against the plain step, must read above 1e-3. Returns (numbers,
    launches, the split forwards' launches by shape)."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.train import ClipTrainer

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = {"batch_a_view": int(va.shape[0]), "steps": F32_STEPS}
    tp = ClipTrainer(cfg32, learning_rate=TRAIN_LR, seed=5)
    t0 = time.perf_counter()
    with plain_tower():
        loss_p, grads_p = tp.value_and_grad(va, vb)
    grads_p = {n: g.detach().clone() for n, g in grads_p.items()}
    out["plain_first_step_s"] = time.perf_counter() - t0
    del tp
    torch.cuda.empty_cache()
    tr = ClipTrainer(cfg32, learning_rate=TRAIN_LR, seed=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    losses, step_ms = [], []
    for i in range(F32_STEPS):
        t0 = time.perf_counter()
        if i == 0:   # the first step by hand, to keep its gradients
            loss_k, grads_k = tr.value_and_grad(va, vb)
            tr.opt.step()
            tr.step += 1
            losses.append(float(loss_k))   # the loss reaches the host: a sync
        else:
            losses.append(tr.train_step(va, vb))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    split_shapes = {key: n for key, n in kernels.shape_launches.items()
                    if key[0] in ("flash_heads_split", "fused_mlp_split")}
    bwd_counts = collections.Counter({key: n for key, n in kernels.shape_launches.items()
                                      if key[0] in BWD_COUNTERS})
    bwd_shapes = set(bwd_counts)
    out.update(losses=losses, step_ms=step_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches={k: n for k, n in launches.items() if n},
               launches_by_shape={f"{key[0]} {key[1]}": n
                                  for key, n in kernels.shape_launches.items()})
    check(bool(np.isfinite(losses).all()), f"fp32 training: loss not finite: {losses}")
    b, s, w = int(va.shape[0]), cfg.seq_len, cfg.width
    held = {("flash_heads_bwd", (F32_BATCH, s, w, cfg.num_heads, True, "torch.float32")),
            ("fused_mlp_bwd", (F32_BATCH * s, w, int(w * cfg.mlp_ratio), "gelu",
                               "torch.float32"))}
    check(b == F32_BATCH and bwd_shapes == held,
          f"fp32 training: backward shapes {bwd_shapes}, not the ones (T a, b) held {held}")
    per_step = 2 * cfg.depth   # two views, one call a block
    for name in ("flash_heads", "flash_heads_split", "flash_heads_bwd", "flash_heads_bwd_split",
                 "fused_mlp", "fused_mlp_split", "fused_mlp_bwd", "fused_mlp_bwd_split"):
        check(launches[name] == F32_STEPS * per_step,
              f"fp32 training: {name} launched {launches[name]} times, not "
              f"{F32_STEPS * per_step}")
    for name in ("flash_heads_tc", "fused_mlp_tc", "flash_heads_bwd_tc", "fused_mlp_bwd_tc"):
        check(launches[name] == 0, f"fp32 training: {name} launched {launches[name]} times")
    norms = 2 * (2 * cfg.depth + 2)   # two views, the norm sites of a forward
    check(launches["add_layernorm"] == F32_STEPS * norms,
          f"fp32 training: add_layernorm launched {launches['add_layernorm']} times, not "
          f"{F32_STEPS * norms}")
    # the first step against the plain tower's
    diff = sum(float((grads_k[n] - g).double().square().sum()) for n, g in grads_p.items())
    norm = sum(float(g.double().square().sum()) for g in grads_p.values())
    leaf = {n: float((grads_k[n] - g).double().norm() / g.double().norm().clamp(min=1e-30))
            for n, g in grads_p.items()}
    worst = max(leaf, key=leaf.get)
    # the control: the bf16 tower's first step from the same init
    tc = ClipTrainer(cfg, learning_rate=TRAIN_LR, seed=5)
    loss_c, grads_c = tc.value_and_grad(va, vb)
    control = sum(float((grads_c[n] - g).double().square().sum())
                  for n, g in grads_p.items()) / norm
    del tc, grads_c
    torch.cuda.empty_cache()
    out.update(first_loss=float(loss_k), plain_first_loss=float(loss_p),
               first_loss_err=abs(float(loss_k) - float(loss_p)),
               first_grad_rel_err=(diff / norm) ** 0.5,
               first_grad_worst_leaf=[worst, leaf[worst]],
               bf16_control_loss_err=abs(float(loss_c) - float(loss_p)),
               bf16_control_grad_rel_err=control ** 0.5)
    print(f"fp32 training ({F32_STEPS} steps, B = {va.shape[0]} a view): losses {losses}, "
          f"ms a step {step_ms}, peak {out['peak_gb']:.2f} GB; first step against the plain "
          f"tower: loss {out['first_loss']} vs {out['plain_first_loss']}, gradient error "
          f"{out['first_grad_rel_err']:.3e} of its norm (worst leaf {worst} "
          f"{leaf[worst]:.3e}; limit 1e-3); the bf16 control: loss {float(loss_c)}, gradient "
          f"error {out['bf16_control_grad_rel_err']:.3e} of its norm", flush=True)
    check(out["bf16_control_grad_rel_err"] > 1e-3,
          f"fp32 training: the bf16 control's gradient is within 1e-3 of the plain fp32 "
          f"tower's ({out['bf16_control_grad_rel_err']}): the limit does not tell fp32 from "
          f"bf16 precision")
    check(out["first_loss_err"] <= 1e-4 * max(1.0, abs(float(loss_p))),
          f"fp32 training: first loss {float(loss_k)} vs plain {float(loss_p)}")
    check(out["first_grad_rel_err"] <= 1e-3,
          f"fp32 training: first step's gradient {out['first_grad_rel_err']} of its norm "
          f"from the plain tower's")
    del grads_k, grads_p
    out["profile_step"] = profiled(torch, lambda: tr.train_step(va, vb))
    del tr
    torch.cuda.empty_cache()
    return out, launches, split_shapes, bwd_counts



TM_SIZES = (2, 2)   # phase TM's mesh, data x model, on cuda:0 named four times
TM_STEPS = 5


def mesh_train_run(root: str) -> tuple:
    """(TM) The trainer on a mesh: `ClipTrainer(cfg, mesh)` at
    PE-Core-L14-336's full width and depth on `make_mesh(MeshConfig(
    axis_sizes=TM_SIZES), devices=["cuda:0"] * 4)`, seeded as phase T
    seeds it (seed 5, `train_views`). (a) bf16: TM_STEPS AdamW steps at
    `TRAIN_LR` on two views of B = 16 (8 a data shard): each model shard
    runs K3 on [8, 577, 512] with 8 heads and K4 at T = 4616, 1024 -> 2048
    -> 1024, forward and backward, 2 views x 24 blocks x 4 shards = 192
    launches a step of each, all on the tensor-core routes and at those
    shapes (counts set to 0 just before, read just after); the loss finite
    and falling; ms a step and the peak memory. (b) The bf16 witness: the
    mesh trainer's first step starts from the one-device trainer's
    weights (held equal bit for bit) and views; its gradient's distance
    from the plain fp32 tower's (`plain_tower`, the fp32 one-device
    trainer from the same seed), all leaves together over the norm, at
    most 1.5x the one-device bf16 kernels' step's, and its loss's distance
    likewise. (c) Its state saved, restored with `mesh=` into a mesh
    trainer of another seed; the next step's loss of both equal bit for
    bit; one step profiled (`profiled`). (d) The strict fp32 witness: the
    fp32 tower on the same mesh (the split routes, 192 backward launches
    of each) against the one-device fp32 trainer, the same weights and
    views of B = F32_BATCH, one step: the loss within 1e-6 of
    max(1, |one-device|), every gradient within 1e-4 of max(1, its
    largest one-device value). (e) `reverso-torch --device cuda:0 train
    --tp 2` (a 1 x 2 mesh of the card) for 2 steps of 16 on phase T's
    photos. Returns (the launches of the mesh runs, their launches by
    shape, numbers)."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    import torch
    from reverso_tpu_torch import cli, kernels
    from reverso_tpu_torch.config import MODEL_PRESETS, MeshConfig
    from reverso_tpu_torch.parallel import make_mesh
    from reverso_tpu_torch.train import ClipTrainer
    from reverso_tpu_torch.train.checkpoint import restore_train_state, save_train_state

    cfg = MODEL_PRESETS["PE-Core-L14-336"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    va, vb = train_views(torch, cfg)
    mesh = make_mesh(MeshConfig(axis_sizes=TM_SIZES),
                     devices=["cuda:0"] * (TM_SIZES[0] * TM_SIZES[1]))
    per_step = 2 * cfg.depth * mesh.size   # two views, one call a block and shard
    launches, shapes = collections.Counter(), collections.Counter()
    out = {"mesh": list(TM_SIZES)}

    def counted(fn):
        """fn() with the counts set to 0 just before and read just after:
        (its result, its launches, its launches by shape), added to the
        phase's."""
        kernels.reset_counts()
        r = fn()
        torch.cuda.synchronize()
        launches.update(kernels.launches)
        shapes.update(kernels.shape_launches)
        return r, dict(kernels.launches), collections.Counter(kernels.shape_launches)

    def grad_dist(grads, ref) -> float:
        diff = sum(float((grads[n].to(g.device) - g).double().square().sum())
                   for n, g in ref.items())
        return (diff / sum(float(g.double().square().sum()) for g in ref.values())) ** 0.5

    # (b) the witness's references from seed 5: the plain fp32 tower and the
    # one-device bf16 kernels, first step
    t0 = time.perf_counter()
    t32 = ClipTrainer(cfg32, learning_rate=TRAIN_LR, seed=5)
    with plain_tower():
        loss_p, gp = t32.value_and_grad(va, vb)
    loss_p, gp = float(loss_p), {n: g.detach().clone() for n, g in gp.items()}
    t1 = ClipTrainer(cfg, learning_rate=TRAIN_LR, seed=5)
    loss_1, g1 = t1.value_and_grad(va, vb)
    loss_1, d1 = float(loss_1), grad_dist(g1, gp)
    del g1
    out["references_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tm = ClipTrainer(cfg, mesh, learning_rate=TRAIN_LR, seed=5)
    out["init_s"] = time.perf_counter() - t0
    same = tm.state.params
    check(all(torch.equal(p, same[n]) for n, p in t1.module.named_parameters()),
          "mesh trainer: seed 5's weights differ from the one-device trainer's")
    del t1, same
    torch.cuda.empty_cache()

    # (a) the bf16 run; its first step by hand, to keep its gradients
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    losses, step_ms = [], []
    for i in range(TM_STEPS):
        t0 = time.perf_counter()
        if i == 0:
            loss_m, gm = tm.value_and_grad(va, vb)
            tm.opt.step()
            tm.step += 1
            losses.append(float(loss_m))   # the loss reaches the host: a sync
        else:
            losses.append(tm.train_step(va, vb))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    run = dict(kernels.launches)
    run_shapes = collections.Counter(kernels.shape_launches)
    launches.update(run)
    shapes.update(run_shapes)
    out.update(losses=losses, step_ms=step_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches_per_step={k: n / TM_STEPS for k, n in run.items() if n})
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"mesh training: loss not finite and falling: {losses}")
    b, s, w = va.shape[0] // TM_SIZES[0], cfg.seq_len, cfg.width // TM_SIZES[1]
    heads, hid = cfg.num_heads // TM_SIZES[1], int(cfg.width * cfg.mlp_ratio) // TM_SIZES[1]
    bf = "torch.bfloat16"
    want = {("flash_heads_tc", (b, s, w, heads, True)),
            ("fused_mlp_tc", (b * s, cfg.width, hid, "gelu")),
            ("flash_heads_bwd", (b, s, w, heads, True, bf)),
            ("fused_mlp_bwd", (b * s, cfg.width, hid, "gelu", bf))}
    tower_shapes = {k: n for k, n in run_shapes.items() if k[0] != "add_layernorm"}
    check(set(tower_shapes) == want
          and all(n == TM_STEPS * per_step for n in tower_shapes.values()),
          f"mesh training: launches by shape {dict(run_shapes)}, not {TM_STEPS * per_step} "
          f"at each of {want}")
    # the norm sites run once a data shard, at full width on its home device
    norms = TM_STEPS * 2 * TM_SIZES[0] * (2 * cfg.depth + 2)
    check(run["add_layernorm"] == norms and kernels.plain_dispatches["norm_shape"] == 0,
          f"mesh training: add_layernorm launched {run['add_layernorm']} times, not {norms}")
    for name in ("flash_heads", "flash_heads_tc", "flash_heads_bwd", "flash_heads_bwd_tc",
                 "fused_mlp", "fused_mlp_tc", "fused_mlp_bwd", "fused_mlp_bwd_tc"):
        check(run[name] == TM_STEPS * per_step,
              f"mesh training: {name} launched {run[name]} times, not {TM_STEPS * per_step}")
    for name in ("flash_heads_split", "fused_mlp_split", "flash_heads_bwd_split",
                 "fused_mlp_bwd_split", "flash_attn", "fused_mlp_int8"):
        check(run[name] == 0, f"mesh training: {name} launched {run[name]} times")
    dm = grad_dist(gm, gp)
    del gm
    out.update(witness=dict(
        plain_loss=loss_p, one_device_loss=loss_1, mesh_loss=float(loss_m),
        one_device_grad_rel_err=d1, mesh_grad_rel_err=dm,
        one_device_loss_err=abs(loss_1 - loss_p), mesh_loss_err=abs(float(loss_m) - loss_p)))
    print(f"training on a {TM_SIZES[0]} x {TM_SIZES[1]} mesh: losses {losses}, ms a step "
          f"{step_ms}, peak {out['peak_gb']:.2f} GB; first step against the plain fp32 tower: "
          f"gradient error {dm:.4e} of its norm (one device, bf16: {d1:.4e}; limit 1.5x), "
          f"loss {float(loss_m)} (one device {loss_1}, plain {loss_p})", flush=True)
    check(dm <= 1.5 * d1, f"mesh witness: gradient error {dm} > 1.5 x the one-device {d1}")
    check(abs(float(loss_m) - loss_p) <= 1.5 * abs(loss_1 - loss_p),
          f"mesh witness: loss {float(loss_m)} vs plain {loss_p}, one device {loss_1}")

    # (c) checkpoint on the mesh, then one step profiled
    path = os.path.join(root, "tm_ckpt", "state.pt")
    t0 = time.perf_counter()
    save_train_state(path, tm.state)
    out["save_s"] = time.perf_counter() - t0
    t2 = ClipTrainer(cfg, mesh, learning_rate=TRAIN_LR, seed=6)
    t0 = time.perf_counter()
    t2.state = restore_train_state(path, t2.state, mesh=mesh)
    out["restore_s"] = time.perf_counter() - t0
    os.remove(path)
    (after, restored), _, _ = counted(lambda: (tm.train_step(va, vb), t2.train_step(va, vb)))
    out["next_loss"] = [after, restored]
    check(after == restored and int(t2.step) == TM_STEPS + 1,
          f"mesh checkpoint: next loss {restored} after the restore, {after} uninterrupted")
    del t2
    torch.cuda.empty_cache()
    out["profile_step"], _, _ = counted(lambda: profiled(torch, lambda: tm.train_step(va, vb)))
    del tm
    torch.cuda.empty_cache()

    # (d) the strict fp32 witness
    fa, fb = va[:F32_BATCH], vb[:F32_BATCH]
    loss_1, g1 = t32.value_and_grad(fa, fb)
    loss_1, g1 = float(loss_1), {n: g.detach().clone() for n, g in g1.items()}
    del t32
    tm32 = ClipTrainer(cfg32, mesh, learning_rate=TRAIN_LR, seed=5)
    (loss_m, gm), run, run_shapes = counted(lambda: tm32.value_and_grad(fa, fb))
    leaf = {n: float((gm[n] - g).abs().max()) / max(1.0, float(g.abs().max()))
            for n, g in g1.items()}
    worst = max(leaf, key=leaf.get)
    out["f32"] = dict(batch_a_view=F32_BATCH, loss=float(loss_m), one_device_loss=loss_1,
                      loss_rel_err=abs(float(loss_m) - loss_1) / max(1.0, abs(loss_1)),
                      grad_err=leaf[worst], worst_leaf=worst,
                      launches={k: n for k, n in run.items() if n})
    del tm32, gm, g1
    torch.cuda.empty_cache()
    print(f"fp32 on the mesh against one device (B = {F32_BATCH} a view): {out['f32']}",
          flush=True)
    for name in ("flash_heads_split", "flash_heads_bwd_split", "fused_mlp_split",
                 "fused_mlp_bwd_split"):
        check(run[name] == per_step, f"fp32 mesh step: {name} launched {run[name]} times")
    check(run["flash_heads_bwd_tc"] == run["fused_mlp_bwd_tc"] == 0,
          f"fp32 mesh step: bf16 backward routes launched {run}")
    check(out["f32"]["loss_rel_err"] <= 1e-6 and leaf[worst] <= 1e-4,
          f"fp32 mesh step: loss {float(loss_m)} vs {loss_1}, gradient {worst} {leaf[worst]} "
          f"of max(1, |one device|)")

    # (e) the command line on a 1 x 2 mesh of the card
    folder = os.path.join(root, "train_images")
    so, se = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(so), redirect_stderr(se):
        rc, run, _ = counted(lambda: cli.main(["--device", "cuda:0", "train", folder, "--tp", "2",
                                               "--steps", "2", "--batch-size", "16"]))
    out["cli_s"] = time.perf_counter() - t0
    out["cli_launches"] = {k: n for k, n in run.items() if n}
    print(f"reverso-torch --device cuda:0 train --tp 2: rc {rc}; {se.getvalue().strip()!r}; "
          f"{so.getvalue().strip()!r}", flush=True)
    check(rc == 0 and "step 2/2 loss" in se.getvalue() and "final loss" in so.getvalue(),
          f"reverso-torch train --tp 2: rc {rc}")
    check(run["flash_heads_bwd_tc"] == run["fused_mlp_bwd_tc"] == 2 * 2 * cfg.depth * 2,
          f"reverso-torch train --tp 2: backward launches {run}")
    del va, vb
    torch.cuda.empty_cache()
    print(f"training on a mesh (TM) numbers: {json.dumps(out)}", flush=True)
    return launches, shapes, out


SHARDS = 4   # phase S's mesh: four shards on cuda:0


def sharded_run(root: str, unit: np.ndarray) -> tuple:
    """(S) Meshes: the capacity rows (1,000,000 x 1024 unit rows) row-sharded
    over a mesh of SHARDS shards on cuda:0 (`make_mesh(devices=["cuda:0"] *
    SHARDS)`: the one card named SHARDS times), each index built with
    `mesh=` beside the same index on one device: K1 (bf16, Q = 256 and 1),
    K2 (10% of the rows kept), K9 (int8), K10 (binary) and K11 (IVF in
    bf16 and int8 at 1,024 clusters, nprobe 16, Q = 256 and 1; the sharded
    IVF loaded by `load_cache_device` from the single one's cache, over
    the rows on the card). Counts reset just before the sharded searches
    and read just after: each kernel launched once per shard and search.
    Each sharded result equals the single-device scan's bit for bit (ids
    and scores). Then the plain ops sharded against one device by the
    tie-margin rule (1e-5): best_score, discover and context over the 1M
    bf16 rows, manhattan and PQ over the first 100,000, MaxSim over
    20,000 points; and the mesh engine (`Reverso(use_mesh=True)`, its
    devices replaced by the SHARDS shards) answering a hybrid query (a
    sparse branch, the sharded dense branch, RRF) as the single engine
    does. Each sharded search timed beside the single-device one (CUDA
    events): the difference is the shards' launches and the merge.
    Returns (the launches of the sharded searches, their top-k shapes,
    K11's by_shape entries, the numbers)."""
    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MeshConfig, SearchConfig, StoreConfig, default_config
    from reverso_tpu_torch.engine import Reverso
    from reverso_tpu_torch.ops.pq import pq_encode, train_pq
    from reverso_tpu_torch.parallel import make_mesh, sharding
    from reverso_tpu_torch.store import (BinaryIndex, DeviceIndex, IVFIndex, MultiVecIndex,
                                         PQIndex, VectorStore)

    mesh = make_mesh(MeshConfig(), devices=["cuda:0"] * SHARDS)
    n, d = unit.shape
    rng = np.random.default_rng(47)
    q = unit[rng.choice(n, 256, replace=False)] + rng.standard_normal(
        (256, d), dtype=np.float32) * np.float32(0.02 / np.sqrt(d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = torch.from_numpy(q).cuda()
    q1 = qt[:1].clone()
    keep = torch.from_numpy(np.arange(n) % 10 == 3).cuda()
    emb = torch.from_numpy(unit).cuda()
    t0 = time.perf_counter()
    pairs = {}
    for name, make in (("K1", lambda m: DeviceIndex(unit, mesh=m)),
                       ("K9", lambda m: DeviceIndex(unit, dtype="int8", mesh=m)),
                       ("K10", lambda m: BinaryIndex(unit, mesh=m))):
        pairs[name] = (make(None), make(mesh))
    cache = os.path.join(root, "sharded_ivf.npz")
    ivf = IVFIndex.from_device(emb, n_clusters=1024, dtype="bfloat16", seed=0)
    ivf.save_cache(cache)
    pairs["K11"] = (ivf, IVFIndex.load_cache_device(emb, cache, mesh=mesh))
    pairs["K11 int8"] = (IVFIndex.load_cache_device(emb, cache, dtype="int8"),
                         IVFIndex.load_cache_device(emb, cache, dtype="int8", mesh=mesh))
    build_s = time.perf_counter() - t0
    check(all(len(pairs[k][1].matrix.parts) == SHARDS for k in pairs), "not SHARDS shards")
    searches = {"K1 Q=256": ("K1", lambda x: x.search(qt, 10)),
                "K1 Q=1": ("K1", lambda x: x.search(q1, 10)),
                "K2 Q=256": ("K1", lambda x: x.search(qt, 10, row_mask=keep)),
                "K9 Q=256": ("K9", lambda x: x.search(qt, 10)),
                "K10 Q=256": ("K10", lambda x: x.search(qt, 10)),
                "K11 Q=256": ("K11", lambda x: x.search(qt, 10, nprobe=16)),
                "K11 Q=1": ("K11", lambda x: x.search(q1, 10, nprobe=16)),
                "K11 int8 Q=256": ("K11 int8", lambda x: x.search(qt, 10, nprobe=16))}
    counters = {"K1": "topk_stream", "K2": "topk_masked", "K9": "topk_int8",
                "K10": "topk_binary", "K11": "ivf_scan"}
    captured = {}
    torch.cuda.synchronize()
    kernels.reset_counts()
    with ivf_inputs(captured):
        got = {name: fn(pairs[idx][1]) for name, (idx, fn) in searches.items()}
        torch.cuda.synchronize()
    launches = dict(kernels.launches)
    shapes = collections.Counter(kernels.shape_launches)
    ivf_counts = {key: c for key, c in shapes.items() if key[0] == "ivf_scan"}
    want = collections.Counter(counters[name.split()[0]] for name in searches)
    for counter, times in want.items():
        check(launches[counter] == SHARDS * times,
              f"{counter}: {launches[counter]} launches, not {SHARDS} a search x {times}")
    out = {"shards": SHARDS, "rows": n, "build_s": build_s, "launches": {
        c: launches[c] for c in want}, "sharded_ms": {}, "single_ms": {}}
    for name, (idx, fn) in searches.items():
        single, sharded = pairs[idx]
        s1, i1 = fn(single)
        s2, i2 = got[name]
        torch.cuda.synchronize()
        check(torch.equal(i1, i2) and torch.equal(s1, s2),
              f"sharded {name} differs from the single-device scan")
        out["single_ms"][name] = cuda_ms(lambda: fn(single))
        out["sharded_ms"][name] = cuda_ms(lambda: fn(sharded))
    k11_shapes = ivf_path_shapes(torch, ivf_counts, captured, "sharded")
    del captured, got

    # the plain ops, sharded against one device (the tie-margin rule)
    single, sharded = pairs["K1"]
    plain = {}
    ex = (unit[:2], unit[5:6])
    for name, fn in (("best_score", lambda x: x.best_score(*ex, k=10)),
                     ("discover", lambda x: x.discover(unit[7], unit[8:10], unit[10:12], k=10)),
                     ("context", lambda x: x.context(unit[8:10], unit[10:12], k=10))):
        topk_agree(*fn(single), *fn(sharded), 1e-5, f"sharded {name}")
        plain[name] = (sync_ms(torch, lambda: fn(single)), sync_ms(torch, lambda: fn(sharded)))
    del pairs, single, sharded, ivf
    sub = unit[:100_000]
    cb = train_pq(sub, 128, iters=5, sample=16384, seed=0)
    codes = pq_encode(sub, cb)
    subs, indptr = multivec_points(unit, 20_000, seed=49)
    mv_q = [subs[:4], subs[100:103]]
    for name, make, fn in (
            ("manhattan", lambda m: DeviceIndex(sub, distance="manhattan", mesh=m),
             lambda x: x.search(qt[:16], 10)),
            ("pq", lambda m: PQIndex(sub, m=128, codebooks=cb, codes=codes, mesh=m),
             lambda x: x.search(qt[:16], 10)),
            ("maxsim", lambda m: MultiVecIndex(subs, indptr, mesh=m),
             lambda x: tuple(torch.from_numpy(a) for a in x.search(mv_q, 10)))):
        single, sharded = make(None), make(mesh)
        topk_agree(*fn(single), *fn(sharded), 1e-5, f"sharded {name}")
        plain[name] = (sync_ms(torch, lambda: fn(single)), sync_ms(torch, lambda: fn(sharded)))
        del single, sharded
    out["plain_single_sharded_ms"] = plain

    # the mesh engine against the single engine: a hybrid query
    hyb_n = 4096
    dense = unit[:hyb_n]
    sp_rows = [{"indices": sorted(int(v) for v in rng.choice(60, 1 + i % 4, replace=False)),
                "values": rng.random(1 + i % 4).round(3).tolist()} for i in range(hyb_n)]
    with VectorStore.create(root, "hybrid_mesh", d, sparse={"text": {}}) as st:
        st.append(dense, [{"region_id": f"r{i}"} for i in range(hyb_n)], {"text": sp_rows})
    cfg = default_config().replace(store=StoreConfig(root_dir=root),
                                   search=SearchConfig())
    prefetch = [{"query": sp_rows[3], "using": "text", "limit": 16},
                {"query": dense[3].tolist(), "limit": 16}]
    answers = []
    real = sharding.local_devices
    sharding.local_devices = lambda: [torch.device("cuda", 0)] * SHARDS
    try:
        for use_mesh in (False, True):
            eng = Reverso(cfg, use_mesh=use_mesh)
            check((eng.mesh is not None) == use_mesh and (
                not use_mesh or eng.mesh.shape["data"] == SHARDS), "the engine's mesh")
            eng.load_database("hybrid_mesh")
            answers.append([(h["id"], h["score"]) for h in eng.query(
                prefetch=prefetch, fusion="rrf", k=8)])
    finally:
        sharding.local_devices = real
    check(answers[0] == answers[1], f"hybrid query: mesh {answers[1]} != single {answers[0]}")
    out["hybrid_hits"] = len(answers[0])
    del emb
    torch.cuda.empty_cache()
    print(f"sharded (S): {json.dumps(out)}", flush=True)
    return launches, {k: v for k, v in shapes.items() if k[0] != "ivf_scan"}, k11_shapes, out


BUILD_CENTERS = 65_536   # scripts/bench_capacity.py's generator


def corpus_chunks(torch, d: int, chunk: int, seed: int):
    """scripts/bench_capacity.py's generator shape on the card: 65,536
    unit centres, row r drawn from centre (r * 2654435761) mod 65,536 plus
    per-dimension noise of sigma sqrt((1 - 0.85) / 0.85 / d) (within-cluster
    cosine ~0.85), normalized; a window's noise seeded by its index, so any
    window is made again the same. Returns chunk_fn(lo, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(BUILD_CENTERS, d, generator=gen, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    sigma = float(np.sqrt((1 - 0.85) / 0.85 / d))

    def chunk_fn(lo, rows):
        g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + lo // chunk)
        r = torch.arange(lo, lo + rows, device="cuda", dtype=torch.int64)
        x = centers[(r * 2654435761) % BUILD_CENTERS]
        x += sigma * torch.randn(rows, d, generator=g, device="cuda")
        return x / x.norm(dim=1, keepdim=True)

    return chunk_fn


def exact_top10(torch, chunk_fn, n: int, chunk: int, q, dtype):
    """The exact top-10 of `q` over the generated rows in `dtype`, window
    by window (fp32 sums; the (-score, row) order), merged as it goes."""
    from reverso_tpu_torch.ops.topk import _select_topk
    best_s = torch.empty((len(q), 0), device="cuda")
    best_i = torch.empty((len(q), 0), dtype=torch.int64, device="cuda")
    qd = q.to(dtype).float()
    for lo in range(0, n, chunk):
        x = chunk_fn(lo, min(chunk, n - lo)).to(dtype).float()
        s = torch.cat([best_s, qd @ x.t()], 1)
        i = torch.cat([best_i, torch.arange(lo, lo + len(x), device="cuda").expand(len(q), -1)], 1)
        best_s, cols = _select_topk(s, 10)
        best_i = i.gather(1, cols)
        del x, s, i
    return best_s, best_i


def recall10(found: np.ndarray, truth: np.ndarray) -> float:
    """The share of each query's true top-10 among its found ids."""
    return float(np.mean([len(set(f) & set(t)) / 10 for f, t in zip(found, truth)]))


def device_builds_run() -> dict:
    """(B) The builds from a corpus that never exists as one array, made on
    the card window by window (`corpus_chunks`, 524,288-row windows): an
    int8 IVF of 8,388,608 x 1024 at 2,048 clusters through
    `IVFIndex.from_chunks` (8 GB of int8 rows; the fp32 source would be 32
    GB), and a binary index of 16,777,216 x 1024 through
    `BinaryIndex.from_chunks` (2 GB packed; its source 64 GB). Each:
    build seconds (synchronized), the peak device memory of the build
    (`max_memory_allocated`), search ms at Q = 1 and 256 (k = 10; IVF at
    nprobe 16; binary's candidates at k = 30, the engine's 3x
    oversampling), recall@10 against the exact top-10 regenerated window
    by window (IVF: over its stored int8 rows' exact scan, K9; binary:
    against the exact bf16 scan, the candidates' recall); and the IVF at
    nprobe = 2,048 (every cluster) against K9's exact scan of its sorted
    rows at Q = 16, by the tie-margin rule."""
    import torch
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk import cosine_topk_int8_exact
    from reverso_tpu_torch.store import BinaryIndex, IVFIndex

    d, chunk = 1024, 1 << 19
    out = {}
    rng = np.random.default_rng(53)
    for kind, n in (("ivf_int8", 8 << 20), ("binary", 16 << 20)):
        chunk_fn = corpus_chunks(torch, d, chunk, seed=59)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if kind == "ivf_int8":
            index = IVFIndex.from_chunks(chunk_fn, n, d, chunk=chunk, n_clusters=2048,
                                         dtype="int8", seed=0)
        else:
            index = BinaryIndex.from_chunks(chunk_fn, n, d, chunk=chunk)
        torch.cuda.synchronize()
        r = {"rows": n, "build_s": time.perf_counter() - t0,
             "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
             "index_gb": index.nbytes / 1e9}
        # queries: stored rows (of the first window) plus noise, cos ~0.96
        rows0 = chunk_fn(0, chunk)
        q = rows0[torch.from_numpy(rng.choice(chunk, 256, replace=False)).cuda()]
        q = q + (0.29 / np.sqrt(d)) * torch.randn(q.shape, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        del rows0
        if kind == "ivf_int8":
            search = lambda qs: index.search(qs, 10, nprobe=16)
            truth = exact_top10(torch, chunk_fn, n, chunk, q, torch.float32)[1]
        else:
            search = lambda qs: index.search(qs, 30)
            truth = exact_top10(torch, chunk_fn, n, chunk, q, torch.bfloat16)[1]
        found = search(q)[1]
        r["recall10"] = recall10(found.cpu().numpy(), truth.cpu().numpy())
        r["q1_ms"] = cuda_ms(lambda: search(q[:1]), iters=10)
        r["q256_ms"] = cuda_ms(lambda: search(q), iters=5)
        if kind == "ivf_int8":
            kernels.reset_counts()
            s, i = index.search(q[:16], 10, nprobe=2048)
            check(kernels.launches["ivf_scan"] == 1, "IVF all probes: not one K11 launch")
            es, pos = cosine_topk_int8_exact(index.matrix, index.db_scale, q[:16], 10)
            ei = index.row_ids[pos.long()]
            topk_agree(es, ei, s, i, 1e-6, "IVF at nprobe = clusters vs the exact int8 scan")
            r["all_probes_q16_ms"] = cuda_ms(lambda: index.search(q[:16], 10, nprobe=2048))
            r["exact_int8_q16_ms"] = cuda_ms(
                lambda: cosine_topk_int8_exact(index.matrix, index.db_scale, q[:16], 10))
            r["clusters"] = index.n_clusters
            r["cmax"] = index.cmax
        out[kind] = r
        del index, chunk_fn, q, truth, found
        torch.cuda.empty_cache()
    print(f"device builds (B): {json.dumps(out)}", flush=True)
    return out


# phase H: the hardware probes (P1-P5), and the rows they add
PROBE_ROWS = ("probe_dma", "probe_mxu", "probe_scan", "probe_dyn_dma", "probe_gather")


def probes_run(torch) -> tuple:
    """Phase H: each hardware probe (`reverso_tpu_torch/probes/`) once at its
    script's shape, every kernel counted, each held against its plain
    version (P1, P2 int8, P4 int8 and P5 exactly; P2 bf16 and fp32 element
    by element within `mxu_tol`; P3 on the script's queries and on queries
    drawn apart); then the modules' bench functions on their own seeded
    data: P1's sweep of rings, P2's checks at 64 steps and sustained rates
    with the SM clock, P3's variants beside K1, P4's offsets in both forms
    and at blocks that do not overlap, P5's table sizes and K8 at the
    script's shapes. Prints the measured peaks (the card, its power limit,
    the SM clock, the highest read rate of P1 and P4, P4's rate of loads
    from L2, P2's highest rates) and returns (rows, peaks, launches)."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.probes import (bench_deformable as p5, bench_dma as p1,
                                          bench_mxu as p2, bench_scan_overlap as p3,
                                          proto_dyn_dma as p4, card, reassociation_tol,
                                          sm_clock_mhz, timed_ms)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    db, q = p3.seeded(p3.N, p3.D, p3.Q, dev, gen)        # 1M x 1024 bf16, P1's rows too
    dtypes = (torch.bfloat16, torch.int8, torch.float32)
    operands = {dt: p2.seeded_operands(dt, p2.M, p2.K, p2.N, dev, gen) for dt in dtypes}
    mats = {dt: p4.seeded(dt, p4.N, p4.D, dev, gen) for dt in p4.DTYPES}
    offs = torch.randint(0, p4.N - p4.ROWS, (p4.REPS,), generator=gen, device=dev,
                         dtype=torch.int32)
    tables = {n: p5.seeded(n, dev, gen) for n in p5.GATHER_ROWS}
    tile, _, streams, _ = p1.DEFAULT

    # the path: each probe once at its script's shape
    kernels.reset_counts()
    out1 = p1.stream_max(db, *p1.DEFAULT)
    out2 = {dt: p2.mxu(*operands[dt], p2.ITERS) for dt in dtypes}
    out3 = {v: p3.scan(db, q, v) for v in p3.VARIANTS}
    out4 = {dt: p4.dyn_dma(offs, mats[dt][1], mats[dt][0]) for dt in p4.DTYPES}
    out5 = {n: p5.gather(*tables[n]) for n in p5.GATHER_ROWS}
    torch.cuda.synchronize()
    launches = {name: kernels.launches[name] for name in PROBE_ROWS}
    check(all(launches[name] >= 1 for name in PROBE_ROWS),
          f"phase H: a probe kernel did not launch: {launches}")

    # each against its plain version
    err1 = max_err(out1, p1.stream_max_ref(db, tile, streams))
    check(err1 == 0.0, f"P1: max abs err {err1} (must be exact)")
    err2 = {}
    for dt in dtypes:   # each element within its gate, and a dropped step read against it
        a, b = operands[dt]
        err2[dt] = p2.compare(out2[dt], a, b, p2.ITERS)
        if dt != torch.int8:
            err2[dt]["dropped_step_reading"] = p2.dropped_step_reading(a, b, p2.ITERS)
    # P3 on the script's queries (the first rows: each query's max is its own
    # self-dot, in the first tiles) and on queries drawn apart (the max anywhere)
    apart = p3.queries(p3.Q, p3.D, dev, gen)
    err3 = {v: {"script_queries": p3.check(db, q, v, out3[v]),
                "queries_apart": p3.check(db, apart, v)} for v in p3.VARIANTS}
    err4 = {}
    for dt in p4.DTYPES:
        mat, qq = mats[dt]
        ref = torch.cat([p4.dyn_dma_ref(offs[c:c + 64], qq, mat) for c in range(0, p4.REPS, 64)])
        err4[dt] = max_err(out4[dt], ref)
        check(err4[dt] <= p4.dyn_dma_tol(qq, mat), f"P4 {dt}: max abs err {err4[dt]}")
    err5 = {n: max_err(out5[n], p5.gather_ref(*tables[n])) for n in p5.GATHER_ROWS}
    check(max(err5.values()) == 0.0, f"P5: max abs errs {err5} (must be exact)")
    print(f"phase H checks: P1 {err1}, P2 {err2}, P3 {err3} (tol {reassociation_tol(q, db):.3g}), "
          f"P4 {err4}, P5 {err5}", flush=True)

    # P1: the sweep of rings (each checked); its best rate is the measured read rate
    sweep = {cfg: p1.bench(db.shape[0], *cfg, device=dev, generator=gen, db=db, iters=5)["gb_s"]
             for cfg in p1.SWEEP if p1.fits(*cfg)}
    best = max(sweep, key=sweep.get)
    n1 = (db.shape[0] // tile) * tile * p1.D * 2
    ms1 = timed_ms(lambda: p1.stream_max(db, *p1.DEFAULT), 10)
    rows = {"probe_dma": dict(
        source="reverso_tpu_torch/csrc/probe_dma.cu", replaces="scripts/bench_dma.py:57",
        max_abs_err=err1, shape="1M x 1024 bf16, 32 KB stages (16 rows), 4 deep, 1 copy a "
        "stage, 1 CTA an SM (the script's (1024, 4, 1) at 1/64 of its tile)",
        ms=ms1, plain_ms=timed_ms(lambda: p1.stream_max_ref(db, tile, streams), 5),
        library="torch.amax(db, 0)", library_ms=p1.library_ms(db),
        gb_s=n1 / ms1 / 1e6, best_config=list(best), best_gb_s=sweep[best],
        sweep_gb_s={"x".join(map(str, c)): round(v, 1) for c, v in sweep.items()})}
    rows["probe_dma"]["bound_ms"], rows["probe_dma"]["bound_by"] = bound(
        n1 + 8 * p1.D * 4, (db.shape[0] // tile) * streams * min(8, tile // streams) * p1.D,
        "float32")

    # P2: each case at the script's 1024 steps, and its sustained rate
    rates = {}
    for dt in dtypes:
        a, b = operands[dt]
        r = p2.bench(dt, device=dev, generator=gen)
        flops = 2.0 * p2.M * p2.K * p2.N * p2.ITERS
        b_ms, b_by = bound(a.numel() * a.element_size() + b.numel() * b.element_size()
                           + 8 * p2.N * 4, flops,
                           "float32_split" if dt == torch.float32 else r["dtype"])
        ms = timed_ms(lambda: p2.mxu(a, b, p2.ITERS), 10)
        rates[r["dtype"]] = dict(
            ms=ms, bound_ms=b_ms, bound_by=b_by, **err2[dt],
            plain_ms=timed_ms(lambda: p2.mxu_ref(a, b, p2.ITERS), 3),
            ops_s_at_script_steps=flops / (ms * 1e-3), bench_checks=r["checks"],
            sustained_steps=r["timed_iters"], sustained_ms=r["ms"], ops_s=r["ops_s"],
            sm_clock_mhz=r["sm_clock_mhz"])
    bf = rates["bfloat16"]
    rows["probe_mxu"] = dict(
        source="reverso_tpu_torch/csrc/probe_mxu.cu", replaces="scripts/bench_mxu.py:46",
        max_abs_err=bf["max_abs_err"], shape=f"M, K, N = 256, 1024, 1024, bf16 -> fp32, "
        f"{p2.ITERS} steps (int8 and the fp32 split mode in `rates`)", ms=bf["ms"],
        plain_ms=bf["plain_ms"], bound_ms=bf["bound_ms"], bound_by=bf["bound_by"],
        library="none: no one PyTorch call computes the function", library_ms=None,
        rates=rates, matmul_8192_bf16=p2.matmul_rate(dev, gen))

    # P3: the variants beside K1 over the same rows and queries
    ms3 = {v: timed_ms(lambda: p3.scan(db, q, v)) for v in p3.VARIANTS}
    k1 = p3.k1_ms(db, q)
    rows["probe_scan"] = dict(
        source="reverso_tpu_torch/csrc/probe_scan.cu",
        replaces="scripts/bench_scan_overlap.py:144",
        max_abs_err=max(e for errs in err3.values() for e in errs.values()),
        shape="1M x 1024 bf16 rows, Q = 256 (the first rows), unroll (TILE = 128)",
        ms=ms3["unroll"], plain_ms=timed_ms(lambda: p3.scan_ref(db, q, "unroll"), 3),
        library="none: no one PyTorch call (a matmul and an amax)", library_ms=None,
        stage_ms=ms3["stage"], wide_ms=ms3["wide"], k1_ms=k1,
        unroll_share_of_k1=ms3["unroll"] / k1, errors=err3)
    rows["probe_scan"]["bound_ms"], rows["probe_scan"]["bound_by"] = bound(
        db.numel() * 2 + q.numel() * 2 + p3.Q * p3.TILE * 4, 2 * p3.Q * p3.N * p3.D, "bfloat16")

    # P4: aligned against unaligned offsets, one CTA and the grid
    forms = {}
    for dt in p4.DTYPES:
        r = p4.bench(dt, device=dev, generator=gen)
        for name in ("aligned", "unaligned", "aligned2", "unaligned2", "distinct_aligned",
                     "distinct_unaligned", "in_l2"):
            forms[f"{r['dtype']} {name}"] = r[name]
    mat, qq = mats[torch.bfloat16]
    distinct4 = p4.distinct_rows(offs)    # the rows its overlapping blocks cover: read once
    ms4 = timed_ms(lambda: p4.dyn_dma(offs, qq, mat), 10)
    rows["probe_dyn_dma"] = dict(
        source="reverso_tpu_torch/csrc/probe_dyn_dma.cu",
        replaces="scripts/proto_dyn_dma.py:58", max_abs_err=err4[torch.bfloat16],
        shape=f"262,144 x 1024 bf16, 512 reps of 512 rows at unaligned offsets ({distinct4} "
        "distinct rows), the grid (one CTA an SM)", ms=ms4,
        plain_ms=timed_ms(lambda: p4.dyn_dma_ref(offs, qq, mat), 1),
        library="none: no one PyTorch call (a gather of row blocks and a batched matmul)",
        library_ms=None, distinct_rows=distinct4, forms=forms,
        int8_max_abs_err=err4[torch.int8])
    rows["probe_dyn_dma"]["bound_ms"], rows["probe_dyn_dma"]["bound_by"] = bound(
        distinct4 * p4.D * 2 + 8 * p4.D * 2 + p4.REPS * 4 + p4.REPS * 8 * p4.ROWS * 4,
        2 * 8 * p4.ROWS * p4.D * p4.REPS, "bfloat16")

    # P5: the gather at each table size; K8 at the script's shapes
    gathers = {}
    for n in p5.GATHER_ROWS:
        r = p5.bench_gather(n, device=dev, generator=gen)
        gathers[n] = {k: r[k] for k in ("ms", "ns_per_row", "marginal_ns_per_row", "in_smem")}
    tab, idx = tables[256]
    rows["probe_gather"] = dict(
        source="reverso_tpu_torch/csrc/probe_gather.cu",
        replaces="scripts/bench_deformable.py:110", max_abs_err=max(err5.values()),
        shape="tab [256, 128] fp32 in shared memory, 64 steps", ms=gathers[256]["ms"],
        plain_ms=timed_ms(lambda: p5.gather_ref(tab, idx), 3),
        library="none: no one PyTorch call (64 gathers and adds)", library_ms=None,
        by_table=gathers, k8_script_shapes_ms={
            str(dt): p5.k8_ms(dt, device=dev, generator=gen)
            for dt in (torch.float32, torch.bfloat16)})
    rows["probe_gather"]["bound_ms"], rows["probe_gather"]["bound_by"] = bound(
        3 * 256 * p5.LANES * 4, 256 * p5.LANES * p5.ITERS, "float32")

    # the measured peaks: the highest rate of device memory phase H saw (P1's
    # rings, each over the rows it streams; P4's grid at blocks that do not
    # overlap; the P1 and P4 rows over their bounds' bytes, P4's distinct
    # rows), the rate of loads from L2 (P4's grid inside L2_ROWS rows), and
    # each operand type's highest tensor-core rate (P2's sustained run or
    # its script's 1024 steps)
    reads = {f"P1 ring {'x'.join(map(str, c))}": v * 1e9 for c, v in sweep.items()}
    reads.update({f"P4 grid {k}": v["grid_gb_s"] * 1e9 for k, v in forms.items()
                  if "distinct" in k})
    reads.update({f"{name} row": rows[name]["bound_ms"].nbytes / rows[name]["ms"] * 1e3
                  for name in ("probe_dma", "probe_dyn_dma")})
    read_by = max(reads, key=reads.get)
    l2 = {k: v["grid_gb_s"] * 1e9 for k, v in forms.items() if k.endswith("in_l2")}
    l2_by = max(l2, key=l2.get)
    ops = {k: max(v["ops_s"], v["ops_s_at_script_steps"]) for k, v in rates.items()}
    peaks = {"card": card(dev), "sm_clock_mhz": sm_clock_mhz(dev),
             "bytes_s": reads[read_by], "bytes_s_from": read_by,
             "l2_bytes": getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                                 50 * 2 ** 20),
             "l2_bytes_s": l2[l2_by], "l2_bytes_s_from": f"P4 grid {l2_by}",
             "p1_best_ring": list(best), "p1_best_ring_bytes_s": sweep[best] * 1e9,
             "bfloat16": ops["bfloat16"], "int8": ops["int8"],
             "float32_split": ops["float32"],
             "sm_clock_mhz_under_load": {k: v["sm_clock_mhz"] for k, v in rates.items()},
             "float32": PEAK_OPS_S["float32"],
             "float32_source": "the data sheet's 67 TFLOP/s (the CUDA cores): no probe "
                               "measures it"}
    print(f"measured peaks: {json.dumps(peaks)}", flush=True)
    return rows, peaks, launches


def probe_sweeps() -> int:
    """`python3 chip_smoke.py --probes`: every probe module's full sweep, as
    `python -m reverso_tpu_torch.probes.<module>` runs it."""
    from reverso_tpu_torch.probes import (bench_deformable, bench_dma, bench_mxu,
                                          bench_scan_overlap, proto_dyn_dma)
    for mod in (bench_dma, bench_mxu, bench_scan_overlap, proto_dyn_dma, bench_deformable):
        print(f"== python -m {mod.__name__}", flush=True)
        rc = mod.main([])
        if rc != 0:
            return rc
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--backward-kernel-times"]:   # the backward rows' child process
        torch.backends.cuda.matmul.allow_tf32 = False
        return backward_kernel_times(torch, json.loads(sys.argv[2]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.probes import measured_bound
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds:.1f} s)",
          flush=True)
    if sys.argv[1:2] == ["--copy-soak"]:
        return copy_soak(torch, int((sys.argv[2:] or ["100"])[0]))
    if sys.argv[1:2] == ["--probes"]:
        return probe_sweeps()

    t_all = time.perf_counter()
    phases = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)
        return out

    probe_rows, peaks, probe_launches = phase("hardware probes (H)", probes_run, torch)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase("kernels (PR 1)", kernel_checks, torch, gen)
    rows.update(phase("kernels (region, long ViT)", region_kernel_checks, torch, gen))
    phase("attention edge cases", attention_edge_checks, torch, gen)
    torch.cuda.empty_cache()
    rows.update(phase("kernels (capacity)", capacity_kernel_checks, torch, gen))
    torch.cuda.empty_cache()
    int8_rows, int8_data = phase("kernels (int8)", int8_kernel_checks, torch, gen)
    rows.update(int8_rows)
    two_stage_launches, k12_shapes = phase("two-stage int8 search", int8_search_run, torch,
                                           int8_data)
    del int8_data
    torch.cuda.empty_cache()
    tower_launches = phase("tower parity", tower_check)
    long_launches = phase("vit 504 parity", vit_long_check)
    long_bf16_launches, long_f32_shapes = phase("vit 504 bf16 full depth", vit_long_bf16)
    torch.cuda.empty_cache()
    f32_launches, f32_shapes = phase("PE-L14-336 fp32 full depth", vit_f32_full)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        sam_split_launches = phase("detector parity", detector_parity, root)
        torch.cuda.empty_cache()
        direct_launches, k1_shapes, direct_tc_shapes = phase("direct-embed slice", slice_run,
                                                             root)
        clip_launches, clip_tc_shapes, clip_k1_shapes = phase("vision-checkpoint loaders",
                                                              loaders_run, root)
        torch.cuda.empty_cache()
        f32_slice_launches, f32_slice_shapes = phase("parity direct-embed slice (fp32)",
                                                     f32_slice_run, root)
        torch.cuda.empty_cache()
        int8_launches, k5_shapes = phase("int8 direct-embed slice", int8_slice_run, root)
        rows["fused_mlp_int8"]["by_shape"] = phase("K5 at the int8 path's shapes",
                                                   k5_path_shapes, torch, k5_shapes)
        region_launches, det, k8_shapes, deform_inputs = phase("region slice", region_run, root)
        rows["ms_deform"]["by_shape"] = phase("K8 at the region path's shapes", k8_path_shapes,
                                              torch, k8_shapes, deform_inputs)
        del deform_inputs
        roi_launches = phase("ROI slice", roi_run, root, det)
        del det
        torch.cuda.empty_cache()
        (capacity_launches, capacity_shapes, capacity_ivf_shapes, store_f32_launches,
         store_f32_shapes) = phase("capacity slice", capacity_run, root)
        torch.cuda.empty_cache()
        unit, scaled, queries = capacity_rows(root)
        euclid_launches, euclid_shapes = phase("euclid at capacity", euclid_run, scaled, queries)
        phase("manhattan at capacity", manhattan_run, scaled, queries)
        phase("PQ at capacity", pq_run, unit, queries)
        phase("example combines at capacity", combine_run, unit)
        phase("MaxSim", maxsim_run, unit)
        engine_launches, engine_shapes = phase("engine stores (euclid, manhattan, pq, "
                                               "multivector)", engine_stores_run, root, unit,
                                               scaled, queries)
        torch.cuda.empty_cache()
        sharded_launches, sharded_shapes, sharded_ivf_shapes, sharded = phase(
            "meshes (S)", sharded_run, root, unit)
        del unit, scaled, queries
        torch.cuda.empty_cache()
        builds = phase("device builds (B)", device_builds_run)
        torch.cuda.empty_cache()
        # last: it writes the capacity store, which no later phase reads
        surface_launches, surface_shapes, surface_ivf_shapes, surface = phase(
            "query and write surface (U)", surface_run, root)
        torch.cuda.empty_cache()
        entry_launches, entry_tc_shapes, entry_k1_shapes, _ = phase(
            "entry points (CLI, UI, video, text)", entry_points_run, root)
        torch.cuda.empty_cache()
        (train_rows, train_launches, train_tc_shapes, _, train_f32_launches,
         train_f32_shapes, train_bwd_shapes) = phase("training (T)", train_run, root)
        rows.update(train_rows)
        torch.cuda.empty_cache()
        mesh_launches, mesh_shapes, _ = phase("training on a mesh (TM)", mesh_train_run, root)
    torch.cuda.empty_cache()
    of = lambda names: collections.Counter({key: n for key, n in mesh_shapes.items()
                                            if key[0] in names})
    rows["fused_mlp_f32"]["by_shape"], rows["flash_heads_f32"]["by_shape"] = phase(
        "K3 and K4 fp32 at their paths' shapes", f32_path_shapes, torch,
        {**f32_shapes, **long_f32_shapes}, tower_launches,
        collections.Counter(train_f32_shapes) + of(("flash_heads_split", "fused_mlp_split")))
    rows["flash_heads"]["by_shape"], rows["fused_mlp"]["by_shape"] = phase(
        "K3 and K4 bf16 at their paths' shapes", tc_path_shapes, torch,
        collections.Counter(direct_tc_shapes) + collections.Counter(clip_tc_shapes)
        + collections.Counter(entry_tc_shapes) + collections.Counter(train_tc_shapes)
        + of(("flash_heads_tc", "fused_mlp_tc")))
    # the backward rows: each row's own timing shape (its device time by
    # kernel) and every shape phases T and TM launched it at (`by_shape`)
    bwd_paths = train_bwd_shapes + of(BWD_COUNTERS)
    own = {"flash_heads_bwd": ("flash_heads_bwd", (16, 577, 1024, 16, True, "torch.bfloat16")),
           "flash_heads_bwd_f32": ("flash_heads_bwd", (2, 577, 1024, 16, True, "torch.float32")),
           "fused_mlp_bwd": ("fused_mlp_bwd", (9232, 1024, 4096, "gelu", "torch.bfloat16")),
           "fused_mlp_bwd_f32": ("fused_mlp_bwd", (9232, 1024, 4096, "gelu", "torch.float32"))}
    cases = phase("K3 and K4 backward at their paths' shapes", backward_kernel_times_apart,
                  list(own.values()) + list(bwd_paths))
    for row, key in own.items():
        rows[row]["kernels_ms"] = cases[key]["kernels_ms"]
        rows[row]["kernels_ms_check"] = cases[key]["kernels_ms_check"]
        rows[row]["by_shape"] = [dict(cases[k], launches=n) for k, n in sorted(
            bwd_paths.items(), key=str) if backward_row(k) == row]
    path_shapes = collections.Counter()
    for shapes in (k1_shapes, capacity_shapes, k12_shapes, f32_slice_shapes, store_f32_shapes,
                   clip_k1_shapes, euclid_shapes, engine_shapes, surface_shapes,
                   entry_k1_shapes, sharded_shapes):
        path_shapes.update(shapes)
    topk_shapes = phase("top-k scans at their paths' shapes", topk_path_shapes, torch,
                        path_shapes)
    for name, shapes in topk_shapes.items():
        rows[name]["by_shape"] = shapes
    # K11 at each shape the capacity and surface paths ran it at, timed on
    # each path's own captured inputs
    rows["ivf_scan"]["by_shape"] = capacity_ivf_shapes + surface_ivf_shapes + sharded_ivf_shapes
    rows.update(probe_rows)

    # each kernel's launches on its own path: the tensor-core rows count the
    # bf16 core's launches, the fp32 rows the split mode's (on the parity
    # phases: SAM's on the split-mode route of phase 4); K1 and K2 on fp32
    # rows count their launches over every phase that drives a path (the
    # parity slice and the float32 store; each read just after the counts
    # were set to 0)
    path_runs = (two_stage_launches, tower_launches, long_launches, long_bf16_launches,
                 f32_launches, sam_split_launches, direct_launches, f32_slice_launches,
                 int8_launches, region_launches, roi_launches, capacity_launches,
                 store_f32_launches, clip_launches, euclid_launches, engine_launches,
                 surface_launches)
    path_of = {"flash_heads": direct_launches["flash_heads_tc"]
               + entry_launches["flash_heads_tc"] + train_launches["flash_heads_tc"]
               + mesh_launches["flash_heads_tc"],
               "flash_heads_f32": f32_launches["flash_heads_split"]
               + train_f32_launches["flash_heads_split"] + mesh_launches["flash_heads_split"],
               "fused_mlp": direct_launches["fused_mlp_tc"] + entry_launches["fused_mlp_tc"]
               + train_launches["fused_mlp_tc"] + mesh_launches["fused_mlp_tc"],
               "fused_mlp_f32": f32_launches["fused_mlp_split"]
               + train_f32_launches["fused_mlp_split"] + mesh_launches["fused_mlp_split"],
               "split_parts": f32_launches["split_parts"] + train_f32_launches["split_parts"]
               + mesh_launches["split_parts"],
               "topk_stream": direct_launches["topk_stream"] + surface_launches["topk_stream"]
               + entry_launches["topk_stream"] + sharded_launches["topk_stream"],
               "flash_attn": long_bf16_launches["flash_attn_tc"],
               "flash_attn_f32": long_launches["flash_attn_split"],
               "flash_attn_relbias": region_launches["flash_attn_relbias_tc"],
               "flash_attn_relbias_f32": sam_split_launches["flash_attn_relbias_split"],
               "topk_stream_f32": sum(run["topk_stream_f32"] for run in path_runs),
               "ms_deform": region_launches["ms_deform"],
               "topk_masked": capacity_launches["topk_masked"]
               + surface_launches["topk_masked"] + entry_launches["topk_masked"]
               + sharded_launches["topk_masked"],
               "topk_int8": capacity_launches["topk_int8"] + surface_launches["topk_int8"]
               + sharded_launches["topk_int8"],
               "topk_binary": capacity_launches["topk_binary"]
               + surface_launches["topk_binary"] + sharded_launches["topk_binary"],
               "ivf_scan": capacity_launches["ivf_scan"] + surface_launches["ivf_scan"]
               + sharded_launches["ivf_scan"],
               "fused_mlp_int8": int8_launches["fused_mlp_int8"],
               "topk_int8_rows": two_stage_launches["topk_int8_rows"],
               "flash_heads_bwd": train_launches["flash_heads_bwd_tc"]
               + mesh_launches["flash_heads_bwd_tc"],
               "fused_mlp_bwd": train_launches["fused_mlp_bwd_tc"]
               + mesh_launches["fused_mlp_bwd_tc"],
               "flash_heads_bwd_f32": train_f32_launches["flash_heads_bwd_split"]
               + mesh_launches["flash_heads_bwd_split"],
               "fused_mlp_bwd_f32": train_f32_launches["fused_mlp_bwd_split"]
               + mesh_launches["fused_mlp_bwd_split"],
               "add_layernorm": direct_launches["add_layernorm"]
               + entry_launches["add_layernorm"], **probe_launches}
    print(f"phases: {json.dumps(phases)}; total {time.perf_counter() - t_all:.1f} s "
          f"after the build", flush=True)
    for name in ("flash_heads", "fused_mlp", "fused_mlp_f32", "flash_heads_f32",
                 "flash_heads_bwd", "fused_mlp_bwd", "flash_heads_bwd_f32", "fused_mlp_bwd_f32",
                 "fused_mlp_int8", "ms_deform",
                 "topk_stream", "topk_masked", "topk_int8", "topk_binary", "topk_int8_rows",
                 "topk_stream_f32", "ivf_scan"):
        print(f"{name} at its path's shapes: {json.dumps(rows[name]['by_shape'])}", flush=True)

    # the order to redesign kernels in: first those one PyTorch call beats,
    # by how many times; then the rest by launches x (ms - bound_ms), summed
    # over the shapes a path ran a kernel at where the run timed each
    # (`by_shape`: K1, K2, K3 and K4 in bf16 and fp32, their backward rows,
    # K5, K8, K9, K10, K11, K12), else at the row's shape. Listed apart: rows
    # already redesigned;
    # rows whose library call computes another function are ranked by cost
    # only
    def cost(name):
        r = rows[name]
        if "by_shape" in r:
            return sum(e["launches"] * (e["ms"] - e["bound_ms"]) for e in r["by_shape"])
        return path_of[name] * (r["ms"] - r["bound_ms"])

    apart = {name: f"redesigned in PR {REDESIGNED[name]}" for name in rows if name in REDESIGNED}
    apart.update({name: "a hardware probe (phase H)" for name in PROBE_ROWS})
    ranked = {name: r for name, r in rows.items() if name not in apart}
    behind = sorted(((r["ms"] / r["library_ms"], name) for name, r in ranked.items()
                     if r["library_ms"] and r["ms"] > r["library_ms"]
                     and name not in OTHER_FUNCTION), reverse=True)
    slow = {name for _, name in behind}
    rest = sorted(((cost(name), name) for name in ranked if name not in slow), reverse=True)
    print("redesign order: behind one PyTorch call "
          f"{[(name, round(f, 2)) for f, name in behind]}; then by launches x "
          f"(ms - bound_ms), by shape where timed {[(name, round(v, 1)) for v, name in rest]}; "
          f"apart {[(name, why, round(rows[name]['ms'] / rows[name]['library_ms'], 2) if rows[name]['library_ms'] else None, round(cost(name), 1)) for name, why in apart.items()]}",
          flush=True)
    print(f"sharded (S) numbers: {json.dumps(sharded)}", flush=True)
    print(f"device builds (B) numbers: {json.dumps(builds)}", flush=True)
    print(f"surface (U) numbers: {json.dumps(surface)}", flush=True)
    # every row's bytes and operations again at the rates phase H measured
    # (bound_ms keeps the published peaks); fp32 work off the tensor cores
    # keeps the data sheet's 67 TFLOP/s
    for name, r in rows.items():
        b = r["bound_ms"]
        check(isinstance(b, BoundMs), f"{name}: its bound_ms keeps no bytes and operations")
        r["measured_bound_ms"], r["measured_bound_by"] = measured_bound(b.nbytes, b.ops,
                                                                        b.dtype, peaks)
        check(r["ms"] >= r["measured_bound_ms"] * (1 - 1e-9),   # (rounding)
              f"{name}: {r['ms']} ms, under its measured bound {r['measured_bound_ms']} ms")
        if b.dtype == "float32":
            r["measured_bound_fp32_rate"] = peaks["float32_source"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "measured_bound_ms",
            "measured_bound_by", "library_ms", "shape", "library")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=r["source"], replaces=r["replaces"],
             launches=path_of[name], **{k: r[k] for k in keys},
             **{k: v for k, v in r.items() if k not in keys + ("source", "replaces")})
        for name, r in rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
