"""The fp32 split routes of K3 and K4 (three bf16 parts a value, six
products): what the CPU can hold of them.

* `mlp_split_ref` (the split GEMMs' plain version) and
  `flash_attention_heads_split_ref` (the heads-in-lanes split mode's)
  against the JAX package's Pallas kernels in fp32, interpret mode, and
  against the exact fp32 plain versions, at the card's fp32 gates;
* the split pass's layout (`ops/split.py::split_parts`): parts that
  reconstruct fp32 exactly, zero pads, the one-part form;
* the tower's cache of the weights' parts (`models/vit.py::MLP`);
* the arithmetic the kernels add around the products, emulated in numpy:
  the lanes' per-element RoPE (partner d / 4 away) against the plain
  rotation bit for bit, the split GEMM's per-step sums, and the bf16
  route's zero padding.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.ops import attention as jattn
from reverso_tpu.ops import fused_mlp as jmlp
from reverso_tpu_torch import kernels
from reverso_tpu_torch.config import MODEL_PRESETS
from reverso_tpu_torch.ops import attention as tattn
from reverso_tpu_torch.ops import rope as trope
from reverso_tpu_torch.ops import split as tsplit

tmlp = importlib.import_module("reverso_tpu_torch.ops.fused_mlp")

TOL_F32 = 2e-5       # the card's fp32 attention gate (chip_smoke.py, test_torch_cuda.py)
TOL_MLP_F32 = 1e-4   # the card's fp32 MLP gate


def _mlp_inputs(seed, t=50, w=64, hid=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, w)).astype(np.float32)
    w1 = (rng.standard_normal((hid, w)) * w ** -0.5).astype(np.float32)   # Linear [out, in]
    b1 = (rng.standard_normal(hid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((w, hid)) * hid ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(w) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_split_ref_matches_jax(act):
    """The split GEMMs' plain version against the JAX fp32 kernel (its
    products at HIGHEST, its A&S gelu) and against the exact `mlp_ref`."""
    x, w1, b1, w2, b2 = _mlp_inputs(4)
    ref = np.asarray(jmlp.fused_mlp(jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(b1),
                                    jnp.asarray(w2.T), jnp.asarray(b2), act=act,
                                    row_tile=64, hidden_tile=128, interpret=True))
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    split = tmlp.mlp_split_ref(*args, act=act)
    assert split.dtype == torch.float32
    np.testing.assert_allclose(split.numpy(), ref, atol=2e-5)
    exact = tmlp.mlp_ref(*args, act=act)
    assert float((split - exact).abs().max()) <= TOL_MLP_F32 / 10


@pytest.mark.parametrize("use_rope", [True, False])
@pytest.mark.parametrize("kv_valid", [None, 23])
def test_flash_heads_split_ref_matches_jax(use_rope, kv_valid):
    """The heads-in-lanes split mode's plain version (q and k rotated in
    fp32, the scale folded into q, six products a product, p in fp32)
    against the JAX kernel in fp32, interpret mode, and the exact plain
    version: S = 37, W = 64, 4 heads of 16."""
    rng = np.random.default_rng(2)
    b, s, w, heads = 2, 37, 64, 4
    q, k, v = (rng.standard_normal((b, s, w)).astype(np.float32) for _ in range(3))
    cos, sin = trope.rope_2d_tables(6, w // heads) if use_rope else (None, None)
    ref = np.asarray(jattn.flash_attention_heads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads, cos=cos,
        sin=sin, kv_valid=kv_valid, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    split = tattn.flash_attention_heads_split_ref(*t, heads=heads, cos=cos, sin=sin,
                                                  kv_valid=kv_valid)
    assert split.dtype == torch.float32 and split.shape == (b, s, w)
    np.testing.assert_allclose(split.numpy(), ref, atol=3e-5, rtol=1e-4)
    exact = tattn.flash_attention_heads_ref(*t, heads=heads, cos=cos, sin=sin,
                                            kv_valid=kv_valid)
    assert float((split - exact).abs().max()) <= TOL_F32


def test_flash_heads_split_ref_at_the_tower_shape():
    """One head count and width of PE-L14 (hd 64) at S = 577 with RoPE and
    kv_valid < S: the split plain version within the card's fp32 gate of
    the exact one."""
    rng = np.random.default_rng(5)
    b, s, w, heads = 1, 577, 128, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32))
               for _ in range(3))
    cos, sin = trope.rope_2d_tables(24, w // heads)
    kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=300)
    err = float((tattn.flash_attention_heads_split_ref(q, k, v, **kw)
                 - tattn.flash_attention_heads_ref(q, k, v, **kw)).abs().max())
    assert err <= TOL_F32 / 4


@pytest.mark.parametrize("rows,cols,out_rows", [(5, 13, 5), (7, 64, 9), (1, 1, 1), (3, 8, 8)])
def test_split_parts_layout(rows, cols, out_rows):
    """[rows, cols] -> bf16 [3, out_rows, pitch] (pitch = cols rounded up to
    8): hi, mid and lo as `split3` makes them, summing to the fp32 values
    exactly, zeros past the rows and columns; the one-part form rounds to
    bf16 (fp32) or copies (bf16)."""
    rng = np.random.default_rng(rows * cols)
    x = torch.from_numpy((rng.standard_normal((rows, cols)) * 10.0 ** rng.integers(-6, 6, (rows, cols)))
                         .astype(np.float32))
    p = tsplit.split_parts(x, 3, out_rows=out_rows)
    pitch = -(-cols // 8) * 8
    assert p.shape == (3, out_rows, pitch) and p.dtype == torch.bfloat16
    hi, mid, lo = tsplit.split3(x)
    for part, ref in zip(p, (hi, mid, lo)):
        assert torch.equal(part[:rows, :cols].float(), ref)
    assert torch.equal(p[0, :rows, :cols].float() + p[1, :rows, :cols].float()
                       + p[2, :rows, :cols].float(), x)
    assert not p[:, rows:].any() and not p[:, :, cols:].any()
    one = tsplit.split_parts(x, 1)
    assert one.shape == (1, rows, pitch)
    assert torch.equal(one[0, :, :cols], x.to(torch.bfloat16)) and not one[0, :, cols:].any()
    xb = x.to(torch.bfloat16)
    assert torch.equal(tsplit.split_parts(xb, 1, out_rows=out_rows)[0, :rows, :cols], xb)


def test_split_parts_checks():
    m = lambda *shape, dtype=torch.float32: torch.empty(*shape, device="meta", dtype=dtype)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tsplit.split_parts(m(4, 8), 3)
    with pytest.raises(ValueError, match="parts"):
        tsplit.split_parts(torch.zeros(4, 8), 2)
    with pytest.raises(ValueError, match="3 parts"):
        tsplit.split_parts(torch.zeros(4, 8, dtype=torch.bfloat16), 3)
    with pytest.raises(ValueError, match="out_rows"):
        tsplit.split_parts(torch.zeros(4, 8), 3, out_rows=3)
    assert kernels.launches == before


def test_mlp_split_weight_cache():
    """The fp32 tower's MLP keeps its weights' parts: they reconstruct the
    fp32 weights exactly, come back from the cache while the parameters
    are unchanged, and are made again after an in-place update."""
    from reverso_tpu_torch.models.vit import MLP

    cfg = MODEL_PRESETS["test-tiny"]
    mlp = MLP(cfg)
    gen = torch.Generator().manual_seed(0)
    for lin in (mlp.fc1, mlp.fc2):
        lin.reset_parameters(gen)
    parts = mlp._split_weights()
    assert mlp._split_weights() is parts
    hidden = int(cfg.width * cfg.mlp_ratio)
    assert parts.w1.shape == (3, hidden, cfg.width) and parts.w2.shape == (3, cfg.width, hidden)
    for p, wt in ((parts.w1, mlp.fc1.weight), (parts.w2, mlp.fc2.weight)):
        assert torch.equal(p[0].float() + p[1].float() + p[2].float(), wt.detach())
    with torch.no_grad():
        mlp.fc1.weight.mul_(3.0)
    again = mlp._split_weights()
    assert again is not parts
    assert torch.equal(again.w1[0].float() + again.w1[1].float() + again.w1[2].float(),
                       mlp.fc1.weight.detach())
    assert torch.equal(again.w2, parts.w2)
    # the CPU forward is the plain version, with or without the cache
    x = torch.randn(2, 5, cfg.width, generator=gen)
    assert torch.equal(mlp(x), tmlp.mlp_ref(x.reshape(-1, cfg.width), mlp.fc1.weight,
                                            mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias)
                       .reshape(x.shape))


def _rope_lanes(x, cos, sin, mul):
    """csrc/flash_tc.cuh::lane_tile_rope over a row's 8-column units, in
    numpy fp32: where the head fills its padded width and d / 4 % 8 == 0 a
    unit reads its partner unit d / 4 away, elsewhere each element its own
    partner; x * cos + (-+partner) * sin with each product and the sum
    rounded, times mul."""
    f = np.float32
    s, d = x.shape
    qh = d // 4
    out = np.zeros_like(x)
    hd = -(-d // 16) * 16
    for c in range(0, hd, 8):
        cols = [col for col in range(c, c + 8) if col < d]
        if d == hd and qh % 8 == 0:
            lower = (c // qh) % 2 == 0
            pc = c + qh if lower else c - qh
            partner = x[:, pc:pc + 8] * f(-1 if lower else 1)
        else:
            partner = np.stack([x[:, col + qh] * f(-1) if (col // qh) % 2 == 0 else x[:, col - qh]
                                for col in cols], axis=1) if cols else None
        if not cols:
            continue
        rot = (x[:, cols] * cos[:, cols]).astype(f) + (partner * sin[:, cols]).astype(f)
        out[:, cols] = (rot.astype(f) * f(mul)).astype(f)
    return out


@pytest.mark.parametrize("d", [16, 20, 40, 48, 64, 96, 128])
def test_lane_rope_matches_the_plain_rotation(d):
    """The lanes' rotation (its unit and per-element partner paths) equals
    the plain version's `rotate` bit for bit, with and without the scale."""
    rng = np.random.default_rng(d)
    s = 50
    x = rng.standard_normal((s, d)).astype(np.float32)
    cos = rng.uniform(-1, 1, (s, d)).astype(np.float32)
    sin = rng.uniform(-1, 1, (s, d)).astype(np.float32)
    for mul in (1.0, d ** -0.5):
        ref = trope.rotate(torch.from_numpy(x), cos, sin, mul).numpy()
        np.testing.assert_array_equal(_rope_lanes(x, cos, sin, mul), ref)


def _split_gemm(a, b, bk=32):
    """csrc/fused_mlp.cu's split GEMM in numpy fp32: a [M, K] @ b [N, K]^T,
    each bk-deep step's six products (smallest first) summed in a fresh
    fp32 accumulator, then added to the running fp32 tile."""
    ap, bp = tsplit.split3(torch.from_numpy(a)), tsplit.split3(torch.from_numpy(b))
    ap, bp = [p.numpy() for p in ap], [p.numpy() for p in bp]
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], bk):
        step = np.zeros_like(acc)
        for i, j in tsplit.SPLIT_TERMS:
            step = (step + ap[i][:, k0:k0 + bk] @ bp[j][:, k0:k0 + bk].T).astype(np.float32)
        acc = (acc + step).astype(np.float32)
    return acc


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_split_gemm_emulation_holds_the_gate(act):
    """The split GEMMs' arithmetic (per-step sums, h kept fp32 between the
    two GEMMs, A&S gelu) against the exact `mlp_ref`, at PE-L14's K of
    1024 and 4096, within the card's fp32 gate."""
    x, w1, b1, w2, b2 = _mlp_inputs(9, t=24, w=1024, hid=4096)
    h = _split_gemm(x, w1) + b1
    h = tmlp._act_poly(torch.from_numpy(h), act).numpy()
    y = _split_gemm(h, w2) + b2
    ref = tmlp.mlp_ref(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)), act=act).numpy()
    assert float(np.abs(y - ref).max()) <= TOL_MLP_F32 / 4


def test_padded_mlp_computes_the_unpadded_one():
    """The bf16 route at widths that are not multiples of 8 runs the GEMMs
    on zero-padded copies (the split pass's one-part form, zero biases):
    the pad's hidden units are act(0) = 0 and meet zero columns of W2, so
    the first W columns are the unpadded MLP's (here in fp32, where the
    padded products sum the same terms and zeros)."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _mlp_inputs(3, t=40, w=68, hid=252))
    wp, hp = tsplit.round_pitch(68), tsplit.round_pitch(252)
    xp = tsplit.split_parts_ref(x, 1)[0].float()
    w1p = tsplit.split_parts_ref(w1, 1, out_rows=hp)[0].float()
    w2p = tsplit.split_parts_ref(w2, 1, out_rows=wp)[0].float()
    b1p = torch.nn.functional.pad(b1.bfloat16().float(), (0, hp - 252))
    b2p = torch.nn.functional.pad(b2.bfloat16().float(), (0, wp - 68))
    for act in ("gelu", "quick_gelu"):
        padded = tmlp.mlp_ref(xp, w1p, b1p, w2p, b2p, act=act)
        assert not padded[:, 68:].any()
        ref = tmlp.mlp_ref(*(a.bfloat16().float() for a in (x, w1, b1, w2, b2)), act=act)
        np.testing.assert_allclose(padded[:, :68].numpy(), ref.numpy(), atol=1e-6)
