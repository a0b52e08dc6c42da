"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA Hopper card and nvcc; elsewhere they skip. Run on
the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

They cover the small and ragged shapes (test-tiny widths, odd S and N,
fp32 and bf16); chip_smoke.py covers the full PE-Core-L14-336 shapes.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


# fp32: sums in another order (and online softmax); bf16: one output ulp
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _assert_close(out, ref, tol):
    """Max abs error within `tol`, NaN exactly where the plain version has
    NaN (kv_valid = 0 leaves every row without a key)."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    diff = (out.float() - ref.float())[~nan].abs()
    assert diff.numel() == 0 or float(diff.max()) <= tol


def _uses_tensor_cores(dtype, head_dim):
    """The wrappers' dispatch rules (ops/attention.py::heads_route and
    attention_route): whether a call takes the bf16 tensor-core core (heads
    in lanes: through TMA or the lanes' copy) rather than its fp32 split
    mode: bf16 at every head dim <= 128 (padded to a multiple of 16)."""
    return dtype == torch.bfloat16 and head_dim <= 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,kv_valid,rope", [
    (2, 17, 64, 4, None, True),       # test-tiny: hd 16, S = 17
    (3, 37, 64, 4, 23, True),
    (2, 145, 128, 4, None, False),    # hd 32, CLIP family
    (1, 577, 1024, 16, 300, True),    # PE-L14 widths
    (2, 50, 384, 4, None, True),      # hd 96
    (1, 1, 64, 1, None, True),        # S = 1, B * H = 1
    (2, 63, 128, 4, 1, True),         # hd 32, one valid key
    (1, 64, 256, 2, 63, True),        # hd 128, one full key tile
    (2, 65, 384, 4, 64, False),       # hd 96, a ragged tile past kv_valid
    (1, 129, 512, 4, 65, True),       # hd 128, kv_valid one past a tile
    (1, 129, 1024, 16, 128, True),    # kv_valid = S - 1
    (64, 33, 1024, 16, None, True),   # B * H = 1024
    (1, 70, 256, 4, 0, True),         # kv_valid = 0: NaN, as the plain version
    (2, 37, 80, 4, None, True),       # hd 20: padded to 32, the lanes' rotation per element
    (1, 129, 160, 4, 100, True),      # hd 40: padded to 48
    (2, 65, 96, 4, 64, False),        # hd 24, no RoPE
])
def test_flash_heads_kernel(dev, dtype, b, s, w, heads, kv_valid, rope):
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (flash_attention_heads,
                                                  flash_attention_heads_ref,
                                                  flash_attention_heads_split_ref)
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (_randn(gen, b, s, w, dtype=dtype) for _ in range(3))
    cos = sin = None
    if rope:
        cos = np.ones((s, w // heads), np.float32)
        sin = np.zeros_like(cos)
        grid = int(np.sqrt(s - 1))
        c, sn = rope_2d_tables(grid, w // heads)
        cos[:len(c)], sin[:len(c)] = c[:s], sn[:s]
    counts = ("flash_heads", "flash_heads_tc", "flash_heads_split")
    before = [kernels.launches[c] for c in counts]
    out = flash_attention_heads(q, k, v, heads=heads, cos=cos, sin=sin,
                                kv_valid=kv_valid)
    tc = _uses_tensor_cores(dtype, w // heads)   # else the split mode (fp32)
    assert [kernels.launches[c] - n for c, n in zip(counts, before)] == [1, int(tc), int(not tc)]
    ref = flash_attention_heads_ref(q, k, v, heads=heads, cos=cos, sin=sin,
                                    kv_valid=kv_valid)
    torch.cuda.synchronize()
    _assert_close(out, ref, TOLS[dtype])
    if not tc:
        split = flash_attention_heads_split_ref(q, k, v, heads=heads, cos=cos, sin=sin,
                                                kv_valid=kv_valid)
        _assert_close(out, split, TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,w,hid,act", [
    (50, 64, 256, "gelu"),            # test-tiny
    (33, 64, 256, "quick_gelu"),
    (577, 1024, 4096, "gelu"),        # PE-L14 widths
    (100, 1536, 8960, "gelu"),        # PE-G14 widths
    (1000, 1024, 4096, "quick_gelu"),  # T % 128 != 0: a ragged GEMM row tile
    (130, 72, 200, "gelu"),           # W, H % 8 == 0 but not whole GEMM tiles
    (40, 68, 252, "gelu"),            # W % 8 != 0: padded copies (bf16), a padded pitch (fp32)
    (4616, 1024, 4096, "gelu"),       # PE-L14 at B = 8: the fp32 tower's forward
])
def test_fused_mlp_kernel(dev, dtype, t, w, hid, act):
    """bf16 on the wgmma GEMMs (padded at widths % 8 != 0), fp32 on the
    same GEMMs in the split mode, held against `mlp_ref` (and fp32 also
    against `mlp_split_ref`)."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp, mlp_ref, mlp_split_ref

    gen = torch.Generator(device="cuda").manual_seed(t)
    x = _randn(gen, t, w, dtype=dtype)
    w1, b1 = _randn(gen, hid, w, dtype=dtype, scale=w ** -0.5), _randn(gen, hid, dtype=dtype, scale=0.1)
    w2, b2 = _randn(gen, w, hid, dtype=dtype, scale=hid ** -0.5), _randn(gen, w, dtype=dtype, scale=0.1)
    counts = ("fused_mlp", "fused_mlp_tc", "fused_mlp_split")
    before = [kernels.launches[c] for c in counts]
    out = fused_mlp(x, w1, b1, w2, b2, act=act)
    tc = dtype == torch.bfloat16
    assert [kernels.launches[c] - n for c, n in zip(counts, before)] == [1, int(tc), int(not tc)]
    ref = mlp_ref(x, w1, b1, w2, b2, act=act)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else TOLS[dtype]
    assert float((out.float() - ref.float()).abs().max()) <= tol
    if not tc:
        split = mlp_split_ref(x, w1, b1, w2, b2, act=act)
        assert float((out - split).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,q,k,n_valid", [
    (1000, 64, 7, 10, None),
    (4096, 128, 70, 5, 3001),     # two query tiles, n_valid < N
    (300, 32, 4, 20, 12),         # k > n_valid
    (5000, 96, 3, 128, None),     # k at the cap
    (20000, 1024, 1, 10, None),   # Q = 1: the wgmma scan's n8 block
    (20000, 256, 64, 5, None),    # the direct-embed path's search_batch
    (20000, 128, 256, 10, 19000),
    (20000, 128, 300, 10, None),  # Q above 256: two query blocks
    (20000, 128, 256, 128, None), # k = 128 at Q = 256: two query blocks
    # d = 1020 (fp32 rows through TMA, bf16 rows copied by the producer) and
    # d = 100 (bf16 copied), at Q = 1, 64 and 256 with k = 1 and 128
    (20000, 1020, 1, 1, None),
    (20000, 1020, 64, 128, 19999),
    (20000, 1020, 256, 1, None),
    (3000, 100, 64, 1, 2900),
    (3000, 100, 256, 128, None),
    (3000, 100, 1, 128, None),
])
def test_topk_kernel(dev, dtype, n, d, q, k, n_valid):
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref, launch_key

    gen = torch.Generator(device="cuda").manual_seed(n)
    db = torch.randn(n, d, generator=gen, device="cuda")
    db = (db / db.norm(dim=1, keepdim=True)).to(dtype)
    db[n // 2] = db[1]                      # a duplicate: tie -> lower row
    qs = torch.cat([db[1:2], _randn(gen, q - 1, d, dtype=dtype)])
    key = launch_key("topk_stream", dtype, (q, n if n_valid is None else n_valid, d, k, False))
    n0, s0 = kernels.launches["topk_stream"], kernels.shape_launches[key]
    f0 = kernels.launches["topk_stream_f32"]
    s, i = cosine_topk(db, qs, k, n_valid=n_valid)
    assert kernels.launches["topk_stream"] == n0 + 1
    assert kernels.launches["topk_stream_f32"] == f0 + int(dtype == torch.float32)
    assert kernels.shape_launches[key] == s0 + 1
    rs, ri = cosine_topk_ref(db, qs, k, n_valid=n_valid)
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    assert float((torch.where(fin, s - rs, 0)).abs().max()) <= 1e-4
    # ids equal where the ranked scores are clear of their neighbours
    gap = torch.diff(torch.where(fin, rs, -1e9), dim=1).abs()
    inf = torch.full((q, 1), float("inf"), device="cuda")
    clear = (torch.cat([inf, gap], 1) > 1e-4) & (torch.cat([gap, inf], 1) > 1e-4)
    assert torch.equal(torch.where(clear, i, -2), torch.where(clear, ri, -2))
    assert torch.equal(i[~fin], torch.full_like(i[~fin], -1))
    if k >= 2 and (n_valid is None or n_valid > n // 2):
        assert i[0, :2].tolist() == [1, n // 2]   # the tie goes to the lower row
    assert i[0, 0] == 1                           # at k = 1 too


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,skv,d,kv_valid", [
    (2, 3, 37, 37, 16, None),         # ragged S, one partial tile
    (1, 4, 200, 131, 6, 100),         # S_kv != S_q, head_dim % 4 != 0
    (2, 16, 1297, 1297, 64, None),    # PE-L14 at 504 px
    (1, 2, 130, 130, 80, 129),        # head_dim 80
    (1, 1, 1, 1, 64, None),           # S = 1, B * H = 1
    (2, 2, 63, 63, 32, 1),            # one valid key
    (1, 3, 64, 64, 128, 63),          # hd 128, one full tile
    (1, 2, 65, 65, 96, 64),           # hd 96
    (1, 2, 129, 129, 64, 65),
    (2, 2, 129, 100, 16, 99),         # S_kv != S_q, kv_valid = S_kv - 1
    (1, 2, 50, 200, 64, None),        # S_kv > S_q
    (64, 16, 65, 65, 64, None),       # B * H = 1024
    (1, 2, 70, 70, 64, 0),            # kv_valid = 0: NaN, as the plain version
])
def test_flash_attn_kernel(dev, dtype, b, h, sq, skv, d, kv_valid):
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import attention_ref, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(sq + d)
    q = _randn(gen, b, h, sq, d, dtype=dtype)
    k, v = (_randn(gen, b, h, skv, d, dtype=dtype) for _ in range(2))
    counts = ("flash_attn", "flash_attn_tc", "flash_attn_split")
    before = [kernels.launches[c] for c in counts]
    out = flash_attention(q, k, v, kv_valid=kv_valid)
    tc = _uses_tensor_cores(dtype, d)   # else the split mode (fp32)
    assert [kernels.launches[c] - n for c, n in zip(counts, before)] == [1, int(tc), int(not tc)]
    ref = attention_ref(q, k, v, kv_valid=kv_valid)
    torch.cuda.synchronize()
    _assert_close(out, ref, TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,g,d,sq,kv_valid", [
    (2, 3, 8, 16, 64, None),
    (1, 2, 14, 32, 150, 190),         # Sq not a multiple of the tile, kv_valid < S
    (1, 12, 64, 64, 4096, None),      # SAM ViT-B global layer
    (1, 2, 64, 64, 100, 4000),        # G = 64 (one lattice row a tile), kv_valid < S
    (1, 2, 8, 40, 70, 60),            # head dim 40: bf16 core padded (bf16), split (fp32)
])
def test_flash_attn_relbias_kernel(dev, dtype, b, h, g, d, sq, kv_valid):
    """The rel-pos bias takes the bf16 tensor-core core in bf16 at every
    head dim and in fp32 at head dims % 16 == 0, with bf16 operands as the
    TPU kernel: held against `attention_bf16_ref` within 2e-2 (bf16
    output: one output ulp; fp32 output: p rounded against the running
    max, not the final one) and against the fp32 `attention_ref` within
    2e-2 (the operands' bf16 rounding). fp32 at other head dims takes the
    split mode, held against `attention_ref` and `attention_split_ref` at
    the fp32 tolerance."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (attention_bf16_ref, attention_ref,
                                                  attention_split_ref, flash_attention)

    gen = torch.Generator(device="cuda").manual_seed(g * d)
    q = _randn(gen, b, h, sq, d, dtype=dtype)
    k, v = (_randn(gen, b, h, g * g, d, dtype=dtype) for _ in range(2))
    bh, bw = (_randn(gen, b, h, sq, g, dtype=torch.float32, scale=0.5) for _ in range(2))
    counts = ("flash_attn_relbias", "flash_attn_relbias_tc", "flash_attn_relbias_split",
              "flash_attn_tc")
    before = [kernels.launches[c] for c in counts]
    out = flash_attention(q, k, v, kv_valid=kv_valid, rel_bias=(bh, bw, g))
    tc = dtype == torch.bfloat16 or d % 16 == 0
    assert [kernels.launches[c] - n for c, n in zip(counts, before)] == [1, int(tc), int(not tc),
                                                                          0]
    assert out.dtype == dtype
    ref = attention_ref(q, k, v, kv_valid=kv_valid, rel_bias=(bh, bw, g))
    torch.cuda.synchronize()
    if tc:
        ref16 = attention_bf16_ref(q, k, v, kv_valid=kv_valid, rel_bias=(bh, bw, g))
        assert float((out.float() - ref16.float()).abs().max()) <= 2e-2
        assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    else:
        assert float((out.float() - ref.float()).abs().max()) <= TOLS[dtype]
        split = attention_split_ref(q, k, v, kv_valid=kv_valid, rel_bias=(bh, bw, g))
        assert float((out - split).abs().max()) <= TOLS[dtype]


@pytest.mark.parametrize("b,h,g,d,sq,kv_valid", [
    (1, 2, 64, 64, 100, 4000),        # SAM's G = 64: a 64-key tile is one lattice row
    (1, 2, 32, 128, 70, 1000),        # hd 128: 32-key tiles, G = 32 one lattice row
    (2, 2, 32, 96, 64, None),
    (1, 2, 14, 64, 150, 190),         # a lattice row across tiles
])
def test_flash_attn_split_relbias_kernel(dev, monkeypatch, b, h, g, d, sq, kv_valid):
    """SAM's rel-pos bias in fp32 forced onto the split mode (as
    chip_smoke.py's SAM parity does) at head dims the bf16 core takes:
    both of its bias modes, held against `attention_ref` at the fp32
    tolerance."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops import attention as attn

    monkeypatch.setattr(attn, "attention_route", lambda *a, **kw: "split")
    gen = torch.Generator(device="cuda").manual_seed(g * d + 1)
    q = _randn(gen, b, h, sq, d, dtype=torch.float32)
    k, v = (_randn(gen, b, h, g * g, d, dtype=torch.float32) for _ in range(2))
    bh, bw = (_randn(gen, b, h, sq, g, dtype=torch.float32, scale=0.5) for _ in range(2))
    n0 = kernels.launches["flash_attn_relbias_split"]
    out = attn.flash_attention(q, k, v, kv_valid=kv_valid, rel_bias=(bh, bw, g))
    assert kernels.launches["flash_attn_relbias_split"] == n0 + 1
    ref = attn.attention_ref(q, k, v, kv_valid=kv_valid, rel_bias=(bh, bw, g))
    torch.cuda.synchronize()
    _assert_close(out, ref, TOLS[torch.float32])


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.bfloat16, 6),
                                     (torch.bfloat16, 40), (torch.float32, 64),
                                     (torch.float32, 30)])
def test_flash_attn_unaligned_kernel(dev, dtype, d):
    """Operands one element into their buffers (no 16-byte alignment) and
    row strides TMA cannot take: bf16 rows copied by the producer's lanes,
    fp32 rows split from scalar loads."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import attention_ref, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(d)
    shape = (1, 3, 97, d)
    size = int(np.prod(shape))
    q, k, v = (_randn(gen, size + 1, dtype=dtype)[1:].view(shape) for _ in range(3))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    counts = ("flash_attn_tc", "flash_attn_split")
    before = [kernels.launches[c] for c in counts]
    out = flash_attention(q, k, v, kv_valid=90)
    bf = dtype == torch.bfloat16
    assert [kernels.launches[c] - n for c, n in zip(counts, before)] == [int(bf), int(not bf)]
    ref = attention_ref(q, k, v, kv_valid=90)
    torch.cuda.synchronize()
    _assert_close(out, ref, TOLS[dtype])


def _offset_view(gen, shape, dtype):
    """A [shape] view one element into its buffer: contiguous, its base
    not 16-byte aligned."""
    size = int(np.prod(shape))
    view = _randn(gen, size + 1, dtype=dtype)[1:].view(shape)
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("view", ["offset", "columns"])
def test_flash_heads_views_kernel(dev, dtype, view):
    """K3 on views the JAX function takes: q, k and v one element into their
    buffers (bf16 through the lanes' copy, which rotates K as it loads it),
    or column slices of one [B, S, 3W] qkv buffer (non-contiguous, copied
    first), with RoPE and kv_valid < S: equal to the plain version within
    the dtype's tolerance, and bit for bit to the same values passed as
    fresh contiguous tensors (the copy route computes what TMA's does)."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (flash_attention_heads,
                                                  flash_attention_heads_ref)
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    b, s, w, heads = 2, 145, 256, 4
    gen = torch.Generator(device="cuda").manual_seed(11)
    if view == "offset":
        q, k, v = (_offset_view(gen, (b, s, w), dtype) for _ in range(3))
    else:
        qkv = _randn(gen, b, s, 3 * w, dtype=dtype)
        q, k, v = qkv[..., :w], qkv[..., w:2 * w], qkv[..., 2 * w:]
        assert not q.is_contiguous()
    cos, sin = rope_2d_tables(12, w // heads)
    kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=130)
    counts = ("flash_heads_tc", "flash_heads_split")
    before = [kernels.launches[c] for c in counts]
    out = flash_attention_heads(q, k, v, **kw)
    bf = dtype == torch.bfloat16
    assert [kernels.launches[c] - n for c, n in zip(counts, before)] == [int(bf), int(not bf)]
    fresh = flash_attention_heads(*(t.clone(memory_format=torch.contiguous_format)
                                    for t in (q, k, v)), **kw)
    ref = flash_attention_heads_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(out, ref, TOLS[dtype])
    assert torch.equal(out, fresh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("view", ["offset", "columns"])
def test_fused_mlp_views_kernel(dev, dtype, view):
    """K4 on views: x, the weights and the biases one element into their
    buffers (copied only where TMA or the bias loads need it: bf16; fp32 x
    goes straight to the split pass), or x a column slice of a wider
    buffer (non-contiguous): equal to the plain version within the dtype's
    tolerance and bit for bit to fresh contiguous tensors of the same
    values."""
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp, mlp_ref

    t, w, hid = 333, 256, 1024
    gen = torch.Generator(device="cuda").manual_seed(12)
    if view == "offset":
        x = _offset_view(gen, (t, w), dtype)
        w1 = _offset_view(gen, (hid, w), dtype).mul_(w ** -0.5)
        w2 = _offset_view(gen, (w, hid), dtype).mul_(hid ** -0.5)
        b1, b2 = _offset_view(gen, (hid,), dtype), _offset_view(gen, (w,), dtype)
    else:
        x = _randn(gen, t, 2 * w, dtype=dtype)[:, w:]
        assert not x.is_contiguous()
        w1 = _randn(gen, hid, w, dtype=dtype, scale=w ** -0.5)
        w2 = _randn(gen, w, hid, dtype=dtype, scale=hid ** -0.5)
        b1, b2 = _randn(gen, hid, dtype=dtype, scale=0.1), _randn(gen, w, dtype=dtype, scale=0.1)
    args = (x, w1, b1, w2, b2)
    out = fused_mlp(*args)
    fresh = fused_mlp(*(a.clone(memory_format=torch.contiguous_format) for a in args))
    ref = mlp_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else TOLS[dtype]
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert torch.equal(out, fresh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_int8_views_kernel(dev, dtype):
    """K5 with int8 weights one element into their buffers (copied for
    TMA) and x one element into its buffer: bit for bit what the same
    values give as fresh tensors, and within the K5 bound of its plain
    version (as test_fused_mlp_int8_scratch_per_call)."""
    from reverso_tpu_torch.ops.fused_mlp import (fused_mlp_int8, mlp_int8_plain,
                                                 quantize_mlp_weights)

    t, w, hid = 301, 256, 1024
    gen = torch.Generator(device="cuda").manual_seed(13)
    qw = quantize_mlp_weights(_randn(gen, hid, w, dtype=dtype, scale=w ** -0.5),
                              _randn(gen, hid, dtype=dtype, scale=0.1),
                              _randn(gen, w, hid, dtype=dtype, scale=hid ** -0.5),
                              _randn(gen, w, dtype=dtype, scale=0.1), dtype)

    def offset(z):
        view = torch.empty(z.numel() + 1, dtype=z.dtype, device=z.device)[1:].view(z.shape)
        assert view.data_ptr() % 16
        return view.copy_(z)

    x = _offset_view(gen, (t, w), dtype)
    out = fused_mlp_int8(x, qw._replace(w1=offset(qw.w1), w2=offset(qw.w2)))
    fresh = fused_mlp_int8(x.clone(), qw)
    ref = mlp_int8_plain(x, qw, "gelu")
    torch.cuda.synchronize()
    assert torch.equal(out, fresh)
    diff = (out.float() - ref.float()).abs()
    ulp = 1e-5 if dtype == torch.float32 else 2 ** -7     # one output rounding
    assert float((diff > ulp * (1 + ref.float().abs())).float().mean()) < 0.002


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,shapes,lq,h,d,p", [
    (2, ((9, 13), (5, 7), (3, 4), (2, 2)), 11, 4, 8, 4),    # widths not multiples of 8
    (1, ((100, 100), (50, 50), (25, 25), (13, 13)), 900, 8, 32, 4),   # DINO decoder
])
def test_ms_deform_kernel(dev, dtype, b, shapes, lq, h, d, p):
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_ref

    gen = torch.Generator(device="cuda").manual_seed(lq)
    lv = sum(hl * wl for hl, wl in shapes)
    value = _randn(gen, b, lv, h, d, dtype=dtype)
    # points outside the map on every side
    loc = torch.rand(b, lq, h, len(shapes), p, 2, generator=gen, device="cuda") * 1.6 - 0.3
    w = torch.rand(b, lq, h, len(shapes), p, generator=gen, device="cuda")
    w = w / w.sum(dim=(-2, -1), keepdim=True)
    n0 = kernels.launches["ms_deform"]
    out = ms_deform_attn(value, shapes, loc, w)
    assert kernels.launches["ms_deform"] == n0 + 1
    ref = ms_deform_attn_ref(value, shapes, loc, w)
    torch.cuda.synchronize()
    # fp32: sums in another order; bf16: one output ulp (both sum in fp32)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((out.float() - ref.float()).abs().max()) <= tol


def _assert_topk_close(s, i, rs, ri, tol):
    """Kernel top-k against the plain version: the same -inf slots (idx
    -1), scores within `tol`, ids equal where the plain version's ranked
    scores are more than `tol` from their neighbours."""
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    assert torch.equal(i[~fin], torch.full_like(i[~fin], -1))
    assert float((torch.where(fin, s - rs, 0)).abs().max()) <= tol
    gap = torch.diff(torch.where(fin, rs, -1e9), dim=1).abs()
    inf = torch.full((rs.shape[0], 1), float("inf"), device=rs.device)
    clear = (torch.cat([inf, gap], 1) > tol) & (torch.cat([gap, inf], 1) > tol)
    assert torch.equal(torch.where(clear, i, -2), torch.where(clear, ri, -2))


def _unit_rows(gen, n, d):
    x = torch.randn(n, d, generator=gen, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


# ragged shapes: N not a multiple of the row tile, Q not a multiple of
# the query block, d not a multiple of 128 (or of 16), k > n_valid, every
# row masked
MASKED_CASES = [
    (1000, 64, 7, 10, None, 0.3),
    (4099, 200, 70, 5, 3001, 0.5),
    (300, 96, 4, 40, 20, 0.3),        # k > n_valid
    (513, 128, 65, 10, None, 0.0),    # every row masked
    (5000, 1024, 3, 128, None, 0.7),  # k at the cap
    (20000, 64, 1, 10, None, 0.3),    # Q = 1
    (20000, 1024, 64, 10, None, 0.1), # the capacity path's filtered search
    (20000, 128, 256, 10, 19000, 0.3),
    (20000, 128, 300, 10, None, 0.3), # Q above 256
    (20000, 128, 256, 128, None, 0.5),  # k = 128 at Q = 256
    (20000, 1020, 64, 10, 19000, 0.1),  # d = 1020 (bf16 rows copied by the producer)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,q,k,n_valid,keep", MASKED_CASES)
def test_topk_masked_kernel(dev, dtype, n, d, q, k, n_valid, keep):
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref, launch_key

    gen = torch.Generator(device="cuda").manual_seed(n + d)
    db = _unit_rows(gen, n, d).to(dtype)
    db[n // 2] = db[1]                       # a duplicate: tie -> lower row
    mask = torch.rand(n, generator=gen, device="cuda") < keep
    mask[1] = mask[n // 2] = keep > 0
    qs = torch.cat([db[1:2], _unit_rows(gen, q - 1, d).to(dtype)])
    key = launch_key("topk_masked", dtype, (q, n if n_valid is None else n_valid, d, k, True))
    n0, s0 = kernels.launches["topk_masked"], kernels.shape_launches[key]
    s, i = cosine_topk(db, qs, k, n_valid=n_valid, row_mask=mask)
    assert kernels.launches["topk_masked"] == n0 + 1
    assert kernels.shape_launches[key] == s0 + 1
    rs, ri = cosine_topk_ref(db, qs, k, n_valid=n_valid, row_mask=mask)
    torch.cuda.synchronize()
    _assert_topk_close(s, i, rs, ri, 1e-4)    # fp32 sums in another order
    kept = mask.clone()
    if n_valid is not None:
        kept[n_valid:] = False
    assert bool(kept[i[i >= 0].long()].all()), "a masked row came back"
    if keep == 0.0:
        assert bool((i == -1).all()) and bool(torch.isneginf(s).all())
    elif n_valid is None or n_valid > n // 2:
        assert i[0, :2].tolist() == [1, n // 2]


@pytest.mark.parametrize("n,d,q,k,n_valid,keep", MASKED_CASES + [
    (2000, 1040, 9, 10, None, None),  # the exactness bound on d
    (1500, 77, 66, 16, 1400, None),   # d not a multiple of 16: byte copies
])
def test_topk_int8_kernel(dev, n, d, q, k, n_valid, keep):
    """K9 against its plain version: ids and scores equal bit for bit."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk import (cosine_topk_int8_exact,
                                            cosine_topk_int8_ref, quantize_db_int8)

    gen = torch.Generator(device="cuda").manual_seed(3 * n + d)
    x = _unit_rows(gen, n, d)
    x[n // 2] = x[1]
    v8, scale = quantize_db_int8(x)
    qs = torch.cat([x[1:2], _unit_rows(gen, q - 1, d)])
    mask = None if keep is None else torch.rand(n, generator=gen, device="cuda") < keep
    n0 = kernels.launches["topk_int8"]
    s, i = cosine_topk_int8_exact(v8, scale, qs, k, n_valid=n_valid, row_mask=mask)
    assert kernels.launches["topk_int8"] == n0 + 1
    rs, ri = cosine_topk_int8_ref(v8, scale, qs, k, n_valid=n_valid, row_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(i, ri)
    assert torch.equal(s, rs)


@pytest.mark.parametrize("n,d,q,k,n_valid,keep", [
    (1000, 1024, 7, 30, None, None),
    (4099, 200, 70, 5, 3001, 0.5),    # d/8 = 25-byte planes
    (300, 96, 4, 40, 20, 0.3),        # k > n_valid
    (513, 128, 65, 10, None, 0.0),    # every row masked
    (5000, 768, 3, 128, None, 0.7),
    (20000, 1024, 1, 30, None, None),    # Q = 1
    (20000, 1024, 64, 30, None, 0.1),    # the capacity path's shape
    (3000, 200, 64, 10, None, 0.5),      # W = 25 at Q = 64
    (20000, 1024, 256, 30, 19000, None),
    (20000, 512, 300, 10, None, 0.5),    # Q above 256
    (20000, 1024, 256, 128, None, None), # k = 128 at Q = 256
])
def test_topk_binary_kernel(dev, n, d, q, k, n_valid, keep):
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.binary import binary_topk, binary_topk_ref, pack_signs

    gen = torch.Generator(device="cuda").manual_seed(5 * n + d)
    x = _unit_rows(gen, n, d)
    x[n // 2] = x[1]
    packed = pack_signs(x - x.mean(0))
    qs = torch.cat([x[1:2], _unit_rows(gen, q - 1, d)])
    mask = None if keep is None else torch.rand(n, generator=gen, device="cuda") < keep
    key = ("topk_binary", (q, n if n_valid is None else n_valid, d, k, mask is not None))
    n0, s0 = kernels.launches["topk_binary"], kernels.shape_launches[key]
    s, i = binary_topk(packed, qs, k, d, n_valid=n_valid, row_mask=mask)
    assert kernels.launches["topk_binary"] == n0 + 1
    assert kernels.shape_launches[key] == s0 + 1
    rs, ri = binary_topk_ref(packed, qs, k, d, n_valid=n_valid, row_mask=mask)
    torch.cuda.synchronize()
    # sums of exact +-bf16(q_i) products in another order
    _assert_topk_close(s, i, rs, ri, 1e-4)
    if keep == 0.0:
        assert bool((i == -1).all())


@pytest.mark.parametrize("mode", ["bf16", "masked", "binary", "int8", "int8_rows", "f32",
                                  "f32_masked"])
def test_topk_tie_across_tiles_and_splits(dev, mode):
    """Copies of row 1 on both sides of a warpgroup's m64 tiles (127/128)
    and of row tiles that are also row-split boundaries: 4096 rows at
    Q = 3 are 16 tiles of 256, fewer than the SMs, so the launch gives each
    tile its own split. The wgmma scan returns the tied rows in ascending
    order (int8: K9's n16 and K12's n8 products, bit-equal scores; fp32:
    equal rows split into equal parts, equal scores)."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops import topk
    from reverso_tpu_torch.ops.binary import binary_topk, pack_signs
    from reverso_tpu_torch.ops.topk_int8 import quantize_queries, quantize_rows, topk_int8_rows

    n, d, q, k = 4096, 128, 3, 7
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wg = {"binary": topk.WG_BINARY, "int8": topk.WG_INT8, "int8_rows": topk.WG_INT8_ROWS,
          "f32": topk.WG_F32, "f32_masked": topk.WG_F32}.get(mode, topk.WG_BF16)
    rows = topk.WG_ROWS * topk.wg_m_tiles(topk.wg_width(topk.wg_plan(q, k, wg)[0], wg))
    assert rows == 256 and topk.split_count(sms, 1, n, rows) == n // rows <= sms
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = _unit_rows(gen, n, d)
    copies = [127, 128, 255, 256, 511, 512]
    x[copies] = x[1].clone()
    qs = torch.cat([x[1:2], _unit_rows(gen, q - 1, d)])
    counter = {"bf16": "topk_stream", "masked": "topk_masked", "binary": "topk_binary",
               "int8": "topk_int8", "int8_rows": "topk_int8_rows", "f32": "topk_stream",
               "f32_masked": "topk_masked"}[mode]
    n0 = kernels.launches[counter]
    if mode == "binary":
        s, i = binary_topk(pack_signs(x - x.mean(0)), qs, k, d)
    elif mode == "int8":
        s, i = topk.cosine_topk_int8_exact(*topk.quantize_db_int8(x), qs, k)
    elif mode == "int8_rows":
        s, i = topk_int8_rows(*quantize_rows(x), *quantize_queries(qs), k)
    else:
        mask = (torch.ones(n, dtype=torch.bool, device="cuda") if mode.endswith("masked")
                else None)
        dtype = torch.float32 if mode.startswith("f32") else torch.bfloat16
        s, i = topk.cosine_topk(x.to(dtype), qs.to(dtype), k, row_mask=mask)
    assert kernels.launches[counter] == n0 + 1
    assert i[0].tolist() == sorted([1] + copies)
    assert len(set(s[0].tolist())) == 1


@pytest.mark.parametrize("mode", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("q,nprobe,k,masked,d", [
    (1, 4, 10, False, 200),
    (5, 16, 20, True, 200),
    (3, 16, 128, False, 200),    # k at the cap
    (2, 24, 10, True, 200),      # nprobe = every cluster
    (150, 24, 10, False, 200),   # every cluster probed by more queries than the N cap
    (1, 24, 10, True, 1024),     # d = 1024: int8 rows through TMA too
    (150, 3, 16, True, 1024),
])
def test_ivf_scan_kernel(dev, mode, q, nprobe, k, masked, d):
    """K11 against the probe loop: ragged clusters (sizes 0, 1, 37, 700,
    ...), the last cluster ending at the matrix's end (TMA reads zeros
    past it), probes of empty clusters, d = 200 (int8 rows of 200 bytes
    take the producer's copy, bf16 and fp32 TMA) and 1024. Query 0 probes
    the 700-row cluster first, whose rows 200 and 300 are copies of the
    query: at Q = 1 a split is one 256-row tile, so the tie straddles a
    split's boundary, and both rows come back in row order."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.ivf_scan import ivf_probe_scan, ivf_probe_scan_ref
    from reverso_tpu_torch.ops.topk import int8_query_digits, quantize_db_int8

    gen = torch.Generator(device="cuda").manual_seed(q * nprobe + k + d)
    n_cl = 24
    counts = torch.randint(0, 300, (n_cl,), generator=gen, device="cuda")
    counts[:4] = torch.tensor([0, 1, 37, 700], device="cuda")
    counts[-1] = 120                              # the last cluster ends at the matrix's end
    offsets = torch.cumsum(counts, 0) - counts
    m = int(counts.sum())
    x = _unit_rows(gen, m, d)
    x[5] = x[4]                                   # a tie inside one cluster
    qs = _unit_rows(gen, q, d)
    tie = int(offsets[3]) + 200
    qs[0] = x[tie]
    x[tie + 100] = x[tie]                         # its copy, across a split's boundary
    forced = [3, n_cl - 1, 0]                     # the big, the last and an empty cluster
    probes = torch.stack([torch.randperm(n_cl, generator=gen, device="cuda")[:nprobe]
                          for _ in range(q)])
    rest = [c for c in probes[0].tolist() + list(range(n_cl)) if c not in forced]
    probes[0] = torch.tensor((forced + list(dict.fromkeys(rest)))[:nprobe], device="cuda")
    base, cnt = offsets[probes].int(), counts[probes].int()
    mask = (torch.rand(m, generator=gen, device="cuda") < 0.6) if masked else None
    if masked:
        mask[[tie, tie + 100]] = True
    kw = dict(k=k, cmax=int(counts.max()), mask_sorted=mask)
    if mode == "int8":
        mat, scale = quantize_db_int8(x)
        q_hi, q_lo, c2 = int8_query_digits(qs)
        args = (mat, qs, torch.stack([q_hi, q_lo]), c2 * scale, base, cnt)
    else:
        dtype = getattr(torch, mode)
        args = (x.to(dtype), qs.to(dtype), None, None, base, cnt)
    key = ("ivf_scan", (q, nprobe, d, k, masked, mode))
    n0, s0 = kernels.launches["ivf_scan"], kernels.shape_launches[key]
    s, pos = ivf_probe_scan(*args, int8=mode == "int8", **kw)
    assert kernels.launches["ivf_scan"] == n0 + 1
    assert kernels.shape_launches[key] == s0 + 1
    rs, rpos = ivf_probe_scan_ref(*args, int8=mode == "int8", **kw)
    torch.cuda.synchronize()
    if mode == "int8":      # exact s32 dots and the same two roundings
        assert torch.equal(pos, rpos) and torch.equal(s, rs)
    else:
        _assert_topk_close(s, pos, rs, rpos, 1e-4)
    assert pos[0, :2].tolist() == [tie, tie + 100] and float(s[0, 0]) == float(s[0, 1])


@pytest.mark.parametrize("q,nprobe,n_cl,wg", [
    (1, 16, 24, 0),        # Q = 1: one-tile splits
    (5, 24, 24, 2),        # every cluster, int8 blocks
    (150, 8, 24, 0),       # clusters probed by more pairs than a block
    (64, 1024, 1024, 0),   # the exactness check's shape: P = 65,536
    (3, 4, 4, 4),          # the same cluster twice in one query's probes
])
def test_ivf_plan_kernel(dev, q, nprobe, n_cl, wg):
    """K11's plan kernel against the plan's contract (`check_plan`):
    ragged clusters (empty, one row, 700 rows), the work table, the
    places and the queries' rows, in the geometry the wrapper gives."""
    from reverso_tpu_torch.ops.ivf_scan import check_plan, ivf_geometry, ivf_plan_cuda

    gen = torch.Generator(device="cuda").manual_seed(q + nprobe + n_cl)
    counts = torch.randint(0, 1200, (n_cl,), generator=gen, device="cuda")
    counts[:3] = torch.tensor([0, 1, 700], device="cuda")[:n_cl]
    offsets = torch.cumsum(counts, 0) - counts
    probes = torch.stack([torch.randperm(n_cl, generator=gen, device="cuda")[:nprobe]
                          for _ in range(q)])
    if nprobe == n_cl == 4:
        probes[:, 1] = probes[:, 0]
    base, cnt = offsets[probes].int(), counts[probes].int()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_block, rps, splits = ivf_geometry(q, nprobe, 10, int(counts.max()), int(counts.sum()),
                                        wg=wg, sms=sms)
    plan = ivf_plan_cuda(base, cnt, n_block=n_block, rps=rps, splits=splits)
    torch.cuda.synchronize()
    check_plan(base, cnt, *plan, n_block=n_block, rps=rps)


def test_ivf_index_takes_a_card_mask(dev):
    """`IVFIndex.search` on the card takes its row mask as a host array or
    a tensor on the card alike: the mask over the sorted rows is built on
    the card, with no copy to the host."""
    from reverso_tpu_torch.store.ivf import IVFIndex

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ix = IVFIndex(x, n_clusters=16, dtype="bfloat16", spill=0.2)
    mask = rng.random(3000) < 0.4
    want = ix.search(x[:5], 10, nprobe=8, row_mask=mask)
    for m in (torch.from_numpy(mask).cuda(), torch.from_numpy(mask[:2000]).cuda()):
        got = ix.search(x[:5], 10, nprobe=8, row_mask=m)
        if len(m) == 3000:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ids = got[1].cpu().numpy()
        assert mask[ids[ids >= 0]].all() and (ids < len(m)).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,w,hid,act", [
    (50, 64, 256, "gelu"),            # test-tiny: one partial 512-wide chunk
    (33, 160, 640, "quick_gelu"),     # a second, partial chunk
    (77, 72, 200, "gelu"),            # W not a multiple of 16, H of 8
    (577, 1024, 4096, "gelu"),        # PE-L14 widths
    (40, 1536, 8960, "gelu"),         # PE-G14 widths: a partial last chunk
    (4653, 1024, 4096, "gelu"),       # T % 64 != 0, more than one wave of CTAs
    (29, 68, 100, "quick_gelu"),      # W % 8 != 0: element-wise output stores
])
def test_fused_mlp_int8_kernel(dev, dtype, t, w, hid, act):
    """K5 against its plain version: the same int8 contract rounding for
    rounding, so equal bit for bit wherever the plain version's gelu
    (torch's exp on the card) is the kernel's; the bound allows a rare
    hidden-quantum flip: under 0.2% of elements beyond 1e-5 and none
    beyond two hidden quanta at the output."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.fused_mlp import (fused_mlp_int8, mlp_int8_ref,
                                                 quantize_mlp_weights)
    from reverso_tpu_torch.ops.quant import int_dot, quantize_rows_int8

    gen = torch.Generator(device="cuda").manual_seed(t + w)
    x = _randn(gen, t, w, dtype=dtype)
    w1, b1 = _randn(gen, hid, w, dtype=dtype, scale=w ** -0.5), _randn(gen, hid, dtype=dtype, scale=0.1)
    w2, b2 = _randn(gen, w, hid, dtype=dtype, scale=hid ** -0.5), _randn(gen, w, dtype=dtype, scale=0.1)
    qw = quantize_mlp_weights(w1, b1, w2, b2, dtype)
    n0 = kernels.launches["fused_mlp_int8"]
    out = fused_mlp_int8(x, qw, act=act)
    assert kernels.launches["fused_mlp_int8"] == n0 + 1
    ref = mlp_int8_ref(x, w1, b1, w2, b2, act=act)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    ulp = 1e-5 if dtype == torch.float32 else 2 ** -7     # one output rounding
    loose = diff > ulp * (1 + ref.float().abs())
    assert float(loose.float().mean()) < 0.002
    if loose.any():   # a flip moves an output by at most 2 hidden quanta x max |W2|
        x8, xs = quantize_rows_int8(x)
        h_amax = max(float((int_dot(x8, qw.w1[lo:lo + 512]).float() * (xs * qw.s1[lo:lo + 512])
                            + qw.b1[lo:lo + 512]).abs().max()) * 1.2
                     for lo in range(0, hid, 512))
        quantum = 2 * h_amax / 127 * float((qw.w2.float().abs() * qw.s2[:, None]).max())
        assert float(diff[loose].max()) <= quantum + ulp * (1 + float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_int8_scratch_per_call(dev, dtype):
    """K5's launcher works through int8 scratch the wrapper makes for each
    call's shape: two calls of different shapes (PE-L14's MLP on 1000 rows,
    a narrow one on 37 rows), on two streams at once, each equal to its
    plain version; one launch counted per call, under each call's shape."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.fused_mlp import (fused_mlp_int8, mlp_int8_plain,
                                                 quantize_mlp_weights)

    gen = torch.Generator(device="cuda").manual_seed(7)
    calls = []
    for t, w, hid in ((1000, 1024, 4096), (37, 72, 200)):
        qw = quantize_mlp_weights(_randn(gen, hid, w, dtype=dtype, scale=w ** -0.5),
                                  _randn(gen, hid, dtype=dtype, scale=0.1),
                                  _randn(gen, w, hid, dtype=dtype, scale=hid ** -0.5),
                                  _randn(gen, w, dtype=dtype, scale=0.1), dtype)
        calls.append((_randn(gen, t, w, dtype=dtype), qw))
    torch.cuda.synchronize()
    n0, shapes0 = kernels.launches["fused_mlp_int8"], dict(kernels.shape_launches)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for (x, qw), st in zip(calls, streams):
        with torch.cuda.stream(st):
            outs.append(fused_mlp_int8(x, qw))
    torch.cuda.synchronize()
    assert kernels.launches["fused_mlp_int8"] == n0 + 2
    for x, qw in calls:
        key = ("fused_mlp_int8", (x.shape[0], x.shape[1], qw.w1.shape[0], str(dtype)))
        assert kernels.shape_launches[key] == shapes0.get(key, 0) + 1
    for out, (x, qw) in zip(outs, calls):
        ref = mlp_int8_plain(x, qw, "gelu")
        diff = (out.float() - ref.float()).abs()
        ulp = 1e-5 if dtype == torch.float32 else 2 ** -7     # one output rounding
        assert float((diff > ulp * (1 + ref.float().abs())).float().mean()) < 0.002


def _clustered_locations(gen, b, shapes, lq, h, p, spread):
    """Sampling locations around each query's reference point, as the
    encoder's: query i is position i of the flattened levels (wrapping past
    them), and every level samples near that position's cell centre."""
    pts = []
    for hl, wl in shapes:
        yy, xx = torch.meshgrid(torch.arange(hl, device="cuda"), torch.arange(wl, device="cuda"),
                                indexing="ij")
        pts.append(torch.stack([(xx.flatten() + 0.5) / wl, (yy.flatten() + 0.5) / hl], -1))
    pts = torch.cat(pts)
    ref = pts[torch.arange(lq, device="cuda") % len(pts)]
    noise = torch.randn(b, lq, h, len(shapes), p, 2, generator=gen, device="cuda") * spread
    return ref[None, :, None, None, None, :] + noise


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,shapes,lq,h,d,p", [
    (4, ((100, 100), (50, 50), (25, 25), (13, 13)), 13294, 8, 32, 4),   # the encoder
    (2, ((9, 13), (5, 7), (3, 4), (2, 2)), 187, 3, 7, 4),    # odd D; 187 % 32 != 0
    (1, ((100, 100), (50, 50), (25, 25), (13, 13)), 900, 8, 5, 3),     # odd D, 3 points
    (2, ((30, 20), (15, 10)), 65, 2, 24, 2),                # D = 24: 6 vectors a row
])
def test_ms_deform_kernel_clustered(dev, dtype, b, shapes, lq, h, d, p):
    """K8 on locations clustered around the queries' reference points (the
    model's pattern, whose corner rows repeat across neighbouring queries),
    at odd head dims and query counts that are not a multiple of a CTA's
    32, against its plain version under the same tolerances."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_ref

    gen = torch.Generator(device="cuda").manual_seed(lq + d)
    lv = sum(hl * wl for hl, wl in shapes)
    value = _randn(gen, b, lv, h, d, dtype=dtype)
    loc = _clustered_locations(gen, b, shapes, lq, h, p, spread=0.02)
    w = torch.rand(b, lq, h, len(shapes), p, generator=gen, device="cuda")
    w = w / w.sum(dim=(-2, -1), keepdim=True)
    n0 = kernels.launches["ms_deform"]
    out = ms_deform_attn(value, shapes, loc, w)
    assert kernels.launches["ms_deform"] == n0 + 1
    ref = ms_deform_attn_ref(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert out.shape == (b, lq, h * d) and out.dtype == dtype
    # fp32: sums in another order; bf16: one output ulp (both sum in fp32)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("n,d,q,k,n_valid", [
    (1000, 64, 7, 40, None),
    (4099, 200, 70, 20, 3001),        # n_valid < N; d % 16 != 0: the producer copies rows
    (300, 96, 4, 128, 20),            # k at the cap, k > n_valid
    (1500, 77, 66, 16, 1400),         # d not a multiple of 16: the producer copies rows
    (2000, 1040, 9, 10, None),
    (20000, 1024, 1, 40, None),       # Q = 1: an n8 product
    (20000, 256, 300, 40, 19000),     # Q = 300: five blocks of 60
    (20000, 1024, 256, 128, None),    # k = 128 at Q = 256
])
def test_topk_int8_rows_kernel(dev, n, d, q, k, n_valid):
    """K12's stage 1 against its plain version: exact s32 dots and the
    same two roundings, so ids and scores equal bit for bit; a duplicate
    row ties to the lower id."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk_int8 import (quantize_queries, quantize_rows,
                                                 topk_int8_rows, topk_int8_rows_ref)

    gen = torch.Generator(device="cuda").manual_seed(7 * n + d)
    x = _unit_rows(gen, n, d) * (torch.rand(n, 1, generator=gen, device="cuda") + 0.5)
    x[n // 2] = x[1]
    v8, sc = quantize_rows(x)
    q8, qs = quantize_queries(torch.cat([x[1:2], _unit_rows(gen, q - 1, d)]))
    key = ("topk_int8_rows", (q, n if n_valid is None else n_valid, d, k, False))
    n0, s0 = kernels.launches["topk_int8_rows"], kernels.shape_launches[key]
    s, i = topk_int8_rows(v8, sc, q8, qs, k, n_valid=n_valid)
    assert kernels.launches["topk_int8_rows"] == n0 + 1
    assert kernels.shape_launches[key] == s0 + 1
    rs, ri = topk_int8_rows_ref(v8, sc, q8, qs, k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert torch.equal(i, ri) and torch.equal(s, rs)
    if n_valid is None or n_valid > n // 2:
        assert i[0, :2].tolist() == [1, n // 2]


@pytest.mark.parametrize("d", [77, 128, 1024])
def test_topk_int8_unaligned_rows(dev, d):
    """K9 and K12 over int8 rows whose base is not 16-byte aligned (a view
    one byte into its buffer: the producer warp copies the rows into the
    ring in TMA's swizzle), bit for bit with their plain versions."""
    from reverso_tpu_torch.ops.topk import (cosine_topk_int8_exact, cosine_topk_int8_ref,
                                            quantize_db_int8)
    from reverso_tpu_torch.ops.topk_int8 import (quantize_queries, quantize_rows,
                                                 topk_int8_rows, topk_int8_rows_ref)

    n, q = 3001, 70
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = _unit_rows(gen, n, d)
    x[n // 2] = x[1]
    qs = torch.cat([x[1:2], _unit_rows(gen, q - 1, d)])

    def shifted(v8):   # the same rows, one byte into a buffer
        buf = torch.empty(n * d + 1, dtype=torch.int8, device="cuda")
        buf[1:] = v8.flatten()
        out = buf[1:].view(n, d)
        assert out.data_ptr() % 16 != 0
        return out

    v8, scale = quantize_db_int8(x)
    s, i = cosine_topk_int8_exact(shifted(v8), scale, qs, 10)
    rs, ri = cosine_topk_int8_ref(v8, scale, qs, 10)
    r8, rsc = quantize_rows(x)
    q8, qsc = quantize_queries(qs)
    s2, i2 = topk_int8_rows(shifted(r8), rsc, q8, qsc, 40)
    r2s, r2i = topk_int8_rows_ref(r8, rsc, q8, qsc, 40)
    torch.cuda.synchronize()
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert torch.equal(i2, r2i) and torch.equal(s2, r2s)
    assert i[0, :2].tolist() == [1, n // 2] and i2[0, :2].tolist() == [1, n // 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,q,k,keep", [(1024, 64, 10, None), (1020, 1, 128, 0.5),
                                        (100, 256, 1, None)])
def test_topk_unaligned_rows(dev, dtype, d, q, k, keep):
    """K1 and K2 over fp32 and bf16 rows whose base is one element into
    its buffer (not 16-byte aligned: the producer warp copies the rows into
    the ring in TMA's swizzle), against the plain version under the
    tie-margin rule."""
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref

    n = 3001
    gen = torch.Generator(device="cuda").manual_seed(d + q)
    x = _unit_rows(gen, n, d).to(dtype)
    x[n // 2] = x[1]
    buf = torch.empty(n * d + 1, dtype=dtype, device="cuda")
    buf[1:] = x.flatten()
    rows = buf[1:].view(n, d)
    assert rows.data_ptr() % 16 != 0
    qs = torch.cat([x[1:2], _unit_rows(gen, q - 1, d).to(dtype)])
    mask = None if keep is None else torch.rand(n, generator=gen, device="cuda") < keep
    if mask is not None:
        mask[1] = mask[n // 2] = True
    s, i = cosine_topk(rows, qs, k, n_valid=n - 1, row_mask=mask)
    rs, ri = cosine_topk_ref(x, qs, k, n_valid=n - 1, row_mask=mask)
    torch.cuda.synchronize()
    _assert_topk_close(s, i, rs, ri, 1e-4)
    if k >= 2:
        assert i[0, :2].tolist() == [1, n // 2]


def test_cosine_topk_int8_on_the_card(dev):
    """The two-stage search on the card equals the same search on the CPU
    (stage 1 bit for bit; the rescore sums in another order)."""
    from reverso_tpu_torch.ops.topk_int8 import cosine_topk_int8, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(11)
    db = _unit_rows(gen, 5000, 256)
    qs = db[:9] + 0.02 * _unit_rows(gen, 9, 256)
    v8, sc = quantize_rows(db)
    s, i = cosine_topk_int8(v8, sc, db.to(torch.bfloat16), qs, 10, n_valid=4800)
    cs, ci = cosine_topk_int8(v8.cpu(), sc.cpu(), db.to(torch.bfloat16).cpu(), qs.cpu(), 10,
                              n_valid=4800)
    _assert_topk_close(s.cpu(), i.cpu(), cs, ci, 1e-5)
    assert i[:, 0].tolist() == list(range(9))


def _assert_topk_scaled(s, i, rs, ri, tol):
    """`_assert_topk_close` with a tolerance per result slot ([Q, k]):
    scores whose magnitude grows with the rows' norms (the euclid ranking
    key). Ids must agree where the gap to each neighbour passes the larger
    of the two slots' tolerances."""
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(s))
    assert torch.equal(i[~fin], torch.full_like(i[~fin], -1))
    assert bool(((torch.where(fin, s - rs, 0)).abs() <= tol).all())
    gap = torch.diff(torch.where(fin, rs, -1e30), dim=1).abs()
    pair = torch.maximum(tol[:, 1:], tol[:, :-1])
    inf = torch.full((rs.shape[0], 1), float("inf"), device=rs.device)
    clear = ((torch.cat([inf, gap - pair], 1) > 0) & (torch.cat([gap - pair, inf], 1) > 0))
    assert torch.equal(torch.where(clear, i, -2), torch.where(clear, ri, -2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,keep", [(64, None), (1, None), (16, 0.1)])
def test_euclid_d1025_kernel(dev, dtype, q, keep):
    """Euclid on K1/K2: the `[x, ||x||^2]` rows, norms from 0.1 to 100 (an
    unbounded ranking key `2<q, x> - ||x||^2`), at d = 1025 (a width TMA
    cannot take: the producer copies the rows) and as `DeviceIndex` holds
    them, zero-padded to a 16-byte row (1032 bf16, 1028 fp32). The
    kernel's keys at both widths against the plain scan of the same matrix
    on the card, and `DeviceIndex.search` on the card against the same
    index on the CPU (the card's keys against the CPU's plain keys, whose
    ids the CPU index returns). A key's tolerance is 2e-6 of the sum of its
    terms' magnitudes, 2 ||q|| ||x|| + ||x||^2, for the rows the two
    lists hold at that slot (the larger of the two); a distance's is the
    key's over the distance, and at most its square root (`-sqrt(max(
    ||q||^2 - key, 0))` clamps a key past ||q||^2, which the bf16 norm
    column makes common for a query's own row), plus 2e-6 of ||q||^2."""
    import torch.nn.functional as F

    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.topk import cosine_topk, cosine_topk_ref, launch_key
    from reverso_tpu_torch.store import DeviceIndex

    n, d = 20000, 1024
    gen = torch.Generator(device="cuda").manual_seed(q + 7)
    x = _unit_rows(gen, n, d) * torch.exp(
        torch.empty(n, 1, device="cuda").uniform_(np.log(0.1), np.log(100.0), generator=gen))
    x[n // 2] = x[1]                                  # a duplicate: tie -> lower row
    qs = x[torch.arange(q, device="cuda") * 97] + 0.01 * _unit_rows(gen, q, d)
    mask = None if keep is None else torch.rand(n, generator=gen, device="cuda") < keep
    host = x.cpu().numpy()
    gpu = DeviceIndex(host, dtype=dtype, distance="euclid")
    cpu = DeviceIndex(host, dtype=dtype, distance="euclid", device="cpu")
    pitch = 1032 if dtype == "bfloat16" else 1028
    assert tuple(gpu.matrix.shape) == (n, pitch) and gpu.dim == d + 1
    assert not gpu.matrix[:, d + 1:].any()
    counter = "topk_masked" if mask is not None else "topk_stream"
    key = launch_key(counter, gpu.matrix.dtype, (q, n, pitch, 10, mask is not None))
    before = kernels.shape_launches[key]
    s, i = gpu.search(qs, 10, row_mask=mask)
    assert kernels.shape_launches[key] == before + 1
    qa = torch.cat([2 * qs, -torch.ones_like(qs[:, :1])], 1)
    qp = F.pad(qa, (0, pitch - d - 1))
    qn2 = (qs * qs).sum(1, keepdim=True)
    xn2 = (gpu.matrix[:, :d].float() ** 2).sum(1)

    def tol(*ids):   # [Q, k]: the larger bound of the rows at each slot
        per = [2e-6 * (2 * qn2.sqrt() * xn2[j.long().clamp(min=0)].sqrt()
                       + xn2[j.long().clamp(min=0)]) for j in ids]
        return torch.stack(per).amax(0)

    keys = []
    for mat, qq in ((gpu.matrix, qp), (gpu.matrix[:, :d + 1].contiguous(), qa)):
        ks, ki = cosine_topk(mat, qq, 10, row_mask=mask)
        rs, ri = cosine_topk_ref(mat, qq, 10, row_mask=mask)
        torch.cuda.synchronize()
        _assert_topk_scaled(ks, ki, rs, ri, tol(ki, ri))
        keys.append((ks, ki))
    ks, ki = keys[0]
    assert torch.equal(ki, i)
    cmask = None if mask is None else mask.cpu()
    cs, ci = cpu.search(qs.cpu(), 10, row_mask=cmask)
    crs, cri = cosine_topk_ref(cpu.matrix, qp.cpu(), 10, row_mask=cmask)
    assert torch.equal(ci, cri)
    _assert_topk_scaled(ks.cpu(), ki.cpu(), crs, cri, tol(ki, cri.cuda()).cpu())
    fin = torch.isfinite(cs)
    t = tol(i, ci.cuda()).cpu() + 2e-6 * qn2.cpu()
    dist_tol = torch.minimum(t.sqrt(), t / cs.abs().clamp(min=1e-30))
    assert bool(((s.cpu() - cs)[fin].abs() <= dist_tol[fin]).all())
    if mask is None:
        assert bool((i[:, 0] == torch.arange(q, device="cuda") * 97).all() or q == 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_tower_card_vs_cpu(dev, dtype):
    """CLIP-L14-336 (`family="clip"`: quick_gelu, ln_pre, no patch bias, cls
    pooling, K3 without RoPE) at depth 2: the card against the CPU on the
    same seeded weights; fp32 within 1e-4 (the PE tower's gate), bf16 at a
    min cosine of 0.999."""
    import dataclasses

    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    cfg = dataclasses.replace(MODEL_PRESETS["CLIP-L14-336"], depth=2, dtype=dtype)
    imgs = np.random.default_rng(2).standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    gpu_enc = PerceptionEncoder(cfg, family="clip", seed=4)
    cpu_enc = PerceptionEncoder(cfg, family="clip", seed=4, device="cpu")
    kernels.reset_counts()
    gpu = gpu_enc.encode_image(imgs)
    split = dtype == "float32"
    assert kernels.launches["flash_heads_split" if split else "flash_heads_tc"] == 2
    assert kernels.launches["fused_mlp_split" if split else "fused_mlp_tc"] == 2
    cpu = cpu_enc.encode_image(imgs)
    assert np.isfinite(gpu).all() and gpu.shape == (2, cfg.embed_dim)
    if split:
        assert float(np.abs(gpu - cpu).max()) <= 1e-4
    else:
        assert float((gpu * cpu).sum(1).min()) >= 0.999


def test_pq_search_card_vs_cpu(dev):
    """PQ on the card against the CPU: training repeats itself bit for bit
    on the card, encoding with the same codebooks gives the same codes but
    for near-ties, and the proxy search agrees within 1e-5 (fp32 sums of
    bf16-exact products in another order) under the tie-margin rule."""
    from reverso_tpu_torch.ops.pq import pq_encode, train_pq
    from reverso_tpu_torch.store import PQIndex

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = _unit_rows(gen, 30000, 256).cpu().numpy()
    a = train_pq(x, 32, iters=4, sample=8192)
    b = train_pq(x, 32, iters=4, sample=8192)
    np.testing.assert_array_equal(a, b)
    cb = train_pq(x, 32, iters=4, sample=8192, device="cpu")
    codes = pq_encode(x, cb)
    assert (codes != pq_encode(x, cb, device="cpu")).mean() <= 1e-3
    gpu = PQIndex(x, m=32, codebooks=cb, codes=codes)
    cpu = PQIndex(x, m=32, codebooks=cb, codes=codes, device="cpu")
    qs = x[:16] + 0.05 * np.random.default_rng(0).standard_normal((16, 256)).astype(np.float32)
    mask = np.arange(30000) % 3 != 0
    for m in (None, mask):
        s, i = gpu.search(qs, 30, row_mask=m)
        cs, ci = cpu.search(qs, 30, row_mask=m)
        _assert_topk_close(s.cpu(), i.cpu(), cs, ci, 1e-5)


# backward kernels: outputs rounded once against the plain version's
# autograd, which rounds its intermediate gradients to the dtype as well
# (bf16: within 2% of the largest gradient); fp32 sums in another order
BWD_TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_grads_close(outs, refs, dtype):
    """Each gradient within BWD_TOLS[dtype] of max(1, its largest plain
    value), all finite."""
    for out, ref in zip(outs, refs):
        assert out.dtype == ref.dtype and torch.isfinite(out).all()
        scale = max(1.0, float(ref.float().abs().max()))
        assert float((out.float() - ref.float()).abs().max()) <= BWD_TOLS[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,kv_valid,rope", [
    (2, 17, 64, 4, None, True),       # test-tiny: hd 16, S = 17
    (3, 37, 64, 4, 23, True),
    (2, 145, 128, 4, None, False),    # hd 32, CLIP family
    (1, 1, 64, 1, None, True),        # S = 1, B * H = 1
    (2, 63, 128, 4, 1, True),         # one valid key
    (1, 64, 256, 2, 63, True),        # hd 128, one full key tile
    (1, 129, 512, 4, 65, True),       # hd 128, kv_valid one past a tile
    (2, 50, 384, 4, None, True),      # hd 96
    (2, 37, 80, 4, None, True),       # hd 20: partner columns across float4 chunks
    (1, 129, 160, 4, 100, True),      # hd 40
    (1, 577, 1024, 16, 300, True),    # PE-L14 widths, kv_valid < S
    (2, 577, 1536, 16, None, True),   # PE-G14's head dim 96 at S = 577
    (16, 577, 1024, 16, None, True),  # PE-L14's training shape
])
def test_flash_heads_bwd_kernel(dev, dtype, b, s, w, heads, kv_valid, rope):
    """K3's backward through `flash_attention_heads` under autograd, against
    `flash_attention_heads_grad_ref` (fp32 also against the split route's
    plain version); one backward launch, on the route `heads_bwd_route`
    names (the wgmma + TMA kernels: bf16 at head dims % 16 == 0 on the
    inputs, at other head dims on zero-padded copies; fp32 at every head
    dim on their split mode) and on no other route's counter, and the
    forward on the same kernel as without grad."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.attention import (flash_attention_heads,
                                                  flash_attention_heads_grad_ref,
                                                  flash_attention_heads_grad_split_ref,
                                                  heads_bwd_route)
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    gen = torch.Generator(device="cuda").manual_seed(s + w)
    q, k, v, do = (_randn(gen, b, s, w, dtype=dtype) for _ in range(4))
    cos = sin = None
    if rope:
        hd = w // heads
        g = max(1, int(np.sqrt(s - 1)))
        c, sn = rope_2d_tables(g, hd, cls_token=True)
        pad = s - c.shape[0]
        c = np.concatenate([c, np.ones((max(pad, 0), hd), np.float32)])[:s]
        sn = np.concatenate([sn, np.zeros((max(pad, 0), hd), np.float32)])[:s]
        cos, sin = torch.from_numpy(c).to(dev), torch.from_numpy(sn).to(dev)
    kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=kv_valid)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(kernels.launches)
    out = flash_attention_heads(*leaves, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert kernels.launches["flash_heads"] - before["flash_heads"] == 1
    assert kernels.launches["flash_heads_bwd"] - before["flash_heads_bwd"] == 1
    route = heads_bwd_route("cuda", dtype, w // heads)
    assert route == ("split" if dtype == torch.float32 else
                     "tensor_core" if (w // heads) % 16 == 0 else "tensor_core_padded")
    counter = "flash_heads_bwd_split" if route == "split" else "flash_heads_bwd_tc"
    other = "flash_heads_bwd_tc" if route == "split" else "flash_heads_bwd_split"
    assert kernels.launches[counter] - before[counter] == 1
    assert kernels.launches[other] - before[other] == 0
    _assert_close(out.detach(), flash_attention_heads(q, k, v, **kw), 0.0)
    refs = flash_attention_heads_grad_ref(q, k, v, do, **kw)
    _assert_grads_close([t.grad for t in leaves], refs, dtype)
    if route == "split":
        split = flash_attention_heads_grad_split_ref(q, k, v, do, **kw)
        _assert_grads_close([t.grad for t in leaves], split, dtype)
    if kv_valid is not None:   # keys past kv_valid get no gradient
        assert not leaves[1].grad[:, kv_valid:].any() and not leaves[2].grad[:, kv_valid:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,w,hid,act", [
    (50, 64, 256, "gelu"),            # test-tiny
    (33, 64, 256, "quick_gelu"),
    (1, 64, 256, "gelu"),
    (130, 72, 200, "gelu"),           # W, H % 8 == 0 but not whole tiles (K tail of 8)
    (40, 68, 252, "quick_gelu"),      # W % 8 != 0: bf16 through zero-padded copies
    (577, 1024, 4096, "gelu"),        # PE-L14 widths
    (1000, 1024, 4096, "quick_gelu"),  # T % 128 != 0
    (9232, 1024, 4096, "gelu"),       # PE-L14's training shape: 72 tiles of 128 and 16 rows
])
def test_fused_mlp_bwd_kernel(dev, dtype, t, w, hid, act):
    """K4's backward (the kernel `mlp_bwd_route` names, then the three
    products and db2's sum) through `fused_mlp` under autograd, against
    `mlp_grad_ref` (fp32 also against `mlp_grad_split_ref`); one backward
    launch on that route and none on the other. db1 from the kernel's
    per-tile partials equals the column sum of its own dz (fp32, another
    order)."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.fused_mlp import (_mlp_bwd_launch, fused_mlp, mlp_bwd_route,
                                                 mlp_grad_ref, mlp_grad_split_ref)

    gen = torch.Generator(device="cuda").manual_seed(t + w)
    x, dy = _randn(gen, t, w, dtype=dtype), _randn(gen, t, w, dtype=dtype)
    w1, b1 = _randn(gen, hid, w, dtype=dtype, scale=w ** -0.5), _randn(gen, hid, dtype=dtype, scale=0.1)
    w2, b2 = _randn(gen, w, hid, dtype=dtype, scale=hid ** -0.5), _randn(gen, w, dtype=dtype, scale=0.1)
    leaves = [p.clone().requires_grad_(True) for p in (x, w1, b1, w2, b2)]
    before = dict(kernels.launches)
    fused_mlp(*leaves, act=act).backward(dy)
    torch.cuda.synchronize()
    assert kernels.launches["fused_mlp"] - before["fused_mlp"] == 1
    assert kernels.launches["fused_mlp_bwd"] - before["fused_mlp_bwd"] == 1
    route = mlp_bwd_route("cuda", dtype, w, hid)
    assert route == ("split" if dtype == torch.float32 else
                     "tensor_core" if w % 8 == 0 and hid % 8 == 0 else "tensor_core_padded")
    counter = "fused_mlp_bwd_split" if route == "split" else "fused_mlp_bwd_tc"
    other = "fused_mlp_bwd_tc" if route == "split" else "fused_mlp_bwd_split"
    assert kernels.launches[counter] - before[counter] == 1
    assert kernels.launches[other] - before[other] == 0
    refs = mlp_grad_ref(x, w1, b1, w2, b2, dy, act=act)
    _assert_grads_close([p.grad for p in leaves], refs, dtype)
    if route == "split":
        split = mlp_grad_split_ref(x, w1, b1, w2, b2, dy, act=act)
        _assert_grads_close([p.grad for p in leaves], split, dtype)
    _, dz, db1 = _mlp_bwd_launch(x, w1, b1, w2, dy, act)
    want = dz.float().sum(0)
    assert db1.dtype == torch.float32 and db1.shape == (hid,)
    assert float((db1 - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("b,s,w,heads,kv_valid,rope", [
    (2, 17, 64, 4, None, True),        # test-tiny: hd 16
    (16, 577, 1024, 16, None, True),   # PE-L14's training shape
    (2, 577, 1024, 16, 300, True),     # kv_valid < S
    (2, 145, 1024, 16, None, False),   # CLIP family: the scale on the scores
    (2, 577, 1536, 16, None, True),    # PE-G14: hd 96
])
def test_flash_heads_forward_lse(dev, b, s, w, heads, kv_valid, rope):
    """K3's bf16 forward with its `lse` output: each row's log-sum-exp
    (base 2) against a plain log-sum-exp of the scores from the same
    rounded operands, within 1e-5 of max(1, |lse|); the output bit for bit
    as without the pointer."""
    from reverso_tpu_torch.ops.attention import _heads_launch, _split
    from reverso_tpu_torch.ops.rope import rope_2d_tables, rotate

    gen = torch.Generator(device="cuda").manual_seed(s + w)
    q, k, v = (_randn(gen, b, s, w, dtype=torch.bfloat16) for _ in range(3))
    hd = w // heads
    scale = hd ** -0.5
    kv = s if kv_valid is None else kv_valid
    tables = ()
    if rope:
        g = max(1, int(np.sqrt(s - 1)))
        c, sn = rope_2d_tables(g, hd, cls_token=True)
        pad = max(s - c.shape[0], 0)
        c = np.concatenate([c, np.ones((pad, hd), np.float32)])[:s]
        sn = np.concatenate([sn, np.zeros((pad, hd), np.float32)])[:s]
        tables = (torch.from_numpy(c).to(dev), torch.from_numpy(sn).to(dev))
    lse = torch.empty((b * heads, s), dtype=torch.float32, device=dev)
    out = _heads_launch(q, k, v, heads, tables, scale, kv, lse)
    assert torch.equal(out, _heads_launch(q, k, v, heads, tables, scale, kv))
    qh, kh = _split(q, heads), _split(k, heads)
    if rope:
        qh, kh = rotate(qh, *tables, scale), rotate(kh, *tables)
        sc = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    else:
        sc = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    want = torch.logsumexp(sc[..., :kv], dim=-1).reshape(b * heads, s) / float(np.log(2.0))
    err = (lse - want).abs() / want.abs().clamp(min=1.0)
    print(f"lse: max error {float(err.max()):.3e} of max(1, |lse|) (tolerance 1e-5)")
    assert float(err.max()) <= 1e-5


@pytest.mark.parametrize("b,s,w,heads,kv_valid,rope", [
    (2, 17, 64, 4, None, True),        # test-tiny: hd 16
    (2, 577, 1024, 16, 300, True),     # PE-L14 widths, kv_valid < S
    (2, 145, 1024, 16, None, False),   # CLIP family: the scale folded into q
    (2, 577, 1152, 16, None, True),    # hd 72: padded to 80
])
def test_flash_heads_split_forward_lse(dev, b, s, w, heads, kv_valid, rope):
    """K3's fp32 forward (the split mode) with its `lse` output: each row's
    log-sum-exp (base 2) against the split plain version's
    (`flash_attention_heads_split_ref(return_lse=True)`), within 1e-5 of
    max(1, |lse|); the output bit for bit as without the pointer."""
    from reverso_tpu_torch.ops.attention import _heads_launch, flash_attention_heads_split_ref
    from reverso_tpu_torch.ops.rope import rope_2d_tables

    gen = torch.Generator(device="cuda").manual_seed(s + w)
    q, k, v = (_randn(gen, b, s, w, dtype=torch.float32) for _ in range(3))
    hd = w // heads
    kv = s if kv_valid is None else kv_valid
    tables = ()
    if rope:
        g = max(1, int(np.sqrt(s - 1)))
        c, sn = rope_2d_tables(g, hd, cls_token=True)
        pad = max(s - c.shape[0], 0)
        c = np.concatenate([c, np.ones((pad, hd), np.float32)])[:s]
        sn = np.concatenate([sn, np.zeros((pad, hd), np.float32)])[:s]
        tables = (torch.from_numpy(c).to(dev), torch.from_numpy(sn).to(dev))
    lse = torch.empty((b * heads, s), dtype=torch.float32, device=dev)
    out = _heads_launch(q, k, v, heads, tables, hd ** -0.5, kv, lse)
    assert torch.equal(out, _heads_launch(q, k, v, heads, tables, hd ** -0.5, kv))
    cos, sin = tables if rope else (None, None)
    _, want = flash_attention_heads_split_ref(q, k, v, heads=heads, cos=cos, sin=sin,
                                              kv_valid=kv_valid, return_lse=True)
    err = (lse - want).abs() / want.abs().clamp(min=1.0)
    print(f"split lse: max error {float(err.max()):.3e} of max(1, |lse|) (tolerance 1e-5)")
    assert float(err.max()) <= 1e-5


def test_grad_raises_on_kernels_without_backward(dev):
    """K5, K6 and K7 under autograd on the card raise and name ROADMAP item
    20c; under `torch.inference_mode()` the same calls launch."""
    from reverso_tpu_torch.ops import flash_attention, fused_mlp

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = _randn(gen, 1, 2, 33, 64, dtype=torch.bfloat16).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 20c"):
        flash_attention(q, q, q)
    x = _randn(gen, 9, 64, dtype=torch.float32).requires_grad_(True)
    w1, w2 = _randn(gen, 256, 64, dtype=torch.float32), _randn(gen, 64, 256, dtype=torch.float32)
    b1, b2 = torch.zeros(256, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(NotImplementedError, match="item 20c"):
        fused_mlp(x, w1, b1, w2, b2, quant=True)
    with torch.inference_mode():
        assert flash_attention(q, q, q).shape == q.shape
        assert fused_mlp(x, w1, b1, w2, b2, quant=True).shape == x.shape


def _sharded_vs_single(devices):
    """Every sharded scan over a mesh of `devices` against the single-device
    scan on cuda:0: K1 (bf16, fp32), K2, K9, K10 and K11 (bf16, int8) on
    each shard with its own valid rows, ids and scores bit for bit; the
    kernels' launches counted once per shard that holds rows."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MeshConfig
    from reverso_tpu_torch.ops.binary import binary_topk, pack_signs, sharded_binary_topk
    from reverso_tpu_torch.ops.topk import (cosine_topk, cosine_topk_int8_exact,
                                            quantize_db_int8, sharded_cosine_topk)
    from reverso_tpu_torch.parallel import make_mesh
    from reverso_tpu_torch.store import IVFIndex

    mesh = make_mesh(MeshConfig(), devices=devices)
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, d = 20_003, 200
    x = torch.randn(n, d, generator=gen, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    q = x[:37] + 0.02 * torch.randn(37, d, generator=gen, device="cuda")
    mask = torch.rand(n, generator=gen, device="cuda") < 0.3
    shards = len(devices)
    for db, kw in ((x.to(torch.bfloat16), {}), (x, {}), (x.to(torch.bfloat16), dict(row_mask=mask))):
        kernels.reset_counts()
        s2, i2 = sharded_cosine_topk(db, q, 10, mesh, **kw)
        counter = "topk_masked" if kw else "topk_stream"
        assert kernels.launches[counter] == shards
        s1, i1 = cosine_topk(db, q, 10, **kw)
        assert torch.equal(i1, i2.to(i1.device)) and torch.equal(s1, s2.to(s1.device))
    v8, scale = quantize_db_int8(x)
    kernels.reset_counts()
    s2, i2 = sharded_cosine_topk(v8, q, 10, mesh, db_scale=scale)
    assert kernels.launches["topk_int8"] == shards
    s1, i1 = cosine_topk_int8_exact(v8, scale, q, 10)
    assert torch.equal(i1, i2.to(i1.device)) and torch.equal(s1, s2.to(s1.device))
    packed = pack_signs(x)
    kernels.reset_counts()
    s2, i2 = sharded_binary_topk(packed, q, 10, d, mesh)
    assert kernels.launches["topk_binary"] == shards
    s1, i1 = binary_topk(packed, q, 10, d)
    assert torch.equal(i1, i2.to(i1.device)) and torch.equal(s1, s2.to(s1.device))
    rows = x.cpu().numpy()
    for dtype, spill in (("bfloat16", 0.0), ("int8", 0.1)):
        kw = dict(n_clusters=64, dtype=dtype, seed=0, spill=spill)
        single = IVFIndex(rows, device="cuda:0", **kw)
        sharded = IVFIndex(rows, mesh=mesh, **kw)
        for nprobe, m in ((4, None), (64, None), (8, mask.cpu().numpy())):
            kernels.reset_counts()
            s2, i2 = sharded.search(q, 10, nprobe=nprobe, row_mask=m)
            assert kernels.launches["ivf_scan"] == shards
            s1, i1 = single.search(q, 10, nprobe=nprobe, row_mask=m)
            assert torch.equal(i1, i2.to(i1.device)) and torch.equal(s1, s2.to(s1.device))


def test_sharded_scans_on_one_card_equal_the_single_scan(dev):
    """Four shards on one card (the mesh names cuda:0 four times)."""
    _sharded_vs_single(["cuda:0"] * 4)


def test_sharded_scans_across_cards_equal_the_single_scan(dev):
    """One shard per card: each shard's launches under its own current
    device, the candidates copied to cuda:0 and merged there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    _sharded_vs_single([f"cuda:{i}" for i in range(torch.cuda.device_count())])


def _mesh_vs_one_device(devices, sizes, depth: int, dtype: str, b: int):
    """One value_and_grad step of PE-Core-L14-336's widths at `depth` on a
    mesh of `devices` against the one-device trainer from the same seed on
    cuda:0: (loss, one-device loss, largest gradient error of max(1,
    |one-device|) over the leaves, launches by counter)."""
    import dataclasses

    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS, MeshConfig
    from reverso_tpu_torch.parallel import make_mesh
    from reverso_tpu_torch.train import ClipTrainer

    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], depth=depth, dtype=dtype)
    rng = np.random.default_rng(8)
    a = rng.standard_normal((b, 336, 336, 3)).astype(np.float32)
    v = a[:, :, ::-1, :] + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    one = ClipTrainer(cfg, seed=4, device="cuda:0")
    loss1, g1 = one.value_and_grad(a, v)
    mesh = make_mesh(MeshConfig(axis_sizes=sizes), devices=devices)
    tm = ClipTrainer(cfg, mesh, seed=4)
    kernels.reset_counts()
    loss, g = tm.value_and_grad(a, v)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    err = max(float((g[n].to(g1[n].device) - w).abs().max()) / max(1.0, float(w.abs().max()))
              for n, w in g1.items())
    return float(loss), float(loss1), err, launches


def test_train_mesh_on_one_card(dev):
    """A 2 x 2 mesh on cuda:0 (the card named four times), depth 2, B = 4 a
    view: in bf16 every model shard's attention and MLP launch K3 and K4
    forward and backward on the tensor-core routes (2 views x 2 blocks x 4
    shards = 16 each; head dim 64, 8 heads and 2048 hidden units a shard),
    none elsewhere; in fp32 (the split routes) the step against the
    one-device trainer's: the loss within 1e-6 of it, every gradient within
    1e-4 of max(1, |one-device|)."""
    devices = ["cuda:0"] * 4
    loss, loss1, err, n = _mesh_vs_one_device(devices, (2, 2), 2, "bfloat16", 4)
    for name in ("flash_heads_tc", "flash_heads_bwd_tc", "fused_mlp_tc", "fused_mlp_bwd_tc"):
        assert n[name] == 16, (name, n)
    assert n["flash_heads_split"] == n["fused_mlp_split"] == n["flash_attn"] == 0, n
    assert np.isfinite(loss) and err <= 2e-2, (loss, loss1, err)
    loss, loss1, err, n = _mesh_vs_one_device(devices, (2, 2), 2, "float32", 4)
    assert n["flash_heads_bwd_split"] == n["fused_mlp_bwd_split"] == 16, n
    print(f"fp32 2 x 2 on one card: loss {loss} vs {loss1}, gradient error {err:.3e}")
    assert abs(loss - loss1) <= 1e-6 * max(1.0, abs(loss1)) and err <= 1e-4, (loss, loss1, err)


def test_train_mesh_across_cards(dev):
    """Data parallel over distinct cards (a data axis of every card, model
    1): the fp32 step against the one-device trainer's, as above."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    loss, loss1, err, n = _mesh_vs_one_device(devices, (-1, 1), 2, "float32", len(devices))
    assert n["flash_heads_bwd_split"] == 2 * 2 * len(devices), n
    assert abs(loss - loss1) <= 1e-6 * max(1.0, abs(loss1)) and err <= 1e-4, (loss, loss1, err)


# ---- the hardware probes (reverso_tpu_torch/probes/, P1-P5) ----

@pytest.mark.parametrize("n_rows,tile,bufs,streams,ctas,d", [
    (1024, 16, 4, 1, 1, 1024), (1000, 16, 2, 4, 2, 1024), (4096, 8, 8, 2, 1, 256),
    (333, 48, 2, 1, 1, 512), (640, 4, 2, 2, 1, 1024),
])
def test_probe_dma_kernel(dev, n_rows, tile, bufs, streams, ctas, d):
    """P1 equals its plain version exactly (a max), ragged row counts (the
    rows past the last whole tile unread), sub-tiles of 2 to 48 rows."""
    from reverso_tpu_torch.probes.bench_dma import stream_max, stream_max_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    db = _randn(gen, n_rows, d, dtype=torch.bfloat16)
    out = stream_max(db, tile, bufs, streams, ctas)
    assert torch.equal(out, stream_max_ref(db, tile, streams))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("m,k,n,iters", [(128, 256, 256, 1), (256, 128, 512, 7),
                                         (128, 1024, 256, 64)])
def test_probe_mxu_kernel(dev, dtype, m, k, n, iters):
    """P2 against `mxu_ref`: int8 bit for bit (s32 sums), bf16 and the fp32
    split mode element by element within `mxu_tol`."""
    from reverso_tpu_torch.probes.bench_mxu import mxu, mxu_ref, mxu_tol, seeded_operands
    gen = torch.Generator(device="cuda").manual_seed(2)
    a, b = seeded_operands(dtype, m, k, n, "cuda", gen)
    out = mxu(a, b, iters)
    ref = mxu_ref(a, b, iters)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        assert bool(((out.double() - ref.double()).abs() <= mxu_tol(a, b, iters)).all())


@pytest.mark.parametrize("variant", ["unroll", "stage", "wide"])
@pytest.mark.parametrize("n,d,q", [(50000, 128, 16), (3001, 200, 130), (100, 64, 1)])
def test_probe_scan_kernel(dev, variant, n, d, q):
    """P3 against `scan_ref` within `reassociation_tol`: ragged row counts (the last
    tile's rows past n at -inf), d not a multiple of 64, a second query
    block of 2, a single query, three tiles a CTA and one."""
    from reverso_tpu_torch.probes import reassociation_tol
    from reverso_tpu_torch.probes.bench_scan_overlap import scan, scan_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    db = _randn(gen, n, d, dtype=torch.bfloat16)
    queries = _randn(gen, q, d, dtype=torch.bfloat16)
    out = scan(db, queries, variant)
    ref = scan_ref(db, queries, variant)
    assert out.shape == ref.shape
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    fin = ~torch.isneginf(ref)
    assert float((out[fin] - ref[fin]).abs().max()) <= reassociation_tol(queries, db)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("grid", [0, 1, 3])
def test_probe_dyn_dma_kernel(dev, dtype, grid):
    """P4 at the script's awkward offsets and random ones, on one CTA, a
    grid of one an SM and three CTAs: int8 exactly, bf16 within
    `dyn_dma_tol`; d = 1024 and a last k step TMA zero-fills past d (208
    bf16, 192 int8)."""
    from reverso_tpu_torch.probes.proto_dyn_dma import (dyn_dma, dyn_dma_ref, dyn_dma_tol,
                                                        offsets, seeded)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for d in (1024, 208 if dtype == torch.bfloat16 else 200 // 16 * 16):
        mat, q = seeded(dtype, 5000, d, "cuda", gen)
        offs = torch.tensor(offsets(5000) + (4488, 2, 999), dtype=torch.int32, device="cuda")
        out = dyn_dma(offs, q, mat, grid)
        ref = dyn_dma_ref(offs, q, mat)
        assert float((out - ref).abs().max()) <= dyn_dma_tol(q, mat)


@pytest.mark.parametrize("n,iters", [(8, 64), (256, 64), (453, 7), (1000, 64), (13294, 3),
                                     (5, 0)])
def test_probe_gather_kernel(dev, n, iters):
    """P5 equals its plain version exactly (the same fp32 adds in the same
    order), the table in shared memory (n <= 453) and in device memory;
    negative indices wrap as Python's modulo does."""
    from reverso_tpu_torch.probes.bench_deformable import gather, gather_ref, seeded
    gen = torch.Generator(device="cuda").manual_seed(5)
    tab, idx = seeded(n, "cuda", gen)
    idx = idx - n // 2
    assert torch.equal(gather(tab, idx, iters), gather_ref(tab, idx, iters))


# ---- the tower's fused residual + LayerNorm pass (csrc/add_layernorm.cu) ----

def _bf16_ulp(t):
    """One ulp of each bf16 value of t, as fp32 (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("mode", ["norm", "residual", "scaled"])
@pytest.mark.parametrize("t,w,dtype", [
    (36928, 1024, torch.bfloat16),   # a B = 64 PE / CLIP batch's tokens
    (1001, 1024, torch.bfloat16),    # ragged T
    (577, 1536, torch.bfloat16),     # PE-G14's width: 6 vectors a lane
    (300, 64, torch.bfloat16),       # test-tiny's width: part of a warp
    (257, 200, torch.bfloat16),      # 25 vectors, no power of two
    (4616, 1024, torch.float32),     # the fp32 tower
    (33, 1536, torch.float32),       # fp32 at the widest bucket
])
def test_add_layernorm_kernel(dev, mode, t, w, dtype):
    """One launch against `add_layernorm_ref` on the card: r bit for bit,
    h within one bf16 ulp (fp32: within 1e-5 of max(1, |h|), the order of
    the fp32 sums), plus 1e-5 in bf16 where h is near 0: there the affine's
    fp32 terms, up to ~20 here, cancel, and their few-ulp differences
    exceed h's own ulp. A LayerNorm alone writes h only."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.norm import add_layernorm, add_layernorm_ref

    gen = torch.Generator(device="cuda").manual_seed(t + w)
    x = _randn(gen, t, w, dtype=dtype, scale=3.0) + 0.5
    y = None if mode == "norm" else _randn(gen, t, w, dtype=dtype)
    lw, lb = 1 + 0.3 * _randn(gen, w, dtype=torch.float32), _randn(gen, w, dtype=torch.float32)
    gamma = 0.1 + 0.05 * _randn(gen, w, dtype=torch.float32) if mode == "scaled" else None
    n0, plain0 = kernels.launches["add_layernorm"], kernels.plain_dispatches["norm_shape"]
    with torch.inference_mode():
        r, h = add_layernorm(x, y, lw, lb, gamma=gamma)
        rr, hr = add_layernorm_ref(x, y, lw, lb, gamma=gamma)
    torch.cuda.synchronize()
    assert kernels.launches["add_layernorm"] == n0 + 1
    assert kernels.plain_dispatches["norm_shape"] == plain0
    key = ("add_layernorm", (t, w, str(dtype).split(".")[-1], y is not None, gamma is not None))
    assert kernels.shape_launches[key] >= 1
    assert r.dtype == h.dtype == dtype and torch.equal(r, rr)
    if y is None:
        assert r is x
    diff = (h.float() - hr.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= _bf16_ulp(hr) + 1e-5).all()), float((diff - _bf16_ulp(hr)).max())
    else:
        assert bool((diff <= 1e-5 * hr.float().abs().clamp(min=1.0)).all()), float(diff.max())


def test_add_layernorm_routes(dev):
    """The route from what the call observes: under grad the kernel too
    (through `AddLayerNormFunction`), and an unaligned base is copied to
    an aligned one; a width the kernel does not take (W % 8 != 0, W above
    3072 in bf16), fp16 or a bf16 compute dtype is counted in
    `plain_dispatches["norm_shape"]` and computed plainly."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.norm import add_layernorm, add_layernorm_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    lw = torch.ones(4096, device="cuda")
    lb = torch.zeros(4096, device="cuda")
    x = _randn(gen, 8, 1024, dtype=torch.bfloat16)
    n0, plain0 = kernels.launches["add_layernorm"], kernels.plain_dispatches["norm_shape"]
    with torch.enable_grad():
        xg = x.clone().requires_grad_()
        r, h = add_layernorm(xg, x, lw[:1024], lb[:1024])
        assert r.requires_grad and h.requires_grad
    base = torch.empty(8 * 1024 + 1, dtype=torch.bfloat16, device="cuda")
    with torch.inference_mode():
        r, h = add_layernorm(base[1:].view(8, 1024).copy_(x), x, lw[:1024], lb[:1024])
        assert torch.equal(r, add_layernorm_ref(x, x, lw[:1024], lb[:1024])[0])
    assert kernels.launches["add_layernorm"] == n0 + 2
    assert kernels.plain_dispatches["norm_shape"] == plain0
    cases = [(_randn(gen, 8, 1028, dtype=torch.bfloat16), {}),
             (_randn(gen, 8, 4096, dtype=torch.bfloat16), {}),
             (_randn(gen, 8, 1024, dtype=torch.float16), {}),
             (x, {"compute_dtype": torch.bfloat16})]
    with torch.inference_mode():
        for i, (xi, kw) in enumerate(cases):
            w = xi.shape[-1]
            r, h = add_layernorm(xi, xi, lw[:w], lb[:w], **kw)
            rr, hr = add_layernorm_ref(xi, xi, lw[:w], lb[:w], **kw)
            assert torch.equal(r, rr) and torch.equal(h, hr)
            assert kernels.plain_dispatches["norm_shape"] == plain0 + i + 1
    assert kernels.launches["add_layernorm"] == n0 + 2


@pytest.mark.parametrize("mode", ["norm", "residual", "scaled"])
@pytest.mark.parametrize("t,dtype", [(16 * 577, torch.bfloat16),   # a training view's tokens
                                     (4 * 577, torch.float32)])    # the fp32 run's
def test_add_layernorm_grad(dev, mode, t, dtype):
    """Under autograd, one launch forward (`AddLayerNormFunction`) against
    the plain composition's autograd: r bit for bit, h as in the no-grad
    test, and every input's gradient (r also used past the site, as the
    next residual) within what the kernel's row statistics move: PyTorch's
    layer_norm backward runs on both sides, and only its mean and 1 /
    sqrt(var + eps) differ (two passes against Welford, in the last fp32
    bits). So the fp32 gradients agree within 1e-5 of their largest
    magnitude; in bf16, x's and y's are equal bit for bit in 99% of their
    elements, and theirs and gamma's lie within one bf16 ulp of their
    largest magnitude: the layer_norm part is rounded to bf16 before the
    residual's gradient is added, so an ulp it moves can be several of a
    sum that cancels."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops.norm import add_layernorm, add_layernorm_ref

    w = 1024
    gen = torch.Generator(device="cuda").manual_seed(t)
    x0 = _randn(gen, t, w, dtype=dtype, scale=3.0)
    y0 = None if mode == "norm" else _randn(gen, t, w, dtype=dtype)
    p0 = [1 + 0.3 * _randn(gen, w, dtype=torch.float32), _randn(gen, w, dtype=torch.float32),
          0.1 + 0.05 * _randn(gen, w, dtype=torch.float32) if mode == "scaled" else None]
    dr, dh = (_randn(gen, t, w, dtype=torch.float32) for _ in range(2))
    outs, grads = [], []
    for fn in (add_layernorm, add_layernorm_ref):
        leaves = [None if v is None else v.clone().requires_grad_() for v in (x0, y0, *p0)]
        x, y, lw, lb, g = leaves
        n0 = kernels.launches["add_layernorm"]
        with torch.enable_grad():
            r, h = fn(x, y, lw, lb, gamma=g)
            ((r.float() * dr).sum() + (h.float() * dh).sum()).backward()
        torch.cuda.synchronize()
        assert kernels.launches["add_layernorm"] == n0 + (fn is add_layernorm)
        outs.append((r.detach(), h.detach()))
        grads.append([None if v is None else v.grad for v in leaves])
    (r, h), (rr, hr) = outs
    assert torch.equal(r, rr)
    diff = (h.float() - hr.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= _bf16_ulp(hr) + 1e-5).all()), float((diff - _bf16_ulp(hr)).max())
    else:
        assert bool((diff <= 1e-5 * hr.float().abs().clamp(min=1.0)).all()), float(diff.max())
    for i, (a, c) in enumerate(zip(*grads)):
        assert (a is None) == (c is None)
        if a is None:
            continue
        assert a.dtype == c.dtype
        diff, top = (a.float() - c.float()).abs(), c.float().abs().max()
        equal = float((diff == 0).float().mean())
        print(f"{mode} {dtype} leaf {i}: largest gap {float(diff.max()):.3e} of "
              f"{float(top):.3e}, equal share {equal:.5f}")
        if dtype == torch.bfloat16 and i in (0, 1, 4):   # x, y, gamma: rounded to bf16
            assert bool((diff <= _bf16_ulp(top)).all()), (i, float(diff.max()), float(top))
            assert i == 4 or equal >= 0.99, (i, equal)
        else:
            assert bool((diff <= 1e-5 * top).all()), (i, float(diff.max()), float(top))


@pytest.mark.parametrize("family,gap", [("pe", 0.008), ("clip", 0.015)])
def test_tower_fused_norms_vs_plain(dev, family, gap):
    """A full-depth PE-Core-L14-336 / CLIP-L14-336 tower (B = 8, bf16, seeded
    weights) under inference_mode: the fused norm sites (two launches a block,
    PE's ln_post over every token, the pool's or CLIP's ln_post) against the
    plain composition, unit embeddings within the benchmark cells'
    `embed_gap` readings (PE 0.008, CLIP 0.015), the tokens within 5% of
    their largest magnitude (bf16 roundings of h that differ by an ulp,
    carried through 24 blocks)."""
    import dataclasses

    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models import vit
    from reverso_tpu_torch.models.pe import PerceptionEncoder
    from reverso_tpu_torch.ops.norm import add_layernorm_ref

    cfg = MODEL_PRESETS["PE-Core-L14-336" if family == "pe" else "CLIP-L14-336"]
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    enc = PerceptionEncoder(cfg, family=family, seed=3, device="cuda")
    x = torch.randn(8, 336, 336, 3, generator=torch.Generator().manual_seed(2)).cuda()
    kernels.reset_counts()
    with torch.inference_mode():
        out, tokens = enc.module(x, return_tokens=True)
        launches = kernels.launches["add_layernorm"]
        fused = vit.add_layernorm
        vit.add_layernorm = lambda *a, **kw: add_layernorm_ref(*a, **kw)
        try:
            ref, ref_tokens = enc.module(x, return_tokens=True)
        finally:
            vit.add_layernorm = fused
    torch.cuda.synchronize()
    # ln1 of block 0 (and CLIP's ln_pre), ln2 and each block's end with the
    # next norm (PE's last with ln_post), the pool's norm or CLIP's ln_post
    assert launches == 2 * cfg.depth + 2, launches
    assert kernels.launches["add_layernorm"] == launches
    assert kernels.plain_dispatches["norm_shape"] == 0
    unit = lambda e: torch.nn.functional.normalize(e.float(), dim=-1)
    dist = float((unit(out) - unit(ref)).norm(dim=-1).max())
    print(f"{family}: fused vs plain norms, largest unit-embedding distance {dist:.3e}")
    assert dist <= gap, dist
    assert bool(torch.isfinite(tokens.float()).all())
    assert float((tokens.float() - ref_tokens.float()).abs().max()) <= 0.05 * float(
        ref_tokens.float().abs().max())


def test_tp_forward_fused_norms(dev):
    """The tensor-parallel tower (a 2 x 2 mesh of cuda:0, depth 2, bf16) under
    inference_mode takes the fused pass on each data shard's home device and
    embeds as the one-device tower does."""
    import dataclasses

    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS, MeshConfig
    from reverso_tpu_torch.parallel import make_mesh
    from reverso_tpu_torch.train import ClipTrainer

    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], depth=2, dtype="bfloat16")
    a = np.random.default_rng(8).standard_normal((4, 336, 336, 3)).astype(np.float32)
    one = ClipTrainer(cfg, seed=4, device="cuda:0")
    mesh = make_mesh(MeshConfig(axis_sizes=(2, 2)), devices=["cuda:0"] * 4)
    tm = ClipTrainer(cfg, mesh, seed=4)
    with torch.inference_mode():
        e1 = one._embed(one.shard_batch(a))
        kernels.reset_counts()
        em = tm._embed(tm.shard_batch(a))
    torch.cuda.synchronize()
    # per data shard: ln1, ln2, the block end with ln1, ln2, the end with
    # ln_post, the pool's norm
    assert kernels.launches["add_layernorm"] == 2 * 6, dict(kernels.launches)
    assert kernels.plain_dispatches["norm_shape"] == 0
    assert float((em.float() - e1.float()).norm(dim=-1).max()) <= 2e-2
