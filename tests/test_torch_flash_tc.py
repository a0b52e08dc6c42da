"""The tensor-core kernels (K3, K6 and K7 on the flash core and its fp32
split mode, K4 on the wgmma GEMMs): what the CPU can hold of them.

* the wrappers' dispatch rules (`ops/attention.py::heads_route` and
  `attention_route`, `ops/fused_mlp.py::mlp_route`) for every preset's widths, both dtypes,
  the rel-pos bias and the heads-in-lanes form;
* the ctypes argument lists in `kernels._SIGNATURES` against the
  `extern "C"` launchers under `csrc/`, parsed from the sources;
* the basis of the card's bf16 tolerance: a numpy emulation of the
  kernel's per-tile rounding (online softmax, p rounded to bf16 against
  the running max, 64-key tiles) against the JAX package's Pallas kernels
  in interpret mode at S = 577 (heads in lanes, RoPE), S = 1297, and S =
  256 with SAM's rel-pos bias (bf16 operands, fp32 bias), and the bias
  mode's plain version (`attention_bf16_ref`) against the emulation;
* the split mode (fp32 operands as three bf16 parts, six products): the
  split is exact, and the emulated kernel (six products a tile, p kept in
  fp32 and split) and its plain version (`attention_split_ref`) hold the
  card's fp32 gate against the fp32 `attention_ref` and the JAX package's
  Pallas kernels in interpret mode.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.ops import attention as jattn
from reverso_tpu_torch import kernels
from reverso_tpu_torch.config import MODEL_PRESETS
from reverso_tpu_torch.ops import attention as tattn
from reverso_tpu_torch.ops import split as tsplit
from reverso_tpu_torch.ops.fused_mlp import mlp_route
from reverso_tpu_torch.ops.rope import rope_2d_tables

TOL_BF16 = 2e-2      # the card's bf16 tolerance (chip_smoke.py, test_torch_cuda.py)
TOL_F32 = 2e-5       # the card's fp32 tolerance (chip_smoke.py, test_torch_cuda.py)
KERNEL_BK = 64       # keys per tile of csrc/flash_tc.cuh (kBK)


@pytest.mark.parametrize("preset", sorted(MODEL_PRESETS))
def test_route_for_every_preset_head_dim(preset):
    cfg = MODEL_PRESETS[preset]
    hd = cfg.width // cfg.num_heads
    route, heads_route = tattn.attention_route, tattn.heads_route
    on_tensor_cores = hd % 16 == 0 and hd <= 128
    # [B, H, S, D]: bf16 on the bf16 core at every head dim (padded to a
    # multiple of 16), fp32 on its split mode
    assert route("cuda", torch.bfloat16, hd) == "tensor_core"
    assert route("cuda", torch.float32, hd) == "split"
    # heads in lanes: the bf16 core through TMA at its head dims and
    # aligned bases, else through the lanes' copy; fp32 on its split mode
    assert heads_route("cuda", torch.bfloat16, hd) == (
        "tensor_core" if on_tensor_cores else "copy")
    assert heads_route("cuda", torch.bfloat16, hd, aligned=False) == "copy"
    assert heads_route("cuda", torch.float32, hd) == "split"
    assert heads_route("cuda", torch.float32, hd, aligned=False) == "split"
    # the rel-pos bias takes the bf16 core in either dtype (the TPU
    # kernel's one bf16 pass), fp32 at head dims % 16 != 0 the split mode
    assert route("cuda", torch.bfloat16, hd, rel_bias=True) == "tensor_core"
    assert route("cuda", torch.float32, hd, rel_bias=True) == (
        "tensor_core" if hd % 16 == 0 else "split")
    for dtype in (torch.bfloat16, torch.float32):
        for bias in (False, True):
            assert route("cpu", dtype, hd, rel_bias=bias) == "plain"
        assert heads_route("cpu", dtype, hd) == "plain"
    # every shipped preset's bf16 tower runs on the tensor cores
    assert on_tensor_cores


@pytest.mark.parametrize("hd,heads_bf16,bias_f32", [
    (6, "copy", "split"), (8, "copy", "split"), (16, "tensor_core", "tensor_core"),
    (48, "tensor_core", "tensor_core"), (80, "tensor_core", "tensor_core"),
    (96, "tensor_core", "tensor_core"), (128, "tensor_core", "tensor_core"),
    (120, "copy", "split"), (144, "copy", "tensor_core"),
    (256, "copy", "tensor_core"),
])
def test_route_head_dims(hd, heads_bf16, bias_f32):
    """Heads in lanes take the bf16 core through TMA at head dims % 16 ==
    0, <= 128, through the lanes' copy at other head dims, and its split
    mode in fp32; [B, H, S, D] takes the bf16 core in bf16 at every head
    dim and the split mode in fp32; SAM's fp32 bias the bf16 core at head
    dims % 16 == 0, else the split mode. Past 128 the route's kernel
    refuses the call."""
    route, heads_route = tattn.attention_route, tattn.heads_route
    assert heads_route("cuda", torch.bfloat16, hd) == heads_bf16
    assert heads_route("cuda", torch.float32, hd) == "split"
    assert route("cuda", torch.bfloat16, hd) == "tensor_core"
    assert route("cuda", torch.bfloat16, hd, rel_bias=True) == "tensor_core"
    assert route("cuda", torch.float32, hd, rel_bias=True) == bias_f32
    assert route("cuda", torch.float32, hd) == "split"


@pytest.mark.parametrize("preset", sorted(MODEL_PRESETS))
def test_mlp_route_for_every_preset(preset):
    """Every preset's bf16 MLP takes the wgmma GEMMs; fp32 the same GEMMs
    on split parts; CPU tensors the plain version."""
    cfg = MODEL_PRESETS[preset]
    width, hidden = cfg.width, int(cfg.width * cfg.mlp_ratio)
    assert mlp_route("cuda", torch.bfloat16, width, hidden) == "tensor_core"
    assert mlp_route("cuda", torch.float32, width, hidden) == "split"
    for dtype in (torch.bfloat16, torch.float32):
        assert mlp_route("cpu", dtype, width, hidden) == "plain"


@pytest.mark.parametrize("width,hidden,expected", [
    (64, 256, "tensor_core"), (1024, 4096, "tensor_core"), (1536, 8960, "tensor_core"),
    (72, 200, "tensor_core"), (8, 8, "tensor_core"),
    (68, 256, "tensor_core_padded"), (64, 250, "tensor_core_padded"),
    (77, 200, "tensor_core_padded"),
])
def test_mlp_route_widths(width, hidden, expected):
    """TMA's 16-byte row strides: bf16 at width and hidden multiples of 8
    as it is, else through zero-padded copies; fp32 on split parts (padded
    to a pitch of 8 by the split pass) at every width."""
    assert mlp_route("cuda", torch.bfloat16, width, hidden) == expected
    assert mlp_route("cuda", torch.float32, width, hidden) == "split"


def test_cpu_tensors_take_the_plain_versions():
    """bf16 CPU tensors at a tensor-core head dim run the plain versions
    and count no launch."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    before = dict(kernels.launches)
    out = tattn.flash_attention(q, k, v, kv_valid=7)
    assert torch.equal(out, tattn.attention_ref(q, k, v, kv_valid=7))
    x = q.transpose(1, 2).reshape(1, 9, 32)
    out = tattn.flash_attention_heads(x, x, x, heads=2)
    assert torch.equal(out, tattn.flash_attention_heads_ref(x, x, x, heads=2))
    assert kernels.launches == before
    assert {"flash_heads_tc", "flash_attn_tc", "flash_attn_split",
            "flash_attn_relbias_split", "topk_stream_f32", "flash_heads_split",
            "fused_mlp_split", "split_parts"} <= set(kernels.launches)


def _launchers():
    """{name: [ctypes type per argument]} of every `extern "C"` launcher."""
    pat = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
    found = {}
    for path in kernels.sources():
        for name, args in pat.findall(open(path).read()):
            types = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                types.append(kernels._P if "*" in arg else
                             kernels._F if arg.startswith("float") else kernels._I)
            found[name] = types
    return found


def test_signatures_match_the_launchers():
    found = _launchers()
    assert {"rv_flash_heads_tc", "rv_flash_attn_tc", "rv_flash_attn_split",
            "rv_fused_mlp_tc", "rv_flash_heads_split", "rv_fused_mlp_split",
            "rv_split_parts"} <= set(found)
    # the CUDA-core kernels the split routes replaced are gone
    assert not {"rv_flash_heads", "rv_fused_mlp"} & set(found)
    assert set(found) == set(kernels._SIGNATURES)
    for name, types in found.items():
        assert kernels._SIGNATURES[name] == types, name


def _bf16(x):
    """Round float32 to bfloat16 (nearest even), kept as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _rotate(x, cos, sin, mul):
    """The kernel's fp32 RoPE: x * cos + [-b, a | -e, c] * sin, times mul."""
    qh = x.shape[-1] // 4
    a, b, c, e = (x[..., i * qh:(i + 1) * qh] for i in range(4))
    half = np.concatenate([-b, a, -e, c], axis=-1)
    return _bf16((x * cos + half * sin) * np.float32(mul))


def _split3(x):
    """fp32 x as three bf16-valued fp32 parts: hi = bf16(x), mid = bf16(x -
    hi), lo = bf16(x - hi - mid)."""
    x = np.asarray(x, np.float32)
    hi = _bf16(x)
    r = (x - hi).astype(np.float32)
    mid = _bf16(r)
    return hi, mid, _bf16((r - mid).astype(np.float32))


def _split_dot(a, b):
    """a @ b.T as the split mode's products: the six bf16 products of the
    three-way splits (`ops/split.py::SPLIT_TERMS`), smallest first,
    summed in fp32."""
    ap, bp = _split3(a), _split3(b)
    out = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for i, j in tsplit.SPLIT_TERMS:
        out = (out + ap[i] @ bp[j].T).astype(np.float32)
    return out


def _online_tiles(q, k, v, score_mul, kv_valid, bk=KERNEL_BK, bias=None, out_bf16=True,
                  split=False):
    """The kernel's arithmetic on one head: [S, D] bf16-valued float32 in,
    bf16-valued out (or fp32 with out_bf16=False). Scores in fp32 (plus
    the fp32 `bias` [Sq, Skv], if given) times log2(e) * scale, per
    bk-key tile a running max m, p = exp2(t - m) rounded to bf16 for the
    PV product against that running max, the fp32 row sum and accumulator
    rescaled by exp2(m_old - m_new) when the max moves, acc / l at the
    end. split=True is the split mode: fp32 q (the scale folded in), k and
    v, each tile's products as six bf16 products of their three-way splits
    (`_split_dot`), p kept in fp32 and split the same way for the PV
    product, taken per tile and added to the fp32 accumulator, fp32 out."""
    sq = q.shape[0]
    m = np.full((sq, 1), -np.inf, np.float32)
    l = np.zeros((sq, 1), np.float32)
    acc = np.zeros((sq, v.shape[1]), np.float32)
    for lo in range(0, kv_valid, bk):
        hi = min(lo + bk, kv_valid)
        t = _split_dot(q, k[lo:hi]) if split else (q @ k[lo:hi].T).astype(np.float32)
        if bias is not None:
            t = t + bias[:, lo:hi]
        t = t * np.float32(score_mul)
        m_new = np.maximum(m, t.max(axis=1, keepdims=True))
        corr = np.exp2(m - m_new)
        p = np.exp2(t - m_new)
        l = l * corr + p.sum(axis=1, keepdims=True)
        pv = _split_dot(p, v[lo:hi].T) if split else _bf16(p) @ v[lo:hi]
        acc = acc * corr + pv
        m = m_new
    return _bf16(acc / l) if out_bf16 and not split else acc / l


def test_online_rounding_heads_in_lanes_rope():
    """K3's shape (S = 577, hd 64, RoPE, B = 1, 2 heads) with kv_valid = S
    and 300: the emulated kernel against the JAX kernel."""
    rng = np.random.default_rng(11)
    s, heads, hd = 577, 2, 64
    q, k, v = (_bf16(rng.standard_normal((1, s, heads * hd)).astype(np.float32))
               for _ in range(3))
    cos, sin = rope_2d_tables(24, hd, cls_token=True)
    scale = hd ** -0.5
    errs = []
    for kv_valid in (s, 300):
        ref = np.asarray(jattn.flash_attention_heads(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), heads=heads, cos=cos,
            sin=sin, kv_valid=kv_valid, interpret=True).astype(jnp.float32))
        out = np.empty_like(ref)
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            qr = _rotate(q[0, :, cols], cos, sin, scale)
            kr = _rotate(k[0, :, cols], cos, sin, 1.0)
            out[0, :, cols] = _online_tiles(qr, kr, v[0, :, cols], np.log2(np.e), kv_valid)
        errs.append(float(np.abs(out - ref).max()))
    print(f"K3 online-softmax rounding vs the JAX kernel: max abs err {errs} "
          f"(tolerance {TOL_BF16})")
    assert max(errs) < TOL_BF16


def test_online_rounding_long_sequence():
    """K7's shape (S = 1297, D 64, B = 1, 2 heads) with kv_valid = S and
    1000: the emulated kernel against the JAX kernel."""
    rng = np.random.default_rng(12)
    s, h, d = 1297, 2, 64
    q, k, v = (_bf16(rng.standard_normal((1, h, s, d)).astype(np.float32))
               for _ in range(3))
    mul = np.log2(np.e) * d ** -0.5
    errs = []
    for kv_valid in (s, 1000):
        ref = np.asarray(jattn.flash_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), kv_valid=kv_valid,
            interpret=True).astype(jnp.float32))
        out = np.stack([_online_tiles(q[0, i], k[0, i], v[0, i], mul, kv_valid)
                        for i in range(h)])[None]
        errs.append(float(np.abs(out - ref).max()))
    print(f"K7 online-softmax rounding vs the JAX kernel: max abs err {errs} "
          f"(tolerance {TOL_BF16})")
    assert max(errs) < TOL_BF16


def _relbias_case(seed, d, g, sq, kv_valid):
    """bf16-valued q, k, v [1, 2, S, d] (S = g * g keys) and fp32 bias
    parts [1, 2, sq, g]; the emulated kernel per head (bf16(q * scale),
    the bias added to the fp32 scores, log2(e) as the score multiplier)."""
    rng = np.random.default_rng(seed)
    skv = g * g
    q = _bf16(rng.standard_normal((1, 2, sq, d)).astype(np.float32))
    k, v = (_bf16(rng.standard_normal((1, 2, skv, d)).astype(np.float32)) for _ in range(2))
    bh, bw = (rng.standard_normal((1, 2, sq, g)).astype(np.float32) * 0.5 for _ in range(2))
    return q, k, v, bh, bw


def _emulate_relbias(q, k, v, bh, bw, g, kv_valid, out_bf16):
    scale = np.float32(q.shape[-1] ** -0.5)
    out = []
    for h in range(q.shape[1]):
        bias = (bh[0, h][:, :, None] + bw[0, h][:, None, :]).reshape(bh.shape[2], g * g)
        out.append(_online_tiles(_bf16(q[0, h] * scale), k[0, h], v[0, h], np.log2(np.e),
                                 kv_valid, bias=bias, out_bf16=out_bf16))
    return np.stack(out)[None]


@pytest.mark.parametrize("dtype,d,g,sq,kv_valid", [
    ("bfloat16", 32, 16, 256, 256),   # the TPU's bf16 contract, one 256-key JAX tile
    ("bfloat16", 32, 16, 200, 190),   # ragged q rows, keys past kv_valid
    ("float32", 64, 16, 256, 256),    # fp32 inputs holding bf16 values: only p's rounding differs
])
def test_online_rounding_rel_bias(dtype, d, g, sq, kv_valid):
    """K6's bias mode (SAM's decomposed rel-pos bias, G = 16, S = 256):
    the emulated kernel (64-key tiles, bf16 q * scale, k, p, v, the fp32
    bias) against the JAX kernel in interpret mode. With bf16 inputs the
    JAX kernel computes the TPU's bf16 contract (p rounded against its
    256-key tile's running max); with fp32 inputs it computes in fp32 on
    the CPU, which here differs only by p's bf16 rounding (q, k, v hold
    bf16 values and the scale 1/8 is exact)."""
    q, k, v, bh, bw = _relbias_case(13 + d, d, g, sq, kv_valid)
    jdt = getattr(jnp, dtype)
    ref = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), kv_valid=kv_valid,
        rel_bias=(jnp.asarray(bh), jnp.asarray(bw), g), interpret=True).astype(jnp.float32))
    out = _emulate_relbias(q, k, v, bh, bw, g, kv_valid, out_bf16=dtype == "bfloat16")
    err = float(np.abs(out - ref).max())
    print(f"K6 bias mode ({dtype}, d {d}, kv_valid {kv_valid}) vs the JAX kernel: "
          f"max abs err {err} (tolerance {TOL_BF16})")
    assert err < TOL_BF16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_operand_plain_version(dtype):
    """`attention_bf16_ref`, the plain version the card holds K6 against,
    against the emulated kernel: both round q * scale, k, p and v to bf16
    and keep the sums and the bias in fp32; p is rounded against the final
    max there and the running max in the kernel."""
    g, d, sq, kv_valid = 16, 64, 256, 250
    q, k, v, bh, bw = _relbias_case(29, d, g, sq, kv_valid)
    t = lambda a: torch.from_numpy(a).to(dtype)
    out = tattn.attention_bf16_ref(t(q), t(k), t(v), kv_valid=kv_valid,
                                   rel_bias=(torch.from_numpy(bh), torch.from_numpy(bw), g))
    assert out.dtype == dtype
    emu = _emulate_relbias(q, k, v, bh, bw, g, kv_valid, out_bf16=dtype == torch.bfloat16)
    err = float((out.float() - torch.from_numpy(emu)).abs().max())
    # the same function on bf16 inputs and on fp32 inputs holding their values
    other = tattn.attention_bf16_ref(*(t(a).to(torch.float32 if dtype == torch.bfloat16
                                                  else torch.bfloat16) for a in (q, k, v)),
                                     kv_valid=kv_valid,
                                     rel_bias=(torch.from_numpy(bh), torch.from_numpy(bw), g))
    print(f"attention_bf16_ref ({dtype}) vs the emulated kernel: max abs err {err} "
          f"(tolerance {TOL_BF16})")
    assert err < TOL_BF16
    assert float((other.float() - out.float()).abs().max()) <= 2 ** -7


# ---- the split mode: fp32 operands on the bf16 tensor cores ----------------


@pytest.mark.parametrize("magnitude", [1e-30, 1e-20, 1e-10, 1e-3, 1.0, 1e3, 1e10, 1e20, 1e30])
def test_split_reconstructs_fp32_exactly(magnitude):
    """hi + mid + lo == x bit for bit for seeded normals of either sign at
    magnitudes 1e-30 to 1e30, each part a bf16 value, wherever lo is a
    normal number (|x| >= 2^-110); below that lo keeps the bf16
    subnormals' 2^-133 steps. `ops/split.py::split3` (the plain
    version's split) and the numpy emulation's agree bit for bit."""
    rng = np.random.default_rng(int(np.log10(magnitude)) + 40)
    x = (rng.standard_normal(100_000) * magnitude).astype(np.float32)
    x[:4] = np.float32(magnitude) * np.array([1, -1, 1.0000001, -0.9999999], np.float32)
    hi, mid, lo = _split3(x)
    for part in (hi, mid, lo):
        assert np.array_equal(_bf16(part), part)
    total = ((hi + mid) + lo).astype(np.float32)
    normal = np.abs(x) >= np.float32(2.0 ** -110)
    assert normal.mean() > 0.999
    assert np.array_equal(total[normal].view(np.uint32), x[normal].view(np.uint32))
    assert np.all(np.abs(total - x) <= 2.0 ** -133)
    # each part holds the next 8 bits: |mid| <= 2^-8 |hi|, |lo| <= 2^-8 |mid|
    assert np.all(np.abs(mid) <= np.abs(hi) * 2.0 ** -8)
    assert np.all(np.abs(lo[normal]) <= np.abs(mid[normal]) * 2.0 ** -8)
    t = tsplit.split3(torch.from_numpy(x))
    for a, b in zip(t, (hi, mid, lo)):
        assert np.array_equal(a.numpy().view(np.uint32), b.view(np.uint32))


def test_split_terms_follow_the_kernel():
    """The plain version's six products are the kernels' table, in its
    order: smallest first, hi.hi last, the three smallest of the nine
    left out. The table sits in hopper.cuh, shared by the attention core's
    split mode and the MLP's split GEMMs."""
    src = open(f"{kernels.CSRC}/hopper.cuh").read()
    n_terms = int(re.search(r"constexpr int kSplitTerms = (\d+);", src).group(1))
    table = re.search(r"constexpr int terms\[kSplitTerms\]\[2\] = \{(.*)\};", src).group(1)
    terms = [(int(a), int(b)) for a, b in re.findall(r"\{(\d), (\d)\}", table)]
    assert len(terms) == n_terms
    assert tuple(terms) == tsplit.SPLIT_TERMS
    assert terms[-1] == (0, 0)
    nine = {(i, j) for i in range(3) for j in range(3)}
    assert nine - set(terms) == {(1, 2), (2, 1), (2, 2)}


@pytest.mark.parametrize("kv_valid", [1297, 1000])
def test_split_mode_long_sequence(kv_valid):
    """K7 in fp32 (one head, S = 1297, D = 64): the emulated split mode and
    `attention_split_ref` against the fp32 `attention_ref` and the JAX
    kernel (Precision.HIGHEST, interpret mode) within the card's fp32
    gate."""
    rng = np.random.default_rng(21)
    s, d = 1297, 64
    q, k, v = (rng.standard_normal((1, 1, s, d)).astype(np.float32) for _ in range(3))
    scale = np.float32(d ** -0.5)
    emu = _online_tiles(q[0, 0] * scale, k[0, 0], v[0, 0], np.log2(np.e), kv_valid,
                        split=True)[None, None]
    jax_out = np.asarray(jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                               kv_valid=kv_valid, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    ref = tattn.attention_ref(*t, kv_valid=kv_valid).numpy()
    plain = tattn.attention_split_ref(*t, kv_valid=kv_valid).numpy()
    errs = {name: float(np.abs(a - b).max()) for name, a, b in (
        ("emulation vs attention_ref", emu, ref), ("emulation vs JAX", emu, jax_out),
        ("attention_split_ref vs attention_ref", plain, ref),
        ("attention_split_ref vs JAX", plain, jax_out),
        ("attention_split_ref vs emulation", plain, emu))}
    print(f"K7 fp32 split mode, kv_valid {kv_valid}: {errs} (tolerance {TOL_F32})")
    assert max(errs.values()) < TOL_F32


def test_split_mode_rel_bias_ragged():
    """K6 with fp32 operands at a head dim the bf16 core does not take (D =
    40, padded to 48 on the card), G = 14 (the kBiasAny tiles), Sq = 150
    (a ragged query tile), kv_valid = 190 < 196: the emulated split mode
    and `attention_split_ref` against the fp32 `attention_ref` and the JAX
    kernel in interpret mode (fp32 on the CPU)."""
    rng = np.random.default_rng(23)
    d, g, sq, kv_valid = 40, 14, 150, 190
    q = rng.standard_normal((1, 2, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, g * g, d)).astype(np.float32) for _ in range(2))
    bh, bw = (rng.standard_normal((1, 2, sq, g)).astype(np.float32) * 0.5 for _ in range(2))
    scale = np.float32(d ** -0.5)
    emu = np.stack([_online_tiles(
        q[0, h] * scale, k[0, h], v[0, h], np.log2(np.e), kv_valid,
        bias=(bh[0, h][:, :, None] + bw[0, h][:, None, :]).reshape(sq, g * g), split=True)
        for h in range(2)])[None]
    jax_out = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), kv_valid=kv_valid, kv_tile=g * g,
        rel_bias=(jnp.asarray(bh), jnp.asarray(bw), g), interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    bias = (torch.from_numpy(bh), torch.from_numpy(bw), g)
    ref = tattn.attention_ref(*t, kv_valid=kv_valid, rel_bias=bias).numpy()
    plain = tattn.attention_split_ref(*t, kv_valid=kv_valid, rel_bias=bias).numpy()
    errs = {name: float(np.abs(a - b).max()) for name, a, b in (
        ("emulation vs attention_ref", emu, ref), ("emulation vs JAX", emu, jax_out),
        ("attention_split_ref vs attention_ref", plain, ref),
        ("attention_split_ref vs JAX", plain, jax_out))}
    print(f"K6 fp32 split mode (D 40, G 14, ragged): {errs} (tolerance {TOL_F32})")
    assert max(errs.values()) < TOL_F32


def test_split_mode_is_more_than_one_bf16_pass():
    """What the split buys: on the same fp32 inputs one bf16 pass (the bias
    mode's operands) misses the fp32 gate by far, the six products meet
    it."""
    rng = np.random.default_rng(25)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, 64)).astype(np.float32))
               for _ in range(3))
    ref = tattn.attention_ref(q, k, v)
    one_pass = float((tattn.attention_bf16_ref(q, k, v) - ref).abs().max())
    split = float((tattn.attention_split_ref(q, k, v) - ref).abs().max())
    print(f"one bf16 pass {one_pass}, six products {split} (gate {TOL_F32})")
    assert split < TOL_F32 < one_pass / 10
