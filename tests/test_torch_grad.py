"""Gradients of the port's K3 and K4 on the CPU.

* `flash_attention_heads_grad_ref` (autograd of the heads-in-lanes plain
  version) against `jax.vjp` of the JAX MHA's XLA path (RoPE by
  `apply_rope_2d`, then `attention_xla`), and `mlp_grad_ref` against
  `jax.vjp` of the flax MLP with `use_fused=False`, on the same numpy
  inputs in fp32;
* the autograd Functions' wiring (`FlashHeadsFunction`,
  `FusedMLPFunction`) by `torch.autograd.gradcheck` in float64 on CPU
  tensors, where they run the plain forward and the plain gradient;
* under autograd the kernels without a backward (K5, K6, K7) raise on a
  device tensor, naming ROADMAP item 20c, and K3 and K4 never fall back
  to their plain versions;
* the basis of the bf16 tensor-core backward's tolerance:
  `flash_attention_heads_grad_tc_ref` (its arithmetic: the forward's
  log-sum-exp, D from the bf16 output, P and dS rounded to bf16, fp32 sums
  over 64-row tiles, each output rounded once) in bf16 against `jax.vjp`
  of the XLA path and the autograd of `flash_attention_heads_ref`, within
  the card's 2e-2 of each gradient's scale.
The backward kernels themselves run on the card only
(tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.config import MODEL_PRESETS
from reverso_tpu.models.vit import MLP as JaxMLP
from reverso_tpu.ops.attention import attention_xla
from reverso_tpu.ops.rope import apply_rope_2d as jax_rope
from reverso_tpu_torch.ops.attention import (FlashHeadsFunction, flash_attention,
                                              flash_attention_heads,
                                              flash_attention_heads_grad_ref,
                                              flash_attention_heads_grad_tc_ref)
from reverso_tpu_torch.ops.fused_mlp import (FusedMLPFunction, fused_mlp, fused_mlp_int8,
                                             mlp_grad_ref, quantize_mlp_weights)
from reverso_tpu_torch.config import MODEL_PRESETS as PORT_PRESETS
from reverso_tpu_torch.ops.rope import rope_2d_tables

# fp32 on both sides, sums in another order: within 2e-5 of the largest
# gradient (1e-6 relative per fp32 product, a few products deep)
TOL = 2e-5


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out - ref).max()) <= tol * scale


def _tables(s: int, hd: int):
    """RoPE tables for s tokens: a class token and a g x g grid, identity
    rows past it (the padded-sequence mode)."""
    g = max(1, int(np.sqrt(s - 1)))
    cos, sin = rope_2d_tables(g, hd, cls_token=True)
    pad = max(0, s - cos.shape[0])
    cos = np.concatenate([cos, np.ones((pad, hd), np.float32)])[:s]
    sin = np.concatenate([sin, np.zeros((pad, hd), np.float32)])[:s]
    return cos, sin


@pytest.mark.parametrize("b,s,w,heads,kv_valid,rope", [
    (2, 17, 64, 4, None, True),      # test-tiny
    (2, 37, 64, 4, 23, True),        # kv_valid < S
    (1, 50, 96, 4, 41, False),       # CLIP family, hd 24
    (1, 26, 80, 4, None, True),      # hd 20
])
def test_heads_grad_ref_matches_jax(b, s, w, heads, kv_valid, rope):
    rng = np.random.default_rng(s + w)
    q, k, v, do = (rng.standard_normal((b, s, w)).astype(np.float32) for _ in range(4))
    hd = w // heads
    cos, sin = _tables(s, hd) if rope else (None, None)

    def jax_mha(q, k, v):
        split = lambda t: t.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)
        qh, kh, vh = split(q), split(k), split(v)
        if rope:
            qh, kh = jax_rope(qh, cos, sin), jax_rope(kh, cos, sin)
        o = attention_xla(qh, kh, vh, kv_valid=kv_valid)
        return o.transpose(0, 2, 1, 3).reshape(b, s, w)

    _, vjp = jax.vjp(jax_mha, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = flash_attention_heads_grad_ref(
        *(torch.from_numpy(t) for t in (q, k, v, do)), heads=heads,
        cos=cos, sin=sin, kv_valid=kv_valid)
    for g, w_ in zip(got, want):
        _close(g.numpy(), w_)
    if kv_valid is not None:
        assert not got[1][:, kv_valid:].any() and not got[2][:, kv_valid:].any()


# the card's tolerance for bf16 gradients: 2e-2 of max(1, the largest
# plain gradient), one bf16 rounding of P, dS and each output against the
# reference's fp32 (or its own bf16 roundings)
TC_TOL = 2e-2


@pytest.mark.parametrize("against", ["jax", "autograd"])
@pytest.mark.parametrize("b,s,w,heads,kv_valid,rope", [
    (2, 17, 64, 4, None, True),       # test-tiny: hd 16
    (1, 37, 192, 2, None, True),      # hd 96 (PE-G14's head dim)
    (1, 50, 128, 2, 41, False),       # CLIP family: the scale on the scores
    (1, 577, 64, 1, 300, True),       # one head of PE-L14 at S = 577, kv_valid < S
])
def test_heads_grad_tc_ref(b, s, w, heads, kv_valid, rope, against):
    """`flash_attention_heads_grad_tc_ref` on bf16 inputs (numpy, seeded)
    against `jax.vjp` of the JAX MHA's XLA path (fp32 on the same values)
    or against the autograd of `flash_attention_heads_ref` in bf16: each
    gradient within 2e-2 of max(1, its largest reference value); prints the
    margin."""
    rng = np.random.default_rng(s + w + heads)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    hd = w // heads
    cos, sin = _tables(s, hd) if rope else (None, None)
    kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=kv_valid)
    got = flash_attention_heads_grad_tc_ref(q, k, v, do, **kw)
    if against == "jax":
        def jax_mha(q, k, v):
            split = lambda t: t.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)
            qh, kh, vh = split(q), split(k), split(v)
            if rope:
                qh, kh = jax_rope(qh, cos, sin), jax_rope(kh, cos, sin)
            o = attention_xla(qh, kh, vh, kv_valid=kv_valid)
            return o.transpose(0, 2, 1, 3).reshape(b, s, w)

        _, vjp = jax.vjp(jax_mha, *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do.float().numpy()))]
    else:
        want = [g.float().numpy() for g in flash_attention_heads_grad_ref(q, k, v, do, **kw)]
    margins = []
    for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (b, s, w)
        err = float(np.abs(g.float().numpy() - w_).max()) / max(1.0, float(np.abs(w_).max()))
        margins.append(f"{name} {err:.2e}")
        assert err <= TC_TOL, (name, err)
    print(f"grad_tc_ref vs {against}: {', '.join(margins)} of max(1, |ref|) "
          f"(tolerance {TC_TOL})")
    if kv_valid is not None:
        assert not got[1][:, kv_valid:].any() and not got[2][:, kv_valid:].any()


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_grad_ref_matches_jax(act):
    cfg = MODEL_PRESETS["test-tiny"]
    w, hid = cfg.width, int(cfg.width * cfg.mlp_ratio)
    rng = np.random.default_rng(7)
    x, dy = (rng.standard_normal((2, 17, w)).astype(np.float32) for _ in range(2))
    k1 = (rng.standard_normal((w, hid)) / np.sqrt(w)).astype(np.float32)
    k2 = (rng.standard_normal((hid, w)) / np.sqrt(hid)).astype(np.float32)
    b1, b2 = (0.1 * rng.standard_normal(hid)).astype(np.float32), (0.1 * rng.standard_normal(w)).astype(np.float32)
    mlp = JaxMLP(cfg, act=act, use_fused=False)

    def f(x, k1, b1, k2, b2):
        return mlp.apply({"params": {"fc1": {"kernel": k1, "bias": b1},
                                     "fc2": {"kernel": k2, "bias": b2}}}, x)

    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (x, k1, b1, k2, b2)))
    dx, dk1, db1, dk2, db2 = vjp(jnp.asarray(dy))
    got = mlp_grad_ref(torch.from_numpy(x), torch.from_numpy(k1.T.copy()), torch.from_numpy(b1),
                       torch.from_numpy(k2.T.copy()), torch.from_numpy(b2),
                       torch.from_numpy(dy), act=act)
    for g, w_ in zip(got, (dx, np.asarray(dk1).T, db1, np.asarray(dk2).T, db2)):
        _close(g.numpy(), w_)


@pytest.mark.parametrize("preset", sorted(PORT_PRESETS))
def test_backward_routes_for_every_preset(preset):
    """The backward routes: every preset's bf16 tower trains on the wgmma
    kernels (K3 at its head dim, K4 at its widths), its fp32 tower on their
    split mode (K3 at any head dim and base, K4 at any width); bf16 K3 at
    head dims % 16 != 0 or unaligned bases on the same kernels through
    zero-padded copies; the CPU on the plain versions."""
    from reverso_tpu_torch.ops.attention import heads_bwd_route
    from reverso_tpu_torch.ops.fused_mlp import mlp_bwd_route

    cfg = PORT_PRESETS[preset]
    hd, hid = cfg.width // cfg.num_heads, int(cfg.width * cfg.mlp_ratio)
    assert heads_bwd_route("cuda", torch.bfloat16, hd) == "tensor_core"
    assert heads_bwd_route("cuda", torch.bfloat16, hd, aligned=False) == "tensor_core_padded"
    assert heads_bwd_route("cuda", torch.bfloat16, hd + 8) == "tensor_core_padded"
    assert heads_bwd_route("cuda", torch.float32, hd) == "split"
    assert heads_bwd_route("cuda", torch.float32, hd + 4, aligned=False) == "split"
    assert mlp_bwd_route("cuda", torch.bfloat16, cfg.width, hid) == "tensor_core"
    assert mlp_bwd_route("cuda", torch.bfloat16, cfg.width + 4, hid) == "tensor_core_padded"
    assert mlp_bwd_route("cuda", torch.float32, cfg.width, hid) == "split"
    assert mlp_bwd_route("cuda", torch.float32, cfg.width + 4, hid) == "split"
    for dtype in (torch.bfloat16, torch.float32):
        assert heads_bwd_route("cpu", dtype, hd) == "plain"
        assert mlp_bwd_route("cpu", dtype, cfg.width, hid) == "plain"


@pytest.mark.parametrize("kv,rope", [(5, True), (3, True), (4, False)])
def test_flash_heads_function_gradcheck(kv, rope):
    """The Function's backward against finite differences of its forward,
    in float64 (both the plain versions on CPU tensors)."""
    gen = torch.Generator().manual_seed(kv)
    q, k, v = (torch.randn(2, 5, 8, generator=gen, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    cos, sin = (torch.from_numpy(t) for t in _tables(5, 4)) if rope else (None, None)
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashHeadsFunction.apply(q, k, v, 2, cos, sin, 0.5, kv), (q, k, v))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_function_gradcheck(act):
    gen = torch.Generator().manual_seed(1)
    shapes = ((3, 8), (12, 8), (12,), (8, 12), (8,))
    ins = [torch.randn(*s, generator=gen, dtype=torch.float64, requires_grad=True) for s in shapes]
    assert torch.autograd.gradcheck(lambda *a: FusedMLPFunction.apply(*a, act, None), ins)


def test_cpu_entries_differentiate_their_plain_versions():
    """On CPU tensors the entries are the plain versions, which autograd
    differentiates itself: the same gradients as the plain gradients."""
    gen = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(1, 17, 64, generator=gen) for _ in range(4))
    cos, sin = _tables(17, 16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_heads(*leaves, heads=4, cos=cos, sin=sin, kv_valid=12)
    assert out.grad_fn is not None and "FlashHeads" not in type(out.grad_fn).__name__
    out.backward(do)
    ref = flash_attention_heads_grad_ref(q, k, v, do, heads=4, cos=cos, sin=sin, kv_valid=12)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)


def test_grad_on_a_device_never_falls_back():
    """Tensors neither on the CPU nor on a card (meta), under autograd: K6
    and K7 (`flash_attention`), K5 (`fused_mlp(quant=True)`,
    `fused_mlp_int8`) raise NotImplementedError naming ROADMAP item 20c;
    K3 and K4 go to their Functions and raise for want of a card, before
    any launch."""
    from reverso_tpu_torch import kernels

    m = lambda *shape: torch.empty(*shape, device="meta", requires_grad=True)
    before = dict(kernels.launches)
    with pytest.raises(NotImplementedError, match="item 20c"):
        flash_attention(m(1, 2, 5, 8), m(1, 2, 5, 8), m(1, 2, 5, 8))
    with pytest.raises(NotImplementedError, match="item 20c"):
        flash_attention(m(1, 2, 4, 8), m(1, 2, 4, 8), m(1, 2, 4, 8),
                        rel_bias=(m(1, 2, 4, 2), m(1, 2, 4, 2), 2))
    with pytest.raises(NotImplementedError, match="item 20c"):
        fused_mlp(m(3, 8), m(16, 8), m(16), m(8, 16), m(8), quant=True)
    with torch.no_grad():
        qw = quantize_mlp_weights(m(16, 8), m(16), m(8, 16), m(8), torch.float32)
    with pytest.raises(NotImplementedError, match="item 20c"):
        fused_mlp_int8(m(3, 8), qw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_heads(m(1, 5, 16), m(1, 5, 16), m(1, 5, 16), heads=2)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(m(3, 8), m(16, 8), m(16), m(8, 16), m(8))
    assert kernels.launches == before
