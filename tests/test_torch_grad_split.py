"""The fp32 backward routes' plain versions on the CPU.

K3's and K4's fp32 gradients on the card run the tensor-core kernels'
split mode (three bf16 parts a value, six products; `csrc/
flash_heads_bwd_tc.cu`, `csrc/fused_mlp_bwd.cu`). Their arithmetic is
spelled out by `flash_attention_heads_grad_split_ref` and
`mlp_grad_split_ref`, which these tests hold against `jax.vjp` of the JAX
package's XLA paths (RoPE by `apply_rope_2d`, then `attention_xla`; the
flax MLP with `use_fused=False`) and against the autograd of the port's
fp32 plain forwards, on the same seeded numpy inputs. The split forward's
plain log-sum-exp, which the backward reads, is held against a plain
`logsumexp` of the fp32 scores. The kernels themselves run on the card
only (tests/test_torch_cuda.py).
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
from reverso_tpu_torch.ops.attention import (flash_attention_heads_grad_ref,
                                              flash_attention_heads_grad_split_ref,
                                              flash_attention_heads_split_ref)
from reverso_tpu_torch.ops.fused_mlp import mlp_grad_ref, mlp_grad_split_ref
from reverso_tpu_torch.ops.rope import rope_2d_tables, rotate

# fp32 on both sides, sums in another order (the split products carry
# fp32's 24 bits, the dropped part products lie below 2^-23 of each
# product): within 2e-5 of max(1, the largest reference gradient)
TOL = 2e-5


def _close(name, out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, name
    err = float(np.abs(out - ref).max()) / max(1.0, float(np.abs(ref).max()))
    assert err <= tol, (name, err)
    return err


def _tables(s: int, hd: int):
    """RoPE tables for s tokens: a class token and a g x g grid, identity
    rows past it (the padded-sequence mode)."""
    g = max(1, int(np.sqrt(s - 1)))
    cos, sin = rope_2d_tables(g, hd, cls_token=True)
    pad = max(0, s - cos.shape[0])
    cos = np.concatenate([cos, np.ones((pad, hd), np.float32)])[:s]
    sin = np.concatenate([sin, np.zeros((pad, hd), np.float32)])[:s]
    return cos, sin


HEADS_CASES = [
    (2, 17, 64, 4, None),      # test-tiny: hd 16
    (1, 37, 288, 4, 23),       # hd 72 (padded to 80 by the prep), kv_valid < S
    (1, 37, 192, 2, None),     # hd 96 (PE-G14's head dim)
    (1, 577, 64, 1, 300),      # one head of PE-L14 at S = 577, kv_valid < S
]


@pytest.mark.parametrize("against", ["jax", "autograd"])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("b,s,w,heads,kv_valid", HEADS_CASES)
def test_heads_grad_split_ref(b, s, w, heads, kv_valid, rope, against):
    """`flash_attention_heads_grad_split_ref` on fp32 inputs against
    `jax.vjp` of the JAX MHA's XLA path, or against the autograd of
    `flash_attention_heads_ref` in fp32: each gradient within TOL of
    max(1, its largest reference value); keys past kv_valid get none."""
    rng = np.random.default_rng(s + w + heads)
    q, k, v, do = (rng.standard_normal((b, s, w)).astype(np.float32) for _ in range(4))
    hd = w // heads
    cos, sin = _tables(s, hd) if rope else (None, None)
    kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=kv_valid)
    got = flash_attention_heads_grad_split_ref(*(torch.from_numpy(t) for t in (q, k, v, do)),
                                               **kw)
    if against == "jax":
        def jax_mha(q, k, v):
            split = lambda t: t.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)
            qh, kh, vh = split(q), split(k), split(v)
            if rope:
                qh, kh = jax_rope(qh, cos, sin), jax_rope(kh, cos, sin)
            o = attention_xla(qh, kh, vh, kv_valid=kv_valid)
            return o.transpose(0, 2, 1, 3).reshape(b, s, w)

        _, vjp = jax.vjp(jax_mha, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    else:
        want = [g.numpy() for g in flash_attention_heads_grad_ref(
            *(torch.from_numpy(t) for t in (q, k, v, do)), **kw)]
    errs = []
    for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == (b, s, w)
        errs.append(f"{name} {_close(name, g.numpy(), w_):.2e}")
    print(f"grad_split_ref vs {against}: {', '.join(errs)} of max(1, |ref|) (tolerance {TOL})")
    if kv_valid is not None:
        assert not got[1][:, kv_valid:].any() and not got[2][:, kv_valid:].any()


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("b,s,w,heads,kv_valid", HEADS_CASES)
def test_split_forward_lse(b, s, w, heads, kv_valid, rope):
    """The split forward's plain log-sum-exp (base 2, [B * heads, S], the
    kernel's `lse` output) against `logsumexp` of the fp32 scores of the
    rotated, scaled q and the rotated k, over the valid keys; the output
    the same as without it."""
    rng = np.random.default_rng(s + w)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32))
               for _ in range(3))
    hd = w // heads
    cos, sin = _tables(s, hd) if rope else (None, None)
    kw = dict(heads=heads, cos=cos, sin=sin, kv_valid=kv_valid)
    o, lse = flash_attention_heads_split_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, flash_attention_heads_split_ref(q, k, v, **kw))
    split = lambda t: t.reshape(b, s, heads, hd).transpose(1, 2)
    qh, kh = split(q), split(k)
    scale = hd ** -0.5
    if rope:
        qh, kh = rotate(qh, cos, sin, scale), rotate(kh, cos, sin)
    else:
        qh = qh * scale
    sc = torch.matmul(qh, kh.transpose(-1, -2))
    kv = s if kv_valid is None else kv_valid
    want = torch.logsumexp(sc[..., :kv], dim=-1).reshape(b * heads, s) / np.log(2.0)
    assert lse.shape == (b * heads, s) and lse.dtype == torch.float32
    _close("lse", lse.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("against", ["jax", "autograd"])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_grad_split_ref(act, against):
    """`mlp_grad_split_ref` (the split products of z and dY W2, act' in
    fp32, the three weight products and the sums) on test-tiny's widths in
    fp32 against `jax.vjp` of the flax MLP's XLA path, or against the
    autograd of `mlp_ref`: (dx, dW1, db1, dW2, db2) each within TOL."""
    cfg = MODEL_PRESETS["test-tiny"]
    w, hid = cfg.width, int(cfg.width * cfg.mlp_ratio)
    rng = np.random.default_rng(11)
    x, dy = (rng.standard_normal((2, 17, w)).astype(np.float32) for _ in range(2))
    k1 = (rng.standard_normal((w, hid)) / np.sqrt(w)).astype(np.float32)
    k2 = (rng.standard_normal((hid, w)) / np.sqrt(hid)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hid)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(w)).astype(np.float32)
    ins = [torch.from_numpy(t) for t in (x.reshape(-1, w), k1.T.copy(), b1, k2.T.copy(), b2)]
    got = mlp_grad_split_ref(*ins, torch.from_numpy(dy.reshape(-1, w)), act=act)
    if against == "jax":
        mlp = JaxMLP(cfg, act=act, use_fused=False)

        def f(x, k1, b1, k2, b2):
            return mlp.apply({"params": {"fc1": {"kernel": k1, "bias": b1},
                                         "fc2": {"kernel": k2, "bias": b2}}}, x)

        _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (x, k1, b1, k2, b2)))
        dx, dk1, db1, dk2, db2 = vjp(jnp.asarray(dy))
        want = (np.asarray(dx).reshape(-1, w), np.asarray(dk1).T, db1, np.asarray(dk2).T, db2)
    else:
        want = [g.numpy() for g in mlp_grad_ref(*ins, torch.from_numpy(dy.reshape(-1, w)),
                                                act=act)]
    errs = [f"{n} {_close(n, g.numpy(), w_):.2e}"
            for n, g, w_ in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want)]
    print(f"mlp_grad_split_ref vs {against}: {', '.join(errs)} (tolerance {TOL})")


def test_split_ref_is_not_one_bf16_pass():
    """The split plain versions carry fp32's precision: one bf16 pass of
    the same products (every operand rounded to bf16 once) lands far
    outside TOL, so the tests above can tell the two apart."""
    rng = np.random.default_rng(3)
    b, s, w, heads = 1, 37, 64, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32))
                   for _ in range(4))
    got = flash_attention_heads_grad_split_ref(q, k, v, do, heads=heads)
    bf = [t.to(torch.bfloat16).float() for t in (q, k, v, do)]
    one_pass = flash_attention_heads_grad_ref(*bf, heads=heads)
    err = max(float((g - o).abs().max()) for g, o in zip(got, one_pass))
    assert err > 10 * TOL, err
