"""The vision tower's norm sites (`ops/norm.py::add_layernorm`) on the CPU.

`add_layernorm_ref` is held bit for bit against the sequence the tower's
blocks ran before their residual adds were fused with the next
LayerNorm (copied below as `_old_*`), on a tiny PE tower (LayerScale, an
attention pool over `ln_post`) and a tiny CLIP one (`ln_pre`, no
LayerScale, `ln_post` on the class token); the restructured tower's output
and tokens bit for bit against the old forward; the route rule: the
plain composition on the CPU, with or without grad, never counted as a
shape dispatch; and `AddLayerNormFunction`'s backward (the card's route
under autograd) against the plain composition's autograd, bit for bit, at
one site and through a tiny tower. The kernel itself is held against
`add_layernorm_ref` on the card (`tests/test_torch_cuda.py -k
add_layernorm`).
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from reverso_tpu_torch import kernels
from reverso_tpu_torch.config import MODEL_PRESETS
from reverso_tpu_torch.models import pe as tpe
from reverso_tpu_torch.models.vit import VisionTransformer
from reverso_tpu_torch.ops import norm as norm_ops
from reverso_tpu_torch.ops.norm import (AddLayerNormFunction, add_layernorm, add_layernorm_ref,
                                        norm_route)

TINY = MODEL_PRESETS["test-tiny"]
FAMILIES = {
    "pe": TINY,
    "clip": dataclasses.replace(TINY, use_rope=False, pool_type="cls", layer_scale_init=None),
}


def _tower(family: str, dtype: str, seed: int = 0) -> VisionTransformer:
    """A tiny tower with every norm's affine and LayerScale's gamma drawn
    away from their initial values, so that each site's parameters matter."""
    cfg = dataclasses.replace(FAMILIES[family], dtype=dtype)
    vt = VisionTransformer(cfg, **tpe._FAMILY_KW[family])
    gen = torch.Generator().manual_seed(seed)
    vt.init_weights(gen)
    with torch.no_grad():
        for name, p in vt.named_parameters():
            if name.endswith(("ln1.weight", "ln2.weight", "ln_pre.weight", "ln_post.weight")):
                p.copy_(1 + 0.3 * torch.randn(p.shape, generator=gen))
            elif name.endswith(("ln1.bias", "ln2.bias", "ln_pre.bias", "ln_post.bias",
                                ".gamma")):
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return vt.eval()


def _images(n: int = 3, seed: int = 1) -> torch.Tensor:
    return torch.randn(n, 32, 32, 3, generator=torch.Generator().manual_seed(seed))


# ---- the tower's sequence before the fusion, as it was ------------------------------

def _old_ln(ln, x):
    cd = ln.compute_dtype
    return F.layer_norm(x.to(cd), ln.normalized_shape, ln.weight.to(cd), ln.bias.to(cd),
                        ln.eps).to(x.dtype)


def _old_block(blk, x, rope=None, kv_valid=None):
    y = blk.attn(_old_ln(blk.ln1, x), rope, kv_valid)
    if blk.ls1 is not None:
        y = y * blk.ls1.gamma.to(y.dtype)
    x = x + y
    y = blk.mlp(_old_ln(blk.ln2, x))
    if blk.ls2 is not None:
        y = y * blk.ls2.gamma.to(y.dtype)
    return x + y


def _old_forward(vt, images):
    """VisionTransformer.forward(images, return_tokens=True) before the
    fusion (no region masks, no padded sequence)."""
    cfg = vt.cfg
    dtype = getattr(torch, cfg.dtype)
    x = images.to(dtype).permute(0, 3, 1, 2)
    conv = vt.patch_embed
    bias = None if conv.bias is None else conv.bias.to(dtype)
    x = F.conv2d(x, conv.weight.to(dtype), bias, stride=conv.stride).flatten(2).transpose(1, 2)
    b = x.shape[0]
    if vt.cls_token is not None:
        x = torch.cat([vt.cls_token.to(dtype).expand(b, 1, cfg.width), x], 1)
    if vt.pos_embed is not None:
        x = x + vt.pos_embed.to(dtype)
    if vt.ln_pre is not None:
        x = _old_ln(vt.ln_pre, x)
    rope = vt._rope(x.shape[1], x.device) if cfg.use_rope else None
    for blk in vt.blocks:
        x = _old_block(blk, x, rope)
    tokens = x
    if cfg.pool_type == "attn":
        pooled = vt.attn_pool(_old_ln(vt.ln_post, tokens) if vt.ln_post is not None else tokens)
    else:
        pooled = tokens[:, 0, :]
        if vt.ln_post is not None:
            pooled = _old_ln(vt.ln_post, pooled)
    return vt.proj(pooled), tokens


# ---- add_layernorm_ref against the old sequence -----------------------------------

@pytest.mark.parametrize("family", ["pe", "clip"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ref_is_the_old_block_sequence(family, dtype):
    """Each site's plain composition reproduces the old block bit for bit:
    attention's residual with ls1 and ln2, then the MLP's with ls2 (and
    ln1 of the next block: the same sites)."""
    vt = _tower(family, dtype)
    blk = vt.blocks[0]
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 17, vt.cfg.width, generator=gen).to(dt)
    with torch.no_grad():
        want = _old_block(blk, x)
        _, h = add_layernorm_ref(x, None, blk.ln1.weight, blk.ln1.bias, eps=blk.ln1.eps)
        assert torch.equal(h, _old_ln(blk.ln1, x))
        y = blk.attn(h)
        ls1 = None if blk.ls1 is None else blk.ls1.gamma
        r, h = add_layernorm_ref(x, y, blk.ln2.weight, blk.ln2.bias, gamma=ls1, eps=blk.ln2.eps)
        assert (blk.ls1 is None) == (family == "clip")
        y = blk.mlp(h)
        ls2 = None if blk.ls2 is None else blk.ls2.gamma
        nxt = vt.blocks[1].ln1
        r2, h2 = add_layernorm_ref(r, y, nxt.weight, nxt.bias, gamma=ls2, eps=nxt.eps)
        assert r2.dtype == dt and torch.equal(r2, want)
        assert torch.equal(h2, _old_ln(nxt, want))
        # the block's sublayers from ln1's h, with the end's add, keep its result
        xs, ys = blk.sublayers(x, _old_ln(blk.ln1, x))
        assert torch.equal(add_layernorm_ref(xs, ys, nxt.weight, nxt.bias, gamma=ls2,
                                             eps=nxt.eps)[0], want)


@pytest.mark.parametrize("family", ["pe", "clip"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tower_unchanged_bit_for_bit(family, dtype):
    """The restructured forward (each block's end fused with the next norm
    site, PE's last with ln_post over every token) gives the old output and
    `return_tokens` tokens, bit for bit."""
    vt = _tower(family, dtype, seed=4)
    imgs = _images()
    with torch.inference_mode():
        want_out, want_tokens = _old_forward(vt, imgs)
        out, tokens = vt(imgs, return_tokens=True)
    assert torch.equal(out, want_out)
    assert torch.equal(tokens, want_tokens)


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 40), (0, 8)])
def test_add_layernorm_shapes_and_modes(shape):
    """On the CPU `add_layernorm` is its plain version in every mode: r is
    x itself without y; the scaled add rounds gamma * y to the activation
    dtype before the add."""
    gen = torch.Generator().manual_seed(7)
    x, y = (torch.randn(*shape, generator=gen).bfloat16() for _ in range(2))
    w, b, g = (torch.randn(shape[-1], generator=gen) for _ in range(3))
    r, h = add_layernorm(x, None, w, b)
    assert r is x and h.shape == x.shape and h.dtype == x.dtype
    r, h = add_layernorm(x, y, w, b, gamma=g)
    assert torch.equal(r, x + y * g.bfloat16())
    rr, hh = add_layernorm_ref(x, y, w, b, gamma=g)
    assert torch.equal(r, rr) and torch.equal(h, hh)


def test_route_is_plain_on_cpu_and_under_grad():
    """The route depends only on what the call observes: the CPU takes the
    plain composition, in grad mode too, and is never counted as a shape
    dispatch, with or without inputs that require grad."""
    x = torch.randn(4, 64)
    assert norm_route(x, None, torch.float32) == "plain"
    before = dict(kernels.plain_dispatches)
    launches = kernels.launches["add_layernorm"]
    w = torch.ones(64, requires_grad=True)
    b = torch.zeros(64, requires_grad=True)
    with torch.enable_grad():
        assert torch.is_grad_enabled()
        r, h = add_layernorm(x, torch.randn(4, 64), w, b, gamma=torch.full((64,), 0.1))
        h.sum().backward()
    assert w.grad is not None and b.grad is not None
    with torch.no_grad():
        add_layernorm(x, None, w, b)
    assert kernels.plain_dispatches == before
    assert kernels.plain_dispatches["norm_shape"] == before["norm_shape"]
    assert kernels.launches["add_layernorm"] == launches


def _leaves(mode, dtype, seed=11):
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (3 * torch.randn(2, 9, 64, generator=gen)).to(dt).requires_grad_()
    y = None if mode == "norm" else torch.randn(2, 9, 64, generator=gen).to(dt).requires_grad_()
    w = (1 + 0.3 * torch.randn(64, generator=gen)).requires_grad_()
    b = (0.2 * torch.randn(64, generator=gen)).requires_grad_()
    g = (0.1 * torch.randn(64, generator=gen)).requires_grad_() if mode == "scaled" else None
    return [x, y, w, b, g]


@pytest.mark.parametrize("mode", ["norm", "residual", "scaled"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_function_grads_are_the_plain_ones(mode, dtype):
    """`AddLayerNormFunction` (on CPU tensors its forward is the plain
    composition) gives r, h and the gradient of every input of the plain
    composition's autograd, bit for bit, with r used past the site as the
    next residual."""
    grads, outs = [], []
    for fused in (False, True):
        x, y, w, b, g = leaves = _leaves(mode, dtype)
        with torch.enable_grad():
            if fused:
                out = AddLayerNormFunction.apply(x, y, w, b, g, 1e-5)
                r, h = (x, out) if y is None else out
            else:
                r, h = add_layernorm_ref(x, y, w, b, gamma=g)
            dr, dh = torch.randn(2, *r.shape, generator=torch.Generator().manual_seed(5))
            ((r.float() * dr).sum() + (h.float() * dh).sum()).backward()
        outs.append((r.detach(), h.detach()))
        grads.append([None if t is None else t.grad for t in leaves])
    assert all(torch.equal(a, c) for a, c in zip(*outs))
    for a, c in zip(*grads):
        assert (a is None) == (c is None)
        assert a is None or (a.dtype == c.dtype and torch.equal(a, c))


def test_training_tower_grads_unchanged(monkeypatch):
    """Under autograd the tower's loss and every gradient equal the old
    sequence's bit for bit (bf16, PE): on the CPU's plain composition, and
    through `AddLayerNormFunction` at every site, as the card routes them."""
    vt = _tower("pe", "bfloat16", seed=8)
    imgs = _images(2, seed=9)
    grads = []

    calls = []
    apply = AddLayerNormFunction.apply

    def fused():
        with monkeypatch.context() as m:
            m.setattr(norm_ops, "norm_route", lambda *a: "kernel")
            m.setattr(AddLayerNormFunction, "apply", lambda *a: calls.append(1) or apply(*a))
            return vt(imgs)

    for fwd in (lambda: _old_forward(vt, imgs)[0], lambda: vt(imgs), fused):
        vt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            fwd().float().square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in vt.named_parameters() if p.grad is not None})
    # ln1, ln2, each end (the last with ln_post), the pool's norm
    assert len(calls) == 2 * vt.cfg.depth + 2
    for other in grads[1:]:
        assert grads[0].keys() == other.keys() and grads[0]
        assert all(torch.equal(grads[0][n], other[n]) for n in grads[0])


def test_norm_roofline_reader(monkeypatch):
    """`benchmark/metrics/norm_roofline.embed.py`: each launch's unavoidable
    bytes (x, y read and r, h written with a residual; x read and h written
    without; the fp32 norm parameters and gamma) over the HBM rate, over
    the `add_layernorm` kernels' device time; nothing to read (a program
    without the fused pass) gives None."""
    import os

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    monkeypatch.syspath_prepend(bench)
    from harness.cell import load_module
    from harness.trace import Readings

    reader = load_module(os.path.join(bench, "metrics", "norm_roofline.embed.py"),
                         "norm_roofline_embed_under_test")
    t, w = 64 * 577, 1024
    shapes = {("add_layernorm", (t, w, "bfloat16", True, True)): 24,
              ("add_layernorm", (t, w, "bfloat16", True, False)): 24,
              ("add_layernorm", (t, w, "bfloat16", False, False)): 1,
              ("fused_mlp_tc", (t, w, 4096, "gelu")): 24}
    least_s = (24 * (t * w * 8 + 3 * w * 4) + 24 * (t * w * 8 + 2 * w * 4)
               + (t * w * 4 + 2 * w * 4)) / 3.35e12
    ops = [("void rv::norm::add_layernorm_kernel<__nv_bfloat16, 4, true, true>", 0.0, 4e-3),
           ("void rv::norm::add_layernorm_kernel<__nv_bfloat16, 4, false, false>", 4e-3, 6e-3),
           ("void rv::mlp_tc::fused_mlp_wgmma_kernel", 6e-3, 9e-3)]
    r = Readings(None, 1.0, 9e-3, ops, {}, shapes, {}, {}, True)
    assert abs(reader.read(r) - 100.0 * least_s / 6e-3) <= 1e-9
    parent = Readings(None, 1.0, 9e-3, ops[2:], {}, {k: v for k, v in shapes.items()
                                                     if k[0] != "add_layernorm"}, {}, {}, True)
    assert reader.read(parent) is None
