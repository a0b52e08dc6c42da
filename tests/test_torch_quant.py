"""The port's int8 embedding tower (`ModelConfig.quant="int8"`) against the
JAX package's.

The quantizers are held bit for bit. The int8 MLP's plain version
(`mlp_int8_ref`, the contract the CUDA kernel K5 computes) is held against
the JAX package's `fused_mlp(quant=True)` in interpret mode, and the int8
tower against the JAX tower with its MLP forced onto the fused path (on
the CPU the JAX tower ignores `quant` otherwise), as tests/test_vit.py
does.

A stated divergence: the port rounds after every multiply and add of the
dequantization and of the gelu polynomial (the contract of the TPU kernel
and of csrc/fused_mlp.cu). XLA's CPU compiler contracts
`f32(s32) * scale + b1` and the polynomial's steps into FMAs, so the JAX
package's CPU values differ from the contract in the last bit for about
30% of the hidden activations; where such a bit sits at a rounding
boundary of the hidden re-quantization, one int8 quantum flips, and the
flip moves the whole output row. At 1000 rows that happens in 0-2 rows.
"""
import dataclasses
import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from reverso_tpu.config import MODEL_PRESETS, StoreConfig, default_config
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu.models.pe import PerceptionEncoder as JaxEncoder
from reverso_tpu.ops import quant as jquant
from reverso_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from reverso_tpu_torch.engine import Reverso
from reverso_tpu_torch.models.pe import PerceptionEncoder
from reverso_tpu_torch.ops import quant as tquant
from reverso_tpu_torch.ops.fused_mlp import (Int8MLPWeights, _kernel_weights, fused_mlp,
                                             fused_mlp_int8, mlp_int8_plain, mlp_int8_ref,
                                             quantize_mlp_weights)

TINY = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
# width 160: a 640-wide hidden layer, so a second, partial 512-wide chunk
WIDE = dataclasses.replace(TINY, width=160, num_heads=4)


@contextmanager
def jax_fused_mlp_forced():
    """The JAX tower's MLP on its fused path (interpret mode on the CPU),
    the only path that reads `quant`; the package is not edited."""
    import reverso_tpu.models.vit as vitmod

    orig = vitmod.MLP
    vitmod.MLP = lambda cfg, act="gelu", use_fused=None, **kw: orig(
        cfg, act=act, use_fused=True, **kw)
    try:
        yield
    finally:
        vitmod.MLP = orig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,scale", [((96, 384), 1.0), ((160, 640), 1e-3),
                                         ((7, 33), 50.0)])
def test_quantizers_bit_for_bit(shape, scale):
    """quantize_weight_int8 and quantize_rows_int8 equal the JAX package's
    bit for bit (values, then scales), including an all-zero unit.

    A stated divergence: under jit, XLA compiles the weight scale's
    `amax / 127.0` as `amax * f32(1 / 127)`, an ulp off for a few percent
    of the units; the port divides, as the source and the eager call do.
    The int8 values agree either way."""
    rng = np.random.default_rng(shape[0])
    w = (rng.standard_normal(shape) * scale).astype(np.float32)   # JAX [in, out]
    w[:, 3] = 0.0
    j8, js = map(np.asarray, jquant.quantize_weight_int8(jnp.asarray(w)))
    t8, ts = tquant.quantize_weight_int8(_t(w.T))
    np.testing.assert_array_equal(t8.numpy().T, j8)
    np.testing.assert_array_equal(ts.numpy(), js[0])
    jj8, jjs = map(np.asarray, jax.jit(jquant.quantize_weight_int8)(jnp.asarray(w)))
    np.testing.assert_array_equal(t8.numpy().T, jj8)
    live = np.abs(w).max(0) > 0
    np.testing.assert_array_equal(jjs[0][live], np.abs(w).max(0)[live] * np.float32(1 / 127))
    assert (np.abs(ts.numpy() - jjs[0])[live] <= np.spacing(ts.numpy())[live]).all()
    x = (rng.standard_normal((50,) + shape[1:]) * rng.uniform(1e-3, 10, (50, 1))
         * scale).astype(np.float32)
    x[2] = 0.0
    j8, js = map(np.asarray, jax.jit(jquant.quantize_rows_int8)(jnp.asarray(x)))
    t8, ts = tquant.quantize_rows_int8(_t(x))
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("t,w,out", [(40, 96, 64), (5, 48, 24)])
def test_int8_linear_matches_jax(t, w, out):
    """int8_linear: exact s32 dots, so only the f32 dequantization and the
    bias add can differ, by an ulp (XLA contracts them into an FMA)."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, w)).astype(np.float32)
    wk = (rng.standard_normal((w, out)) * w ** -0.5).astype(np.float32)
    b = rng.standard_normal(out).astype(np.float32)
    w8, ws = jquant.quantize_weight_int8(jnp.asarray(wk))
    ref = np.asarray(jquant.int8_linear(jnp.asarray(x), w8, ws, jnp.asarray(b)))
    t8, ts = tquant.quantize_weight_int8(_t(wk.T))
    got = tquant.int8_linear(_t(x), t8, ts, _t(b)).numpy()
    assert got.shape == (t, out) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    got_nb = tquant.int8_linear(_t(x), t8, ts).numpy()
    ref_nb = np.asarray(jquant.int8_linear(jnp.asarray(x), w8, ws))
    np.testing.assert_array_equal(got_nb, ref_nb)


def _mlp_case(seed, t, w, hid):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, w)).astype(np.float32)
    w1 = (rng.standard_normal((w, hid)) * w ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(hid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((hid, w)) * hid ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(w) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("hid,w,act,seed", [
    (384, 96, "gelu", 0), (640, 96, "gelu", 0), (1152, 160, "gelu", 1),
    (640, 160, "quick_gelu", 2)])
def test_mlp_int8_ref_matches_jax(hid, w, act, seed):
    """mlp_int8_ref against JAX fused_mlp(quant=True, interpret=True) over
    1000 rows, with the quantization-aware bound: under 0.2% of elements
    beyond 1e-5 (+1e-5 relative), and none beyond two hidden quanta as
    they reach the output (2 * max hs * max |W2 dequantized|: one
    re-quantization flip moves an output by hs * w2). A wrong scale or
    chunk slice perturbs most rows and blows both bounds."""
    x, w1, b1, w2, b2 = _mlp_case(seed, 1000, w, hid)
    ref = np.asarray(jax_fused_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)), act=act,
                                   quant=True, interpret=True))
    got = mlp_int8_ref(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2), act=act).numpy()
    diff = np.abs(got - ref)
    loose = diff > 1e-5 + 1e-5 * np.abs(ref)
    assert loose.mean() < 0.002, f"{loose.mean():.4f} of elements differ"
    qw = quantize_mlp_weights(_t(w1.T), _t(b1), _t(w2.T), _t(b2), torch.float32)
    h_amax = 0.0
    x8, xs = tquant.quantize_rows_int8(_t(x))
    for lo in range(0, hid, 512):
        h = (tquant.int_dot(x8, qw.w1[lo:lo + 512]).float() * (xs * qw.s1[lo:lo + 512])
             + qw.b1[lo:lo + 512])
        h_amax = max(h_amax, float(h.abs().max()) * 1.2)   # >= any activation's amax
    w2_max = float((qw.w2.float().abs() * qw.s2[:, None]).max())
    bound = 2 * (h_amax / 127) * w2_max
    if loose.any():
        assert diff[loose].max() <= bound, (diff[loose].max(), bound)
    # and it is the documented int8 approximation of the exact MLP
    from reverso_tpu.ops.fused_mlp import mlp_xla
    exact = np.asarray(mlp_xla(*map(jnp.asarray, (x, w1, b1, w2, b2)), act=act))
    rel = np.abs(got - exact).mean() / np.abs(exact).mean()
    assert rel < 5e-2, rel


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_quant_wrappers_on_cpu(act):
    """fused_mlp(quant=True) and fused_mlp_int8 with weights quantized once
    run the plain version on CPU tensors: equal to mlp_int8_ref, leading
    dims kept; bf16 activations quantize the bf16-rounded weights."""
    x, w1, b1, w2, b2 = _mlp_case(3, 24, 96, 640)
    args = (_t(x).reshape(2, 12, 96), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    ref = mlp_int8_ref(*args, act=act)
    assert ref.shape == (2, 12, 96)
    assert torch.equal(fused_mlp(*args, act=act, quant=True), ref)
    qw = quantize_mlp_weights(*args[1:], torch.float32)
    assert torch.equal(fused_mlp_int8(args[0], qw, act=act), ref)
    xb = args[0].to(torch.bfloat16)
    qb = quantize_mlp_weights(*args[1:], torch.bfloat16)
    assert torch.equal(qb.w1, tquant.quantize_weight_int8(args[1].to(torch.bfloat16))[0])
    out = fused_mlp_int8(xb, qb, act=act)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, mlp_int8_ref(xb, *args[1:], act=act))


def _jax_tower(cfg, imgs, seed):
    jenc = JaxEncoder(cfg, seed=seed, use_flash=True)
    params = jax.tree_util.tree_map(np.asarray, jenc.params)
    with jax_fused_mlp_forced():
        j8 = JaxEncoder(cfg, params=jenc.params, use_flash=True, quant="int8")
        ref8 = np.asarray(j8.encode_image(imgs))
    return params, np.asarray(jenc.encode_image(imgs)), ref8


@pytest.mark.parametrize("cfg", [TINY, WIDE], ids=["tiny", "width160"])
def test_int8_tower_matches_jax(cfg):
    """The port's int8 tower against the JAX tower on its fused int8 path,
    fp32 activations, the same weights: normalized embeddings within 2e-4
    (rare hidden-quantum flips, see the module docstring), cosine >=
    0.99999; both differ visibly from the exact towers."""
    imgs = np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(np.float32)
    params, ref, ref8 = _jax_tower(cfg, imgs, seed=2)
    tenc = PerceptionEncoder(cfg, params=params, device="cpu", quant="int8")
    assert tenc.cfg.quant == "int8"
    out8 = tenc.encode_image(imgs)
    err = float(np.abs(out8 - ref8).max())
    assert err <= 2e-4, err
    assert float((out8 * ref8).sum(1).min()) >= 0.99999
    exact = PerceptionEncoder(cfg, params=params, device="cpu").encode_image(imgs)
    assert np.abs(exact - ref).max() <= 1e-5
    assert np.abs(out8 - exact).max() > 10 * err     # the knob switched paths
    assert float((out8 * exact).sum(1).min()) >= 0.99


def test_int8_tower_state_dict_is_the_bf16_towers():
    """quant changes the compute, not the parameters: the same state dict
    (names, shapes, values) and no cached weights in it after a forward."""
    a = PerceptionEncoder(MODEL_PRESETS["test-tiny"], seed=4, device="cpu")
    b = PerceptionEncoder(MODEL_PRESETS["test-tiny"], seed=4, device="cpu", quant="int8")
    b.encode_image(np.zeros((1, 32, 32, 3), np.float32))
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    mlp = b.module.blocks[0].mlp
    assert mlp.quant and len(mlp._int8) == 1
    with torch.no_grad():     # a parameter update re-quantizes
        mlp.fc1.weight.mul_(2.0)
    b.encode_image(np.zeros((1, 32, 32, 3), np.float32))
    assert len(mlp._int8) == 1 and torch.equal(
        next(iter(mlp._int8.values())).w1,
        tquant.quantize_weight_int8(mlp.fc1.weight.to(torch.bfloat16))[0])


def test_int8_engine_build_matches_jax(tmp_path):
    """EngineConfig(model=replace(..., quant="int8")) reaches the int8 MLP
    through the engine's own encoder: a direct-embed build of the same
    folder in both packages gives rows within 2e-4 and the same search
    ids."""
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for j in range(10):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
            folder / f"im_{j:02d}.png")
    cfg8 = dataclasses.replace(TINY, quant="int8")
    params = jax.tree_util.tree_map(np.asarray, JaxEncoder(cfg8, seed=0).params)

    def config(name):
        return default_config().replace(
            model=cfg8, store=StoreConfig(root_dir=str(tmp_path / name), dtype="float32"))

    with jax_fused_mlp_forced():
        jeng = JaxReverso(config("jax"), encoder=JaxEncoder(cfg8, params=params))
        assert "ready for searching" in jeng.create_database(str(folder), "db",
                                                             use_direct_pe=True)
        jeng.load_database("db")
        jq = np.stack([np.asarray(jeng.process_image_direct_pe(
            Image.open(folder / f"im_{j:02d}.png"))[0])[0] for j in (0, 3, 7)])
    port = Reverso(config("port"), device="cpu")
    port._encoder = PerceptionEncoder(cfg8, params=params, device="cpu")
    assert "ready for searching" in port.create_database(str(folder), "db",
                                                         use_direct_pe=True)
    port.load_database("db")
    assert all(blk.mlp.quant for blk in port.encoder.module.blocks)
    tq = np.stack([port.process_image_direct_pe(
        Image.open(folder / f"im_{j:02d}.png"))[0][0] for j in (0, 3, 7)])
    assert np.abs(tq - jq).max() <= 2e-4
    js, ji = map(np.asarray, jeng.search_batch(jq, 5))
    ts, ti = port.search_batch(jq, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=2e-4)
    assert ti[:, 0].tolist() == [0, 3, 7]
    names = lambda e: [p["filename"] for p in e._store.payloads(list(range(10)))]
    assert names(port) == names(jeng)


@pytest.mark.parametrize("t,w,hid,act", [
    (37, 72, 200, "gelu"),            # W and H padded to 80 and 208
    (9, 72, 200, "quick_gelu"),
    (5, 1536, 8960, "gelu"),          # PE-G14: a partial last chunk, nothing padded
])
def test_kernel_weight_layout_is_exact(t, w, hid, act):
    """K5's weight layout (`_kernel_weights`: K zero-padded to whole 16-byte
    rows, what TMA reads) computes the same function: the padded weights,
    with x zero-padded to match and the hidden units past H given zero
    scale and bias (the zeros the kernel reads there), give the plain
    version's output bit for bit. At widths that are multiples of 16 (every
    preset's) the weights are the quantized ones, not copies."""
    rng = np.random.default_rng(t)
    randn = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(torch.bfloat16)
    x = randn(t, w)
    qw = quantize_mlp_weights(randn(hid, w, scale=w ** -0.5), randn(hid, scale=0.1),
                              randn(w, hid, scale=hid ** -0.5), randn(w, scale=0.1),
                              torch.bfloat16)
    w1p, w2p = _kernel_weights(qw)
    wp, hp = -(-w // 16) * 16, -(-hid // 16) * 16
    assert w1p.shape == (hid, wp) and w2p.shape == (w, hp)
    assert w1p.dtype == w2p.dtype == torch.int8
    assert w1p.is_contiguous() and w2p.is_contiguous()
    assert torch.equal(w1p[:, :w], qw.w1) and not w1p[:, w:].any()
    assert torch.equal(w2p[:, :hid], qw.w2) and not w2p[:, hid:].any()
    if (wp, hp) == (w, hid):
        assert w1p.data_ptr() == qw.w1.data_ptr() and w2p.data_ptr() == qw.w2.data_ptr()
    pad = lambda a, n: torch.nn.functional.pad(a, (0, n - a.shape[-1]))
    padded = Int8MLPWeights(torch.nn.functional.pad(w1p, (0, 0, 0, hp - hid)),
                            pad(qw.s1, hp), pad(qw.b1, hp), w2p, qw.s2, qw.b2)
    ref = mlp_int8_plain(x, qw, act)
    out = mlp_int8_plain(pad(x, wp), padded, act)
    assert out.shape == (t, w) and torch.equal(out, ref)
