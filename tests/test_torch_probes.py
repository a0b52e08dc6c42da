"""The hardware probes (`reverso_tpu_torch/probes/`, P1-P5) against the TPU
probes under `scripts/` they port, on the CPU.

Each script's own Pallas kernel runs in interpret mode: `pallas_call` is
monkeypatched to record the kernel and its call and to add
`interpret=True`. Where a script hides its kernel inside a timing loop
(`bench_dma`, `bench_mxu`, `bench_deformable`), the recorder stops the
script at its first `pallas_call` and the test calls the recorded kernel on
seeded inputs itself (`bench_dma` feeds zeros); where it reads module
globals (`bench_scan_overlap`), the test patches them to a tiny shape. The
port's plain version (the CPU path of each probe's function) is held
against each recorded output: exactly for the max (P1), int8 (P2, P4) and
gather (P5) reductions, within a stated tolerance for bf16 / fp32 sums.
The kernels themselves run on the card (tests/test_torch_cuda.py,
`chip_smoke.py` phase H).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from reverso_tpu_torch import kernels
from reverso_tpu_torch import probes
from reverso_tpu_torch.probes import bench_deformable as p5
from reverso_tpu_torch.probes import bench_dma as p1
from reverso_tpu_torch.probes import bench_mxu as p2
from reverso_tpu_torch.probes import bench_scan_overlap as p3
from reverso_tpu_torch.probes import proto_dyn_dma as p4

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
REAL_PALLAS_CALL = pl.pallas_call


class Recorded(Exception):
    """Raised by the recorder to stop a script at its first pallas_call."""


def _script(name):
    """A fresh instance of scripts/<name>.py (its globals unshared)."""
    spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def recorder(monkeypatch):
    """pallas_call recording (kernel, keyword arguments) and adding
    interpret=True; with `.stop = True`, it raises `Recorded` instead of
    building the call."""
    calls = []

    def record(kernel, **kw):
        kw["interpret"] = True
        calls.append((kernel, kw))
        if record.stop:
            raise Recorded()
        return REAL_PALLAS_CALL(kernel, **kw)

    record.stop = False
    record.calls = calls
    monkeypatch.setattr(pl, "pallas_call", record)
    return record


def _bf16(rng, *shape):
    """Seeded normal values rounded to bf16: the same numbers on both sides."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("n_rows,tile,bufs,streams", [(256, 32, 4, 2), (512, 64, 2, 1),
                                                      (200, 32, 8, 4)])
def test_p1_stream_max_matches_bench_dma_kernel(recorder, n_rows, tile, bufs, streams):
    """P1: the script's ring kernel, recorded and called on seeded rows
    instead of its zeros, against `stream_max` on the CPU, exactly (a max of
    bf16 values); 200 rows leave a partial tile unread on both sides."""
    recorder.stop = True
    with pytest.raises(Recorded):
        _script("bench_dma").bench(n_rows, tile, bufs, streams)
    kernel, kw = recorder.calls[0]
    db_t, db_j = _bf16(np.random.default_rng(1), n_rows, 1024)
    want = np.asarray(REAL_PALLAS_CALL(kernel, **kw)(db_j))
    got = p1.stream_max(db_t, tile, bufs, streams)
    assert got.dtype == torch.float32 and got.shape == (8, 1024)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,iters", [("int8", 1), ("int8", 4), ("int8", 9),
                                         ("bfloat16", 1), ("bfloat16", 2),
                                         ("float32", 1), ("float32", 2)])
def test_p2_mxu_matches_bench_mxu_kernel(recorder, dtype, iters):
    """P2: the script's kernel (A changed every step) against `mxu` on the
    CPU. int8 bit for bit: a xor 1 alternates, as the port's a'. bf16 and
    fp32 at iters <= 2, where the script's a + 1 every step and the port's
    alternation are one function, within 2^-18 x iters x max(|a| @ |b|):
    fp32 sums of K products in another order, and for fp32 the split's
    dropped products (each below 2^-32 of |a||b|)."""
    recorder.stop = True
    acc = jnp.int32 if dtype == "int8" else jnp.float32
    jdt = "int8" if dtype == "int8" else getattr(jnp, dtype)
    _script("bench_mxu").bench(64, 128, 256, jdt, acc, iters=iters)   # prints FAILED: recorded
    kernel, kw = recorder.calls[0]
    rng = np.random.default_rng(2)
    if dtype == "int8":
        a = rng.integers(-127, 127, (64, 128)).astype(np.int8)
        b = rng.integers(-127, 127, (128, 256)).astype(np.int8)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    else:
        ta, ja = (_bf16(rng, 64, 128) if dtype == "bfloat16" else
                  (lambda x: (torch.from_numpy(x), jnp.asarray(x)))(
                      rng.standard_normal((64, 128)).astype(np.float32)))
        tb, jb = (_bf16(rng, 128, 256) if dtype == "bfloat16" else
                  (lambda x: (torch.from_numpy(x), jnp.asarray(x)))(
                      rng.standard_normal((128, 256)).astype(np.float32)))
    want = np.asarray(REAL_PALLAS_CALL(kernel, **kw)(ja, jb))
    got = p2.mxu(ta, tb, iters)
    assert got.shape == (8, 256)
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        scale = float(((ta.float().abs()[:8] + 1) @ tb.float().abs()).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -18 * iters * scale)


def test_p2_int8_sums_wrap_as_int32():
    """The plain int8 sum wraps modulo 2^32 as the kernel's s32 sums do."""
    a = torch.full((8, 1024), 127, dtype=torch.int8)
    b = torch.full((1024, 128), 127, dtype=torch.int8)
    iters = 200   # 200 x 1024 x 127^2 = 3.3e9 > 2^31
    exact = (100 * 1024 * 127 * 127) + 100 * 1024 * (127 ^ 1) * 127
    got = p2.mxu_ref(a, b, iters)
    assert int(got[0, 0]) == (exact + 2 ** 31) % 2 ** 32 - 2 ** 31


def _truncating_mxu(a, b, iters):
    """P2's sum as the kernel takes it, in a model of its rounding: per
    chunk of K (`CHUNK`), an fp32 accumulator that each k16 product (the
    split mode's six products of the parts) enters with truncation toward
    zero; the chunks then added in fp32."""
    from reverso_tpu_torch.ops.split import split_parts
    c = p2.CHUNK[a.dtype]
    split = a.dtype == torch.float32
    rows = [a[:8], p2.perturbed(a[:8])]
    parts = ([split_parts(x, 3).double() for x in rows], split_parts(b.t().contiguous(), 3)
             .double().transpose(1, 2)) if split else None
    out = torch.zeros((8, b.shape[1]), dtype=torch.float32)
    for kc in range(a.shape[1] // c):
        acc = torch.zeros((8, b.shape[1]), dtype=torch.float32)
        for it in range(iters):
            for k0 in range(kc * c, (kc + 1) * c, 16):
                ks = slice(k0, k0 + 16)
                if split:
                    pa, pb = parts[0][it % 2], parts[1]
                    prods = [pa[i][:, ks] @ pb[j][ks] for i, j in
                             ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))]
                else:
                    prods = [rows[it % 2][:, ks].double() @ b[ks].double()]
                for p in prods:
                    exact = acc.double() + p
                    f = exact.float()
                    acc = torch.where(f.double().abs() > exact.abs(),
                                      torch.nextafter(f, torch.zeros_like(f)), f)
        out = out + acc
    return out


@pytest.mark.parametrize("dtype,iters", [(torch.bfloat16, 256), (torch.float32, 48)])
def test_p2_gate_holds_a_truncating_accumulator_and_catches_a_dropped_step(dtype, iters):
    """`mxu_tol` bounds the distance from `mxu_ref` of a sum whose chunk
    accumulators truncate at every product, element by element; and the
    output of a run that dropped one step (its part x or x' of the sum) lies
    past it: `dropped_step_reading` > 1, and some element fails."""
    gen = torch.Generator().manual_seed(4)
    a, b = p2.seeded_operands(dtype, 128, 256, 256, "cpu", gen)
    ref = p2.mxu_ref(a, b, iters).double()
    tol = p2.mxu_tol(a, b, iters)
    err = (_truncating_mxu(a, b, iters).double() - ref).abs()
    assert bool((err <= tol).all()) and float(err.max()) > 0
    x = p2.mxu_ref(a, b, 1).double()          # an even step's part of the sum
    xp = p2.mxu_ref(a, b, 2).double() - x      # an odd step's
    for step in (x, xp):
        assert bool((step.abs() > tol).any())
    assert p2.dropped_step_reading(a, b, iters) > 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_p2_gate_catches_a_dropped_step_at_the_script_shape(dtype):
    """At the script's shape, seeded as the probe seeds it: one dropped step
    is past `mxu_tol` at CHECK_ITERS steps in both modes, and at the
    script's 1024 steps in bf16; the gate grows as iters^2, a step does
    not."""
    gen = torch.Generator().manual_seed(22)
    a, b = p2.seeded_operands(dtype, p2.M, p2.K, p2.N, "cpu", gen)
    assert p2.dropped_step_reading(a, b, p2.CHECK_ITERS) > 4
    if dtype == torch.bfloat16:
        assert p2.dropped_step_reading(a, b, p2.ITERS) > 1
    assert p2.dropped_step_reading(a, b, p2.CHECK_ITERS) > \
        8 * p2.dropped_step_reading(a, b, p2.ITERS)


def test_p2_gate_is_zero_in_int8():
    a, b = p2.seeded_operands(torch.int8, 128, 256, 256, "cpu", torch.Generator().manual_seed(0))
    assert not bool(p2.mxu_tol(a, b, 1024).any())


def test_p4_distinct_offsets_and_rows():
    """Offsets of blocks that do not overlap cover every whole block once;
    `distinct_rows` counts the rows overlapping blocks cover together."""
    gen = torch.Generator().manual_seed(0)
    for shift, blocks in ((0, 512), (7, 511)):
        offs = p4.distinct_offsets(p4.N, shift, "cpu", gen)
        assert offs.dtype == torch.int32 and offs.numel() == blocks
        assert sorted(offs.tolist()) == [b * p4.ROWS + shift for b in range(blocks)]
        assert p4.distinct_rows(offs) == blocks * p4.ROWS
    assert p4.distinct_rows(torch.tensor([600, 0, 1], dtype=torch.int32)) == 512 + 1 + 512
    assert p4.distinct_rows(torch.tensor([5, 5], dtype=torch.int32)) == 512


@pytest.mark.parametrize("variant", ["unroll", "stage", "wide", "dyn"])
def test_p3_scan_matches_bench_scan_overlap_kernel(recorder, monkeypatch, variant):
    """P3: the script's pipeline, its globals patched to 4096 x 128 rows, Q =
    16, TILE = 512, a 4-deep ring, against `scan_ref` (the function the
    port's kernel computes at its own TILE of 128) within
    `reassociation_tol` (fp32 sums of d products in another order). unroll and dyn: out [Q, TILE];
    stage and wide: every column the query's max."""
    mod = _script("bench_scan_overlap")
    for name, value in dict(N=4096, D=128, Q=16, TILE=512, BUFS=4, N_TILES=8).items():
        monkeypatch.setattr(mod, name, value)
    db_t, db_j = _bf16(np.random.default_rng(3), 4096, 128)
    want = np.asarray(mod.make(variant)(db_j, db_j[:16]))
    assert recorder.calls
    got = p3.scan_ref(db_t, db_t[:16], "unroll" if variant == "dyn" else variant, tile=512)
    tol = probes.reassociation_tol(db_t[:16], db_t)
    if variant in ("unroll", "dyn"):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    else:
        assert (want == want[:, :1]).all()
        np.testing.assert_allclose(got.numpy(), want[:, 0], rtol=0, atol=tol)
    # the port's own variant on the CPU is the plain version at TILE = 128
    out = p3.scan(db_t, db_t[:16], "unroll" if variant == "dyn" else variant)
    assert out.shape == ((16, p3.TILE) if variant in ("unroll", "dyn") else (16,))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_p4_dyn_dma_matches_proto_dyn_dma_kernel(recorder, monkeypatch, dtype):
    """P4: the script's kernel (interpret mode) at its awkward offsets on a
    2048 x 1024 matrix, one rep each, and three reps (the script keeps the
    last rep's scores, the port every rep's), against `dyn_dma`: int8
    exactly (integer sums below 2^24), bf16 within `dyn_dma_tol`."""
    mod = _script("proto_dyn_dma")
    monkeypatch.setattr(mod, "INTERPRET", True)
    rng = np.random.default_rng(4)
    n = 2048
    if dtype == "int8":
        mat = rng.integers(-127, 128, (n, 1024)).astype(np.int8)
        q = rng.integers(-127, 128, (8, 1024)).astype(np.int8)
        mat_t, q_t, mat_j, q_j = (torch.from_numpy(mat), torch.from_numpy(q), jnp.asarray(mat),
                                  jnp.asarray(q))
    else:
        mat_t, mat_j = _bf16(rng, n, 1024)
        q_t, q_j = _bf16(rng, 8, 1024)
    tol = p4.dyn_dma_tol(q_t, mat_t)
    for offs in [[o] for o in p4.offsets(n)] + [[5, 900, n - 512]]:
        want = np.asarray(mod.run(jnp.asarray(offs, jnp.int32), q_j, mat_j, rows=512,
                                  reps=len(offs)))
        got = p4.dyn_dma(torch.tensor(offs, dtype=torch.int32), q_t, mat_t)
        assert got.shape == (len(offs), 8, 512)
        np.testing.assert_allclose(got[-1].numpy(), want, rtol=0, atol=tol)
    assert recorder.calls


@pytest.mark.parametrize("n", [8, 256])
def test_p5_gather_matches_bench_deformable_kernel(recorder, n):
    """P5: the script's dynamic-gather kernel (recorded; the TPU compiled
    only n <= 8) on seeded tables and indices against `gather` on the CPU,
    exactly: the same 64 fp32 adds in the same order."""
    recorder.stop = True
    assert _script("bench_deformable").bench_dyngather_micro(n) is None   # FAILED: recorded
    kernel, kw = recorder.calls[0]
    rng = np.random.default_rng(5)
    tab = rng.standard_normal((n, 128)).astype(np.float32)
    idx = rng.integers(0, n, (n, 128)).astype(np.int32)
    want = np.asarray(REAL_PALLAS_CALL(kernel, **kw)(jnp.asarray(tab), jnp.asarray(idx)))
    got = p5.gather(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_p5_gather_wraps_negative_indices_as_python():
    """Indices below zero or past n wrap as Python's (and JAX's) modulo."""
    tab = torch.arange(6 * 128, dtype=torch.float32).view(6, 128)
    idx = torch.tensor([-1, 7, 0, -13] * 32, dtype=torch.int32).view(1, 128).repeat(6, 1)
    got = p5.gather(tab, idx, iters=3)
    cols = torch.arange(128)
    want = sum(tab[(idx[0] + it) % 6, cols] for it in range(3))
    assert torch.equal(got[0], want)


def test_probe_benches_on_the_cpu_run_the_plain_versions():
    """On the CPU each probe's bench returns its plain version's output at a
    small shape and times nothing."""
    gen = torch.Generator().manual_seed(0)
    r = p1.bench(256, 32, 4, 2, device="cpu", generator=gen)
    assert r["out"].shape == (8, 1024) and "ms" not in r
    r = p2.bench(torch.int8, 16, 128, 256, iters=3, device="cpu", generator=gen)
    assert r["out"].dtype == torch.int32 and "ms" not in r
    r = p3.bench("wide", 300, 64, 4, device="cpu", generator=gen)
    assert r["out"].shape == (4,) and "ms" not in r
    r = p4.bench(torch.bfloat16, 2048, 64, device="cpu", generator=gen)
    assert r["out"].shape == (7, 8, 512) and "max_abs_err" not in r
    r = p5.bench_gather(16, device="cpu", generator=gen)
    assert r["out"].shape == (16, 128) and "ms" not in r


def test_probe_entries_raise_for_a_cuda_request_without_a_card():
    """Every probe's bench, asked for the card where there is none, raises;
    none falls back to its plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    gen = torch.Generator().manual_seed(0)
    calls = [lambda: p1.bench(256, 32, 4, 2, device="cuda", generator=gen),
             lambda: p2.bench(torch.bfloat16, 128, 64, 256, iters=2, device="cuda",
                              generator=gen),
             lambda: p3.bench("unroll", 300, 64, 4, device="cuda", generator=gen),
             lambda: p4.bench(torch.int8, 2048, 64, device="cuda", generator=gen),
             lambda: p5.bench_gather(16, device="cuda", generator=gen),
             lambda: p5.k8_ms(torch.float32, device="cuda", generator=gen)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
    for main in (p1.main, p2.main, p3.main, p4.main, p5.main):
        with pytest.raises(RuntimeError, match="CUDA card"):
            main([])


def test_probe_wrappers_raise_off_cuda():
    """The kernel wrappers given tensors neither on the CPU nor on a card
    (meta) raise before any launch; no launch is counted."""
    m = lambda *shape, dtype=torch.bfloat16: torch.empty(*shape, device="meta", dtype=dtype)
    before = dict(kernels.launches)
    calls = [lambda: p1.stream_max(m(64, 1024), 16, 4, 1),
             lambda: p2.mxu(m(128, 64), m(64, 256), 2),
             lambda: p3.scan(m(300, 64), m(4, 64), "stage"),
             lambda: p4.dyn_dma(m(3, dtype=torch.int32), m(8, 64), m(600, 64)),
             lambda: p5.gather(m(16, 128, dtype=torch.float32), m(16, 128, dtype=torch.int32))]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert kernels.launches == before


@pytest.mark.parametrize("nbytes,ops,dtype,want", [
    (3e9, 4e11, "bfloat16", (1.0, "bytes")),          # 3 GB at 3 TB/s; 0.4 TFLOP at 800
    (3e9, 1e12 * 1.6, "int8", (1.0, "bytes")),        # a tie takes "bytes"
    (3e8, 8e12, "bfloat16", (10.0, "operations")),
    (0.0, 1.6e11, "float32_split", (1.0, "operations")),
    (6e6, 6.7e10, "float32", (1.0, "operations")),    # the CUDA cores' data-sheet rate
])
def test_measured_bound_arithmetic(nbytes, ops, dtype, want):
    """The measured bound is the larger of the bytes over the measured read
    rate and the operations over the measured rate of their type, in ms."""
    peaks = {"bytes_s": 3e12, "bfloat16": 8e14, "int8": 1.6e15, "float32_split": 1.6e14,
             "float32": 67e12}
    ms, by = probes.measured_bound(nbytes, ops, dtype, peaks)
    assert by == want[1] and ms == pytest.approx(want[0], rel=1e-12)


@pytest.mark.parametrize("nbytes,l2_bytes_s,want", [
    (4e7, 5e12, 0.008),     # fits in L2: over L2's rate
    (6e7, 5e12, 0.02),      # does not: over device memory's
    (4e7, 2e12, 4e7 / 3e12 * 1e3),   # L2 measured slower: device memory's rate still
])
def test_measured_bound_takes_l2s_rate_for_bytes_l2_holds(nbytes, l2_bytes_s, want):
    """Bytes that L2 holds (50 MB here) are bounded by the higher of the L2
    and device-memory rates: work timed back to back may find them in L2."""
    peaks = {"bytes_s": 3e12, "l2_bytes": 5e7, "l2_bytes_s": l2_bytes_s, "bfloat16": 8e14}
    ms, by = probes.measured_bound(nbytes, 1.0, "bfloat16", peaks)
    assert by == "bytes" and ms == pytest.approx(want, rel=1e-12)


def test_chip_smoke_bounds_keep_their_work():
    """chip_smoke.py's bounds keep the bytes, operations and type they came
    from, so that every row can be bounded again at the measured rates, and
    stay plain floats in arithmetic and JSON."""
    import json
    import chip_smoke
    ms, by = chip_smoke.bound(2e9, 1e12, "bfloat16")
    assert isinstance(ms, chip_smoke.BoundMs) and (ms.nbytes, ms.ops, ms.dtype) == (
        2e9, 1e12, "bfloat16")
    assert by == "operations" and ms == pytest.approx(1e12 / 989e12 * 1e3)
    assert json.loads(json.dumps({"b": ms})) == {"b": float(ms)}
    k8, _ = chip_smoke.k8_bound(4, 13294, 13294, 8, 32, 4, 4)
    assert k8.dtype == "float32"
    again, _ = probes.measured_bound(k8.nbytes, k8.ops, k8.dtype,
                                     {"bytes_s": chip_smoke.HBM_BYTES_S,
                                      **chip_smoke.PEAK_OPS_S})
    assert again == pytest.approx(float(k8))


def test_p1_fits_matches_the_shared_memory_rule():
    """A ring fits when one CTA's shared memory is under 227 KB and the CTAs
    asked for fit on an SM: 2 x 64 KB stages alone, not two such CTAs, and
    no 128 KB stage (a ring holds two)."""
    assert p1.fits(32, 2, 1, 1) and not p1.fits(32, 2, 1, 2)
    assert p1.fits(16, 2, 2, 2) and not p1.fits(64, 2, 1, 1)
    assert not p1.fits(16, 4, 3, 1)     # streams must divide the tile
    assert p1.fits(*p1.DEFAULT)
