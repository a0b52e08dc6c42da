"""P2: the tensor cores' sustained rate in bf16, int8 and the fp32 split
mode (the port of `scripts/bench_mxu.py`).

Computes the first 8 rows of the sum over `iters` steps of A_i B, A_i
alternating between a (even steps) and a' (odd steps): a xor 1 in int8,
a + 1 rounded to the operand type otherwise; M, K, N = 256, 1024, 1024
(`csrc/probe_mxu.cu`: m64n256 wgmma products from shared memory on every
SM). The TPU kernel's f32 -> f32 case is the port's fp32 contract: six
bf16 products of three-part operands (`ops/split.py`), reported as useful
fp32 operations a second against the 989 / 6 TFLOP/s that chip_smoke.py's
"float32_split" peak assumes. Each case is held against its plain version
at the script's 1024 steps and at 64 (`CHECK_ITERS`, where one dropped
step is past the bf16 and fp32 gates, `mxu_tol`), then timed over runs of
about 55-62 ms (`SUSTAINED_ITERS`; int8's held bit for bit there too), with the
SM clock read while further runs are on the card beside its rate.
`torch.matmul` at 8192^3 in bf16 is printed as a reference rate: no one
PyTorch call computes this function.

    python -m reverso_tpu_torch.probes.bench_mxu
"""
from __future__ import annotations

import argparse

import torch

from .. import kernels
from ..ops.split import split_matmul, split_parts
from . import device_of, sm_clock_mhz, timed_ms

M, K, N = 256, 1024, 1024
ITERS = 1024        # the script's steps: the run held against the plain version
# a second check's steps: the rounding gate grows as iters^2 and a step's
# part of the sum does not, so here one dropped step fails it in every mode
CHECK_ITERS = 64
# the timed runs' steps, by operand type: about 55-62 ms each on an H100 (the
# script's 1024 steps take under 1 ms there), so that the rate and the SM
# clock read under the load are the sustained ones under the power limit
SUSTAINED_ITERS = {torch.bfloat16: 98304, torch.int8: 196608, torch.float32: 16384}
# operand dtype -> the kernel's mode (csrc/probe_mxu.cu::kMode*)
MODES = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
# elements of K a chunk accumulator covers (128 bytes; the split mode's parts
# 64 bytes) and the tensor-core products a step adds into it: four k16 (k32)
# products; the split mode's six products of two k16 each
CHUNK = {torch.bfloat16: 64, torch.int8: 128, torch.float32: 32}
STEPS = {torch.bfloat16: 4, torch.int8: 4, torch.float32: 12}


def perturbed(a: torch.Tensor) -> torch.Tensor:
    """a': a xor 1 in int8, a + 1 rounded to a's type otherwise."""
    if a.dtype == torch.int8:
        return a ^ 1
    return (a.float() + 1).to(a.dtype)


def mxu_ref(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version: [8, N], the first 8 rows of sum_i A_i B as n_even a B +
    n_odd a' B. int8: exact in float64 (|a b| sums far below 2^53), then
    wrapped to int32 as the kernel's s32 sums wrap; bf16: fp32; fp32: the
    split mode's six products (`split_matmul`)."""
    a8 = a[:8]
    n_odd = iters // 2
    n_even = iters - n_odd
    pairs = ((n_even, a8), (n_odd, perturbed(a8)))
    if a.dtype == torch.int8:
        s = sum(c * (x.double() @ b.double()) for c, x in pairs)
        return (torch.remainder(s.long() + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)
    if a.dtype == torch.float32:
        return sum(c * split_matmul(x, b) for c, x in pairs)
    return sum(c * (x.float() @ b.float()) for c, x in pairs)


def _chunk_dots(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """x and x' [K / CHUNK, 8, N]: each chunk's dots of a[:8] and a'[:8]
    against b (float64), and A, the larger of their dots of |a| and |b|."""
    c = CHUNK[a.dtype]
    nk = a.shape[1] // c
    bk = b.double().view(nk, c, -1)
    rows = (a[:8], perturbed(a[:8]))
    x, xp = (torch.einsum("rkc,kcn->krn", v.double().view(8, nk, c), bk) for v in rows)
    big = torch.maximum(*(torch.einsum("rkc,kcn->krn", v.double().abs().view(8, nk, c),
                                       bk.abs()) for v in rows))
    return x, xp, big


def _sms(a: torch.Tensor) -> int:
    """The SMs the kernel's grid may span: the card's, or an H100's 132."""
    return torch.cuda.get_device_properties(a.device).multi_processor_count if a.is_cuda else 132


def mxu_tol(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """The kernel's allowed distance from `mxu_ref`, element by element
    ([8, N], float64; 0 in int8). An output element is the sum of K /
    CHUNK[dtype] chunk accumulators, each taking STEPS tensor-core products
    a step in fp32 that truncate: a product's rounding is at most one ulp,
    2^-23 of the accumulator after it. With x and x' the chunk's dots of a
    and a' against b, and A its larger dot of absolute values, an
    accumulator at step t holds at most B(t) = t / 2 |x + x'| + 2 A (whole
    pairs of steps, one more step, part of a step), so its roundings add up
    to 2^-23 STEPS (|x + x'| iters (iters - 1) / 4 + 2 A iters): the sum's
    magnitude times iters. The chunks' partial sums then meet in
    round-to-nearest atomic adds, at most K / CHUNK + the SMs of them (one
    a chunk, one more where a CTA's share of the units ends), each within
    2^-24 of the total of |x| and |x'| over every step and chunk."""
    if a.dtype == torch.int8:
        return torch.zeros((8, b.shape[1]), dtype=torch.float64, device=a.device)
    x, xp, big = _chunk_dots(a, b)
    nk = x.shape[0]
    n_odd = iters // 2
    rounding = STEPS[a.dtype] * ((x + xp).abs() * (iters * (iters - 1) / 4) + 2 * big * iters)
    total = ((iters - n_odd) * x.abs() + n_odd * xp.abs()).sum(0)
    grid = min(a.shape[0] // 128 * (b.shape[1] // 256) * nk * iters, _sms(a))
    return 2.0 ** -23 * rounding.sum(0) + 2.0 ** -24 * (nk + grid) * total


def dropped_step_reading(a: torch.Tensor, b: torch.Tensor, iters: int) -> float:
    """How far past `mxu_tol` the output of a kernel that dropped one step
    (even or odd, its part of the sum x or x') would lie: the largest
    min(|x|, |x'|) / tol over the elements; above 1, the gate catches it."""
    x, xp, _ = _chunk_dots(a, b)
    step = torch.minimum(x.sum(0).abs(), xp.sum(0).abs())
    return float((step / mxu_tol(a, b, iters)).max())


def compare(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor, iters: int) -> dict:
    """The kernel's output at `iters` steps against `mxu_ref`: raises where
    an element is past `mxu_tol` (int8: unless bit for bit); returns the
    max abs error and the largest error over its gate."""
    ref = mxu_ref(a, b, iters)
    err = (out.double() - ref.double()).abs()
    tol = mxu_tol(a, b, iters)
    name = str(a.dtype).replace("torch.", "")
    if not bool((err <= tol).all()):
        raise AssertionError(f"mxu {name} at {iters} steps: max abs err {float(err.max())}, "
                             f"{int((err > tol).sum())} elements past mxu_tol")
    return {"max_abs_err": float(err.max()),
            "err_over_tol": 0.0 if a.dtype == torch.int8 else float((err / tol).max())}


def mxu(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """P2's function of a [M, K] and b [K, N] (bf16, int8 or fp32); CPU
    tensors run `mxu_ref`, CUDA tensors launch `rv_probe_mxu` (M % 128, N %
    256 and K % 128 bytes of the mode == 0)."""
    if a.dtype not in MODES or b.dtype != a.dtype or a.ndim != 2 or b.ndim != 2 \
            or a.shape[1] != b.shape[0] or a.shape[0] < 8 or iters < 1:
        raise ValueError(f"mxu: a [M, K] and b [K, N] of one dtype (bf16, int8, fp32), "
                         f"iters >= 1; got {a.dtype} {tuple(a.shape)}, {b.dtype} "
                         f"{tuple(b.shape)}, {iters}")
    if a.device.type == "cpu":
        return mxu_ref(a, b, iters)
    kernels.require_cuda("mxu", a, b)
    m, k = a.shape
    n = b.shape[1]
    bt = b.t().contiguous()
    a2 = None
    if a.dtype == torch.float32:   # the parts of a, a' and B^T: [3, rows, K]
        a, a2, bt = split_parts(a, 3), split_parts(perturbed(a), 3), split_parts(bt, 3)
    out = torch.zeros((8, n), dtype=torch.int32 if a.dtype == torch.int8 else torch.float32,
                      device=a.device)
    with torch.cuda.device(a.device):
        status = kernels.lib().rv_probe_mxu(
            a.data_ptr(), a2.data_ptr() if a2 is not None else None, bt.data_ptr(), m, k, n,
            iters, MODES[b.dtype], out.data_ptr(), kernels.stream_ptr(a.device))
    kernels.check("mxu", status)
    kernels.launches["probe_mxu"] += 1
    return out


def seeded_operands(dtype: torch.dtype, m: int, k: int, n: int, device,
                    generator: torch.Generator) -> tuple:
    dev = device_of(device)
    if dtype == torch.int8:   # the script's rng.integers(-127, 127)
        return tuple(torch.randint(-127, 127, shape, generator=generator, device=dev,
                                   dtype=torch.int8) for shape in ((m, k), (k, n)))
    return tuple(torch.randn(shape, generator=generator, device=dev, dtype=dtype)
                 for shape in ((m, k), (k, n)))


def bench(dtype: torch.dtype, m: int = M, k: int = K, n: int = N, iters: int = ITERS, *,
          device, generator: torch.Generator) -> dict:
    """One case on seeded operands: the output at `iters` steps; on the card
    that output and one at CHECK_ITERS steps against the plain version
    (`compare`, with the reading of a dropped step against the gate, which
    must catch it at CHECK_ITERS), then the time of a run of
    SUSTAINED_ITERS steps, the useful operations a second (2 M K N steps)
    and the SM clock while three more such runs are on the card."""
    dev = device_of(device)
    a, b = seeded_operands(dtype, m, k, n, dev, generator)
    out = mxu(a, b, iters)
    res = {"dtype": str(dtype).replace("torch.", ""), "out": out, "shape": (m, k, n, iters)}
    if dev.type == "cpu":
        return res
    res["checks"] = {}
    for steps in dict.fromkeys((iters, CHECK_ITERS)):
        c = compare(out if steps == iters else mxu(a, b, steps), a, b, steps)
        if dtype != torch.int8:
            c["dropped_step_reading"] = dropped_step_reading(a, b, steps)
        res["checks"][steps] = c
    if dtype != torch.int8 and not res["checks"][CHECK_ITERS]["dropped_step_reading"] > 1:
        raise AssertionError(f"mxu {res['dtype']}: at {CHECK_ITERS} steps mxu_tol would pass "
                             f"a dropped step")
    res["max_abs_err"] = res["checks"][iters]["max_abs_err"]
    steps = SUSTAINED_ITERS[dtype]
    if dtype == torch.int8 and not torch.equal(mxu(a, b, steps), mxu_ref(a, b, steps)):
        raise AssertionError(f"mxu int8 at {steps} steps: not bit for bit the plain version")
    res["ms"] = timed_ms(lambda: mxu(a, b, steps), 3)
    for _ in range(3):
        mxu(a, b, steps)
    res["sm_clock_mhz"] = sm_clock_mhz(dev)   # read while those runs are on the card
    torch.cuda.synchronize(dev)
    res["timed_iters"] = steps
    res["ops_s"] = 2.0 * m * k * n * steps / (res["ms"] * 1e-3)
    return res


def matmul_rate(device, generator: torch.Generator, size: int = 8192) -> dict:
    """`torch.matmul` at size^3 in bf16: a reference rate only."""
    a, b = seeded_operands(torch.bfloat16, size, size, size, device, generator)
    ms = timed_ms(lambda: torch.matmul(a, b), 5)
    return {"ms": ms, "ops_s": 2.0 * size ** 3 / (ms * 1e-3)}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = device_of("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        r = bench(dtype, device=dev, generator=gen)
        checks = "; ".join(f"{steps} steps: max abs err {c['max_abs_err']:.3g}, "
                           f"{c['err_over_tol']:.3g} of the gate"
                           + (f", a dropped step {c['dropped_step_reading']:.3g} of it"
                              if "dropped_step_reading" in c else "")
                           for steps, c in r["checks"].items())
        print(f"{r['dtype']:9s}: {r['ms']:8.2f} ms for {r['timed_iters']} steps  "
              f"{r['ops_s'] / 1e12:7.1f} TOP/s (SM clock {r['sm_clock_mhz']} MHz; {checks})",
              flush=True)
    ref = matmul_rate(dev, gen)
    print(f"torch.matmul 8192^3 bf16: {ref['ms']:.3f} ms  {ref['ops_s'] / 1e12:.1f} TFLOP/s",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
