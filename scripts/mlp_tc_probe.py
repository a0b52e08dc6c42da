#!/usr/bin/env python3
"""Tile variants of the ViT MLP's wgmma + TMA GEMMs (`reverso_tpu_torch/
csrc/fused_mlp.cu`, K4 in bf16 and in fp32 on split parts) timed on one
card.

    python3 scripts/mlp_tc_probe.py [variant ...]

Compiles `fused_mlp.cu` alone once per variant (all nvcc runs at once,
each into its own library in a temporary directory, with ptxas's
register and spill counts printed), then, one process per variant, holds
both GEMMs and the whole MLP against the plain version at T = 4616 (PE-L14
at B = 8) and T = 36,928 (B = 64), 1024 -> 4096 -> 1024, gelu, and times by
CUDA events after a device sleep (`chip_smoke.py::cuda_ms`, 20 calls):
each GEMM on the wide (128 x 256) and the narrow (128 x 128) tile, GEMM 1
also without its activation (the epilogue's cost), the MLP as shipped
(each GEMM's tile by the launcher's rule), and the cuBLAS route
(`F.linear`, `F.gelu`, `F.linear`) beside them; then the fp32 MLP on the
split GEMMs (`rv_fused_mlp_split`, the weights' parts made once) at
T = 1154 and 4616, held against the plain version, beside the fp32 cuBLAS
route. A variant edits a tile config (`GemmCfg<BN, STAGES, PARTS>`);
names on the command line pick variants (default: all). Prints the card
and one JSON line per variant. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {"GemmWide": "GemmCfg<256, 4>", "GemmNarrow": "GemmCfg<128, 4>",
           "GemmSplit": "GemmCfg<128, 4, 3>"}
# name -> {tile config: its replacement}
VARIANTS = {
    "shipped": {},
    "narrow_3_stages": {"GemmNarrow": "GemmCfg<128, 3>"},
    "narrow_6_stages": {"GemmNarrow": "GemmCfg<128, 6>"},
    "wide_3_stages": {"GemmWide": "GemmCfg<256, 3>"},
    # the split GEMMs: 128 x 64 tiles (twice the CTAs: GEMM 2 at T = 1154
    # has 80 of 128 x 128 for 132 SMs) with six stages, a ring of three
    "split_narrow_6_stages": {"GemmSplit": "GemmCfg<64, 6, 3>"},
    "split_3_stages": {"GemmSplit": "GemmCfg<128, 3, 3>"},
}
# one GEMM on one tile config, for timing (appended to the variant's copy)
PROBE_LAUNCHERS = """
extern "C" int rv_probe_gemm(int wide, const void* a, const void* b, const void* bias,
                             void* c, int m, int n, int k, int act, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide)
        return rv::mlp_tc::launch_gemm<rv::mlp_tc::GemmWide>(a, b, bias, c, m, n, k, act, st);
    return rv::mlp_tc::launch_gemm<rv::mlp_tc::GemmNarrow>(a, b, bias, c, m, n, k, act, st);
}
"""


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def start_build(name: str, work: str):
    """Copies csrc/ into work/name, edits the tile configs, starts nvcc."""
    from reverso_tpu_torch import kernels
    csrc = os.path.join(work, name)
    shutil.copytree(kernels.CSRC, csrc)
    path = os.path.join(csrc, "fused_mlp.cu")
    text = open(path).read()
    for gemm, cfg in {**SHIPPED, **VARIANTS[name]}.items():
        line = f"using {gemm} = {SHIPPED[gemm]};"
        if line not in text:
            raise RuntimeError(f"{line!r} not in fused_mlp.cu")
        text = text.replace(line, f"using {gemm} = {cfg};")
    open(path, "w").write(text + PROBE_LAUNCHERS)
    lib = os.path.join(csrc, "libprobe.so")
    cmd = [nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, path]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each wgmma GEMM instantiation."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn and ("fused_mlp_wgmma" in fn or "fused_mlp_split" in fn):
            cfg = re.search(r"GemmCfgILi(\d+)ELi(\d+)ELi(\d)E", fn)
            key = "x".join(cfg.groups()) if cfg else fn
            if "fused_mlp_split" in fn:   # by the epilogue: h's parts or fp32 y
                key += "_h_parts" if "ELi1EE" in fn else "_y_f32"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(key, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out.setdefault(key, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def run_variant(name: str, lib_path: str) -> dict:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, REPO)
    from chip_smoke import bound, cuda_ms
    from reverso_tpu_torch.ops.fused_mlp import ACT_CODES, mlp_ref

    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rv_probe_gemm.argtypes = [I, P, P, P, P, I, I, I, I, P]
    lib.rv_fused_mlp_tc.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
    lib.rv_fused_mlp_split.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.rv_split_parts.argtypes = [P, P, I, I, I, I, I, I, P]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    w, hid = 1024, 4096
    w1 = (torch.randn(hid, w, generator=gen, device="cuda") * w ** -0.5).to(bf16)
    b1 = (torch.randn(hid, generator=gen, device="cuda") * 0.02).to(bf16)
    w2 = (torch.randn(w, hid, generator=gen, device="cuda") * hid ** -0.5).to(bf16)
    b2 = (torch.randn(w, generator=gen, device="cuda") * 0.02).to(bf16)
    out = dict(variant=name)
    for t in (4616, 36928):
        x = torch.randn(t, w, generator=gen, device="cuda").to(bf16)
        h = torch.empty(t, hid, dtype=bf16, device="cuda")
        y = torch.empty(t, w, dtype=bf16, device="cuda")

        def gemm(wide, a, b, bias, c, act):
            st = lib.rv_probe_gemm(wide, a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                                   c.data_ptr(), a.shape[0], b.shape[0], a.shape[1], act,
                                   stream)
            if st:
                raise RuntimeError(f"{name}: GEMM (wide {wide}) status {st}")

        def mlp():
            st = lib.rv_fused_mlp_tc(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                     b2.data_ptr(), h.data_ptr(), y.data_ptr(), t, w, hid,
                                     ACT_CODES["gelu"], stream)
            if st:
                raise RuntimeError(f"{name}: MLP status {st}")

        mlp()
        ref = mlp_ref(x, w1, b1, w2, b2, act="gelu")
        h_ref = F.gelu(x.float() @ w1.float().t() + b1.float()).to(bf16)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        h_err = float((h.float() - h_ref.float()).abs().max())
        # one bf16 rounding of the output; of h, relative to its largest value
        h_tol = 2e-2 * max(1.0, float(h_ref.float().abs().max()))
        if not (err <= 2e-2 and h_err <= h_tol):
            raise AssertionError(f"{name} T={t}: max abs err y {err}, h {h_err}")
        h2, y2 = torch.empty_like(h), torch.empty_like(y)
        r = dict(max_abs_err=err, h_max_abs_err=h_err)
        for wide, tile in ((1, "wide"), (0, "narrow")):
            gemm(wide, x, w1, b1, h2, ACT_CODES["gelu"])
            gemm(wide, h, w2, b2, y2, -1)
            torch.cuda.synchronize()
            if (float((h2.float() - h_ref.float()).abs().max()) > h_tol
                    or float((y2.float() - ref.float()).abs().max()) > 2e-2):
                raise AssertionError(f"{name} T={t}: the {tile} tile disagrees")
            r[f"gemm1_{tile}_ms"] = cuda_ms(lambda: gemm(wide, x, w1, b1, h2, ACT_CODES["gelu"]),
                                            iters=20)
            r[f"gemm1_{tile}_no_act_ms"] = cuda_ms(lambda: gemm(wide, x, w1, b1, h2, -1),
                                                   iters=20)
            r[f"gemm2_{tile}_ms"] = cuda_ms(lambda: gemm(wide, h, w2, b2, y2, -1), iters=20)
        r.update(
            mlp_ms=cuda_ms(mlp, iters=20),
            cublas_route_ms=cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2),
                                    iters=20),
            bound_ms=bound((2 * t * w + 2 * hid * w + hid + w) * 2, 4 * t * w * hid,
                           "bfloat16")[0])
        out[f"T{t}"] = r
        del x, h, y, h2, y2, ref, h_ref

    # fp32 on the split GEMMs: the weights' parts made once (as the tower
    # caches them), x's split pass inside each call
    f32 = torch.float32
    w1f, b1f, w2f, b2f = (p.to(f32) for p in (w1, b1, w2, b2))

    def parts(m):
        p = torch.empty(3, m.shape[0], m.shape[1], dtype=bf16, device="cuda")
        st = lib.rv_split_parts(m.data_ptr(), p.data_ptr(), m.shape[0], m.shape[1], m.shape[0],
                                m.shape[1], 3, 0, stream)
        if st:
            raise RuntimeError(f"{name}: split pass status {st}")
        return p

    w1p, w2p = parts(w1f), parts(w2f)
    for t in (1154, 4616):
        x = torch.randn(t, w, generator=gen, device="cuda")
        xp = torch.empty(3, t, w, dtype=bf16, device="cuda")
        hp = torch.empty(3, t, hid, dtype=bf16, device="cuda")
        y = torch.empty(t, w, dtype=f32, device="cuda")

        def mlp32():
            st = lib.rv_fused_mlp_split(x.data_ptr(), w1p.data_ptr(), b1f.data_ptr(),
                                        w2p.data_ptr(), b2f.data_ptr(), xp.data_ptr(),
                                        hp.data_ptr(), y.data_ptr(), t, w, hid,
                                        ACT_CODES["gelu"], stream)
            if st:
                raise RuntimeError(f"{name}: fp32 MLP status {st}")

        mlp32()
        err = float((y - mlp_ref(x, w1f, b1f, w2f, b2f, act="gelu")).abs().max())
        if err > 1e-4:
            raise AssertionError(f"{name} fp32 T={t}: max abs err {err}")
        out[f"f32_T{t}"] = dict(
            max_abs_err=err, mlp_ms=cuda_ms(mlp32, iters=20),
            cublas_route_ms=cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1f, b1f)), w2f, b2f),
                                    iters=20),
            bound_ms=bound((2 * t * w + 2 * hid * w + hid + w) * 4, 4 * t * w * hid,
                           "float32_split")[0])
        del x, xp, hp, y
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mlp_tc_probe: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="mlp_tc_probe_")
    rc = 0
    try:
        names = sys.argv[1:] or list(VARIANTS)
        builds = {name: start_build(name, work) for name in names}
        libs = {}
        for name, (lib, proc) in builds.items():
            log_out, log_err = proc.communicate()
            if proc.returncode != 0:
                print(f"{name}: nvcc failed ({proc.returncode})\n{log_err[-6000:]}", flush=True)
                rc = 1
                continue
            print(f"{name}: ptxas {json.dumps(ptxas_usage(log_out + log_err))}", flush=True)
            libs[name] = lib
        for name, lib in libs.items():   # one process each: a hang is cut at its timeout
            try:
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant",
                                       name, lib], capture_output=True, text=True, timeout=120)
            except subprocess.TimeoutExpired:
                print(f"{name}: timed out", flush=True)
                rc = 1
                continue
            lines = proc.stdout.strip().splitlines()
            print(lines[-1] if proc.returncode == 0 and lines
                  else f"{name}: failed ({proc.returncode})\n{proc.stderr[-3000:]}", flush=True)
            rc |= proc.returncode
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
