#!/usr/bin/env python3
"""PE-Core-L14-336 in fp32 (the parity mode, `ModelConfig.dtype="float32"`)
at full width and depth, B = 8, seeded random init, on one card: one
profiled forward of the tower (`chip_smoke.py::profiled`: host wall,
device busy share, device time by kernel group) and K4 in fp32 alone at
T = 1154 and 4616 (`chip_smoke.py::cuda_ms`), through the port and the
`chip_smoke.py` of the tree given (default: this checkout), so that two
commits are measured alike.

    python3 scripts/fp32_forward.py [tree root]

Builds the tree's kernels first. Needs a CUDA card and nvcc.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("fp32_forward: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = dataclasses.replace(MODEL_PRESETS["PE-Core-L14-336"], dtype="float32")
    enc = PerceptionEncoder(cfg, seed=11, device="cuda")
    x = torch.randn(8, cfg.image_size, cfg.image_size, 3,
                    generator=torch.Generator().manual_seed(12)).cuda()
    kernels.reset_counts()
    with torch.inference_mode():
        prof = cs.profiled(torch, lambda: enc.module(x))
    print(f"fp32 B=8 forward: {json.dumps(prof)}", flush=True)
    print(f"launches {json.dumps(kernels.launches)}", flush=True)
    del enc
    gen = torch.Generator(device="cuda").manual_seed(0)
    w, hid = 1024, 4096
    r = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc
    w1, b1, w2, b2 = r(hid, w, sc=w ** -0.5), r(hid, sc=0.02), r(w, hid, sc=hid ** -0.5), r(w, sc=0.02)
    for t in (1154, 4616):
        xx = r(t, w)
        print(f"K4 fp32 T={t}: {cs.cuda_ms(lambda: fused_mlp(xx, w1, b1, w2, b2), iters=3):.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
