"""K4 (`ops/fused_mlp.py` -> `csrc/fused_mlp.cu`, the bf16 wgmma GEMMs):
`mlp_bound` at each launch's shape over the device time of
`fused_mlp_wgmma` kernels."""
from counts import kernels
from harness import readers


def least_ms(shape):
    t, w, hid, _act = shape
    return kernels.mlp_bound(t, w, hid, 2, "bfloat16")[0]


def read(r):
    return readers.roofline(r, "fused_mlp_tc", ("fused_mlp_wgmma",), least_ms)
