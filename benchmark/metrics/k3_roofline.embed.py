"""K3 (`ops/attention.py` -> `csrc/flash_heads.cu`, `flash_tc.cuh`):
`heads_bound` at each launch's shape, the RoPE tables counted where the
launch rotates, over the device time of `flash_tc_kernel`."""
from counts import kernels
from harness import readers


def least_ms(shape):
    b, s, w, heads, rope = shape
    return kernels.heads_bound(b, s, w, heads, 2, "bfloat16", rope=bool(rope))[0]


def read(r):
    return readers.roofline(r, "flash_heads_tc", ("flash_tc_kernel",), least_ms)
