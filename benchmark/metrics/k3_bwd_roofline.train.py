"""K3's backward (`csrc/flash_heads_bwd_tc.cu`: prep, dq and dk / dv
kernels, summed a call): `heads_bwd_bound` at each launch's shape over
the device time of the `hbwd::` kernels."""
from counts import kernels
from harness import readers


def least_ms(shape):
    b, s, w, heads, rope, dtype = shape
    size, peak = readers.dtype_of(dtype)
    return kernels.heads_bwd_bound(b, s, w, heads, size, peak, rope=bool(rope))[0]


def read(r):
    return readers.roofline(r, "flash_heads_bwd", ("hbwd::",), least_ms)
