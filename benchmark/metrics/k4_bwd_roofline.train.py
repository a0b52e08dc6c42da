"""K4's backward kernel (`csrc/fused_mlp_bwd.cu`: z recomputed, h, dz and
db1's partial sums): `mlp_bwd_bound`'s kernel part at each launch's shape
over the device time of the `mbwd::` kernels."""
from counts import kernels
from harness import readers


def least_ms(shape):
    t, w, hid, _act, dtype = shape
    size, peak = readers.dtype_of(dtype)
    return kernels.mlp_bwd_bound(t, w, hid, size, peak, kernel_only=True)[0]


def read(r):
    return readers.roofline(r, "fused_mlp_bwd", ("mbwd::",), least_ms)
