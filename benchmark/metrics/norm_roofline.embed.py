"""The tower's norm sites (`ops/norm.py::add_layernorm` ->
`csrc/add_layernorm.cu`): the bytes each launch cannot avoid over the HBM
rate, over the device time of `add_layernorm` kernels. A launch with a
residual reads x and y and writes r and h, one without reads x and writes
h; both read the fp32 LayerNorm weight and bias, and gamma where it
scales. No operations term: the pass is bound by its bytes."""
from counts import kernels
from harness import readers


def least_ms(shape):
    t, w, dtype, residual, scaled = shape
    itemsize = readers.dtype_of(dtype)[0]
    acts = t * w * itemsize * (4 if residual else 2)
    params = (3 if scaled else 2) * w * 4
    return kernels.bound(acts + params, 0, "bfloat16")[0]


def read(r):
    return readers.roofline(r, "add_layernorm", ("add_layernorm",), least_ms)
