"""K1 (`store/index.py` -> `ops/topk.py` -> `csrc/topk_stream.cu`, the
scan and its merge): `topk_bound` at each launch's shape over the device
time of the `topk_` kernels."""
from counts import kernels
from harness import readers


def least_ms(shape):
    q, n, d, k, masked = shape
    return kernels.topk_bound("topk_stream", q, n, d, k, masked)[0]


def read(r):
    return readers.roofline(r, "topk_stream", ("topk_",), least_ms)
