"""ctypes bindings to the native C++ runtime (native/reverso_native.cpp).

Provides the host-side fallback search engine (the role qdrant local
mode's numpy scan plays in the reference, at C++ multithreaded speed),
zero-copy mmap access to vectors.bin files, and fp32->bf16 staging for
device upload. Builds on demand with the in-repo Makefile; every entry
point degrades to a numpy implementation if no compiler is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .utils.logging import get_logger

log = get_logger("native")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = os.path.join(_native_dir(), "libreverso_native.so")
        src = os.path.join(_native_dir(), "reverso_native.cpp")
        stale = (os.path.exists(so) and os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(so))
        if not os.path.exists(so) or stale:
            if stale:
                try:
                    os.remove(so)
                except OSError:
                    pass
            try:
                subprocess.run(["make", "-C", _native_dir()], check=True,
                               capture_output=True, timeout=120)
            except Exception as e:
                log.warning(f"native build failed ({e}); using numpy fallback")
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            log.warning(f"native load failed ({e}); using numpy fallback")
            return None
        lib.reverso_topk_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int]
        lib.reverso_mmap_open.restype = ctypes.c_void_p
        lib.reverso_mmap_open.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int64)]
        lib.reverso_mmap_data.restype = ctypes.POINTER(ctypes.c_float)
        lib.reverso_mmap_data.argtypes = [ctypes.c_void_p]
        lib.reverso_mmap_close.argtypes = [ctypes.c_void_p]
        lib.reverso_f32_to_bf16.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, ctypes.c_int]
        lib.reverso_payload_scan.argtypes = [
            ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int]
        lib.reverso_intern_spans.restype = ctypes.c_int64
        lib.reverso_intern_spans.argtypes = [
            ctypes.POINTER(ctypes.c_char), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        if hasattr(lib, "reverso_sparse_score"):
            lib.reverso_sparse_score.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def cpu_topk(db: np.ndarray, queries: np.ndarray, k: int,
             n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k on the host. db [N, d], queries [Q, d] fp32
    (L2-normalized). Returns (scores [Q, k] f32, idx [Q, k] int64),
    ordered by (-score, idx); idx -1 pads when k > N."""
    db = np.ascontiguousarray(db, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    if queries.ndim == 1:
        queries = queries[None]
    q = queries.shape[0]
    lib = _load()
    if lib is None:
        return _numpy_topk(db, queries, k)
    scores = np.empty((q, k), np.float32)
    idx = np.empty((q, k), np.int64)
    lib.reverso_topk_f32(
        db.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        db.shape[0], db.shape[1],
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        q, k,
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads)
    return scores, idx


def _numpy_topk(db, queries, k):
    scores = queries @ db.T
    k_eff = min(k, db.shape[0])
    order = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), scores.shape),
                        -scores), axis=1)[:, :k_eff]
    s = np.take_along_axis(scores, order, axis=1)
    if k_eff < k:
        pad = k - k_eff
        s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
        order = np.pad(order, ((0, 0), (0, pad)), constant_values=-1)
    return s.astype(np.float32), order.astype(np.int64)


class MappedVectors:
    """Zero-copy numpy view over a vectors.bin file via the native mmap."""

    def __init__(self, path: str, dim: int):
        self.dim = dim
        lib = _load()
        if lib is None:
            self._handle = None
            # numpy's own mmap keeps the zero-copy contract without the
            # native library (np.fromfile would copy a multi-GB file
            # into RAM eagerly); empty files need the explicit branch —
            # np.memmap refuses zero-length maps
            if os.path.getsize(path) == 0:
                self.array = np.zeros((0, dim), np.float32)
            else:
                self.array = np.memmap(path, np.float32,
                                       mode="r").reshape(-1, dim)
            return
        size = ctypes.c_int64()
        self._lib = lib
        self._handle = lib.reverso_mmap_open(path.encode(),
                                             ctypes.byref(size))
        if not self._handle:
            raise OSError(f"mmap failed: {path}")
        rows = size.value // (4 * dim)
        if rows == 0:
            # empty store: the native handle maps no pages (addr NULL)
            # and np.ctypeslib.as_array raises on a NULL pointer even
            # for shape (0, d) — close the handle, return an empty view
            lib.reverso_mmap_close(self._handle)
            self._handle = None
            self.array = np.zeros((0, dim), np.float32)
            return
        ptr = lib.reverso_mmap_data(self._handle)
        self.array = np.ctypeslib.as_array(ptr, shape=(rows, dim))

    def close(self) -> None:
        if self._handle:
            self._lib.reverso_mmap_close(self._handle)
            self._handle = None
            self.array = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Type tags emitted by reverso_payload_scan (see reverso_native.cpp).
PAYLOAD_MISSING = 0
PAYLOAD_NULL = 1
PAYLOAD_FALSE = 2
PAYLOAD_TRUE = 3
PAYLOAD_INT = 4
PAYLOAD_FLOAT = 5
PAYLOAD_STR = 6        # span excludes quotes, no escapes (raw UTF-8)
PAYLOAD_STR_ESC = 7    # span excludes quotes, contains JSON escapes
PAYLOAD_COMPLEX = 8    # raw object/array token


def payload_scan(buf: np.ndarray, offsets: np.ndarray, ends: np.ndarray,
                 keys: list, n_threads: int = 0):
    """Native columnar scan of a payloads.jsonl byte buffer.

    buf: uint8 array of the whole file (e.g. np.frombuffer over an
    mmap — never copied). offsets/ends: [rows] int64 line byte ranges.
    Returns (types u8, numbers f64, str_off i64, str_len i64), each
    [rows, n_keys]; type semantics per the PAYLOAD_* tags. Returns None
    when the native library is unavailable (caller falls back to the
    Python json pass). Ints are exact while |v| < 2**53.
    """
    lib = _load()
    if lib is None:
        return None
    rows, n_keys = len(offsets), len(keys)
    types = np.zeros((rows, n_keys), np.uint8)
    numbers = np.zeros((rows, n_keys), np.float64)
    str_off = np.zeros((rows, n_keys), np.int64)
    str_len = np.zeros((rows, n_keys), np.int64)
    if rows == 0 or n_keys == 0:
        return types, numbers, str_off, str_len
    buf = np.ascontiguousarray(buf, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    key_bytes = [k.encode("utf-8") for k in keys]
    key_arr = (ctypes.c_char_p * n_keys)(*key_bytes)
    len_arr = (ctypes.c_int * n_keys)(*[len(b) for b in key_bytes])
    lib.reverso_payload_scan(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), buf.size,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rows, key_arr, len_arr, n_keys,
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        numbers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        str_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        str_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads)
    return types, numbers, str_off, str_len


def intern_spans(buf: np.ndarray, offs: np.ndarray, lens: np.ndarray):
    """Dictionary-encode byte spans of `buf`: returns (codes int32
    [rows], uniq_off, uniq_len int64 [n_unique]) — identical spans share
    a dense first-occurrence code. None when the native lib is absent."""
    lib = _load()
    if lib is None:
        return None
    rows = len(offs)
    buf = np.ascontiguousarray(buf, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    codes = np.empty((rows,), np.int32)
    uniq_off = np.empty((rows,), np.int64)
    uniq_len = np.empty((rows,), np.int64)
    if rows == 0:
        return codes, uniq_off, uniq_len
    n = lib.reverso_intern_spans(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rows,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        uniq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        uniq_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return codes, uniq_off[:n], uniq_len[:n]


def f32_to_bf16_bits(x: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """fp32 -> bf16 (as uint16 bit patterns), round-to-nearest-even."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    out = np.empty(x.shape, np.uint16)
    if lib is None:
        bits = x.view(np.uint32)
        lsb = (bits >> 16) & 1
        rounded = ((bits + 0x7FFF + lsb) >> 16).astype(np.uint16)
        # NaN: the rounding carry can overflow the mantissa into the
        # exponent (NaN -> +/-Inf); emit a quiet-NaN pattern instead.
        is_nan = ((bits & 0x7F800000) == 0x7F800000) & ((bits & 0x7FFFFF) != 0)
        return np.where(is_nan,
                        ((bits >> 16) | 0x0040).astype(np.uint16), rounded)
    lib.reverso_f32_to_bf16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        x.size, n_threads)
    return out


def sparse_score(rows: np.ndarray, vals: np.ndarray, seg_lo: np.ndarray,
                 seg_hi: np.ndarray, qv: np.ndarray, n_rows: int,
                 scores: np.ndarray, touched: np.ndarray,
                 n_threads: int = 0) -> bool:
    """Accumulate sparse postings into `scores`/`touched` in place
    (store/sparse.py hot loop): for each segment s, scores[rows[i]] +=
    vals[i] * qv[s] over postings [seg_lo[s], seg_hi[s]). Rows within
    a segment must be sorted ascending (the SparseIndex build
    guarantees it) — threads partition the row space and binary-search
    each segment, so results are BIT-identical to the sequential f64
    reference. Returns False when the native library is unavailable
    (caller falls back to numpy)."""
    lib = _load()
    if lib is None or not hasattr(lib, "reverso_sparse_score"):
        return False
    assert rows.dtype == np.int32 and vals.dtype == np.float32
    assert scores.dtype == np.float64 and touched.dtype == np.uint8
    seg_lo = np.ascontiguousarray(seg_lo, np.int64)
    seg_hi = np.ascontiguousarray(seg_hi, np.int64)
    qv = np.ascontiguousarray(qv, np.float32)
    lib.reverso_sparse_score(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        seg_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seg_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(qv), n_rows,
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        touched.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads)
    return True
