"""Converted-parameter persistence in the JAX package's msgpack format.

A parameter file is what flax's `serialization.msgpack_serialize` writes
for a nested dict of arrays, and a sidecar `<path>.json` holds the meta
(the architecture: `config` or `preset`, and `family`). This module reads
and writes that format on the `msgpack` package alone, imported inside
the functions, so files move between the two packages both ways:

  * an array is msgpack ExtType 1 holding the packed tuple
    `(shape, dtype.name, C-order bytes)`; a numpy scalar is ExtType 3 with
    the same payload (a 0-d array);
  * the dtype name `bfloat16` (which numpy lacks) loads as a
    `torch.bfloat16` tensor; a bf16 tensor saves under that name;
  * arrays above `MAX_CHUNK_SIZE` bytes are split into a dict marked
    `__msgpack_chunked_array__` (`shape` and `chunks`, each a dict keyed
    "0", "1", ...), as flax splits them; such dicts load as one array.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

# flax's bound per array leaf (msgpack's own is 2^31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def _array_payload(shape, dtype_name: str, raw: bytes) -> bytes:
    import msgpack

    return msgpack.packb((list(shape), dtype_name, raw), use_bin_type=True)


def _pack_leaf(x):
    """msgpack `default` hook: arrays, tensors and numpy scalars as flax's
    ExtTypes; tuples as lists."""
    import msgpack

    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes("C")
            return msgpack.ExtType(_EXT_NDARRAY, _array_payload(t.shape, "bfloat16", raw))
        x = t.numpy()
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY,
                               _array_payload(x.shape, x.dtype.name, x.tobytes("C")))
    if isinstance(x, np.generic):
        a = np.asarray(x)
        return msgpack.ExtType(_EXT_NPSCALAR, _array_payload((), a.dtype.name, a.tobytes()))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    if isinstance(x, tuple):
        return list(x)
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes if isinstance(x, np.ndarray) else 0


def _chunked(tree):
    """Leaves above MAX_CHUNK_SIZE bytes -> flax's chunked-array dicts;
    dict keys in sorted order, as the JAX package's tree map leaves them
    (so both packages write the same bytes)."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if _nbytes(tree) <= MAX_CHUNK_SIZE:
        return tree
    per = max(1, MAX_CHUNK_SIZE // tree.itemsize if isinstance(tree, np.ndarray)
              else MAX_CHUNK_SIZE // tree.element_size())
    flat = tree.reshape(-1)
    chunks = [flat[i:i + per] for i in range(0, flat.shape[0], per)]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(tree.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _array_from(data: bytes):
    import msgpack

    shape, name, raw = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":
        flat = torch.from_numpy(np.frombuffer(raw, np.int16).copy())
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, np.dtype(name.decode())).reshape(shape)


def _unpack_ext(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _array_from(data)
    if code == _EXT_NPSCALAR:
        a = _array_from(data)
        return a.reshape(()).item() if isinstance(a, torch.Tensor) else a[()]
    if code == _EXT_COMPLEX:
        re_, im = msgpack.unpackb(data)
        return complex(re_, im)
    raise ValueError(f"unknown msgpack extension type {code} in a parameter file")


def _unchunked(tree):
    """flax's chunked-array dicts -> arrays, everywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if any(isinstance(c, torch.Tensor) for c in chunks):
            return torch.cat([torch.as_tensor(c).reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunked(v) for k, v in tree.items()}


def save_params(path: str, params: Any, meta: dict | None = None) -> None:
    """Serialize a params tree (nested dicts of numpy arrays or tensors) +
    sidecar meta, each written to a temporary file and then renamed."""
    import msgpack

    data = msgpack.packb(_chunked(params), default=_pack_leaf, strict_types=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    if meta is not None:
        mtmp = path + ".json.tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, path + ".json")


def load_params(path: str) -> Any:
    """Restore a params tree saved by `save_params` (either package's):
    numpy arrays, bf16 leaves as `torch.bfloat16` tensors."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_unpack_ext, raw=False)
    return _unchunked(tree)


def load_meta(path: str) -> dict | None:
    side = path + ".json"
    if os.path.exists(side):
        with open(side) as f:
            return json.load(f)
    return None
