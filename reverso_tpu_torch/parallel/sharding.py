"""Meshes of torch devices, and row shards over them.

The JAX package makes one mesh over every local device in one process
(`jax.sharding.Mesh`, its `make_mesh`), row-shards a store over the
mesh's "data" axis, runs each search under `shard_map` and merges the
shards' candidates with `all_gather`. The port keeps the one process: a
`Mesh` is an array of `torch.device` with axis names, a row-sharded
matrix is a `Shards` (one contiguous row range per shard, each tensor on
its shard's device), and a sharded search runs each shard's scan on its
device (launches are asynchronous, so shards on different cards
overlap), copies the k-sized candidates of every shard to the mesh's
first device (the `all_gather`) and merges them there in one
(-score, global id) order (`ops/topk.py::merge_topk`).

Shards are contiguous: shard p of P holds rows [p * L, min((p + 1) * L,
n)) with L = ceil(n / P), each with its own valid count; a trailing
shard may hold no rows. Rows are not padded to a multiple of the mesh
(the JAX package's TPU tiles need that; the port's kernels take any row
count). A mesh may name one device more than once: several shards then
share that device (on the CPU, or on one card), where a JAX mesh holds
each device once.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import MeshConfig


def local_devices() -> list[torch.device]:
    """Every visible CUDA device, in order (the default mesh's devices)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An n-d array of `torch.device` with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices {devices.shape} do not match axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """The device the shards' candidates merge on."""
        return self.devices.flat[0]

    def shard_devices(self, axes: Sequence[str] = ("data",)) -> list[torch.device]:
        """The devices rows shard over when they shard over `axes` (row-major
        over those axes; the other axes at index 0: a shard is replicated
        along them, and its first replica scans)."""
        idx = tuple(slice(None) if name in axes else 0 for name in self.axis_names)
        sub = self.devices[idx]
        order = [name for name in self.axis_names if name in axes]
        missing = set(axes) - set(order)
        if missing:
            raise ValueError(f"mesh axes {self.axis_names} lack {sorted(missing)}")
        perm = [order.index(name) for name in axes]
        return list(np.transpose(sub, perm).reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the given devices (default: `local_devices()`), sized by
    `cfg` as the JAX package sizes it (-1: the remaining devices); raises
    when the sizes do not match the devices. `devices` may repeat one."""
    cfg = cfg or MeshConfig()
    devs = list(devices) if devices is not None else local_devices()
    if not devs:
        raise RuntimeError("make_mesh: no device (no CUDA card is visible; pass "
                           "devices= for a mesh on the CPU)")
    sizes = cfg.resolved_sizes(len(devs))
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return Mesh(arr.reshape(sizes), cfg.axis_names)


def on_device(dev: torch.device):
    """A context that makes `dev` the current CUDA device (a kernel's
    launcher launches on the current device); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def local_row_count(total_rows: int, mesh: Mesh, axis: str = "data") -> int:
    """Rows of every shard but the last: ceil(total_rows / shards)."""
    return max(1, -(-int(total_rows) // mesh.shape[axis]))


def row_ranges(n: int, n_shards: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of n_shards contiguous shards of n rows (the last
    ones may be empty)."""
    local = max(1, -(-n // n_shards))
    return [(min(p * local, n), min((p + 1) * local, n)) for p in range(n_shards)]


@dataclass
class Shards:
    """A row-sharded matrix: `parts[p]` holds global rows `starts[p]` ..
    `starts[p] + len(parts[p])` on its own device."""
    parts: list
    starts: list
    n: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.parts)

    def local_valid(self, n_valid: Optional[int] = None) -> list[int]:
        """Each shard's valid rows when the first `n_valid` rows are valid."""
        n_valid = self.n if n_valid is None else int(n_valid)
        return [max(0, min(n_valid - s, len(t))) for s, t in zip(self.starts, self.parts)]

    def slices(self, x: torch.Tensor) -> list:
        """A global [n, ...] tensor cut into the shards' ranges, each piece
        on its shard's device."""
        return [x[s:s + len(t)].to(t.device) for s, t in zip(self.starts, self.parts)]


def empty_shards(n: int, width: int, dtype, mesh: Mesh, axis: str = "data") -> Shards:
    """Zeroed [rows, width] shards of n rows over the mesh's `axis`."""
    devs = mesh.shard_devices((axis,))
    ranges = row_ranges(n, len(devs))
    return Shards([torch.zeros((hi - lo, width), dtype=dtype, device=dev)
                   for (lo, hi), dev in zip(ranges, devs)], [lo for lo, _ in ranges], n)


def shard_rows(x, mesh: Mesh, axis="data") -> Shards:
    """A [n, ...] tensor or host array row-sharded over `axis` (a name, or
    a tuple of names: rows shard over those axes, row-major): contiguous
    ranges, one per shard, each copied to its shard's device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    devs = mesh.shard_devices(axis if isinstance(axis, tuple) else (axis,))
    ranges = row_ranges(t.shape[0], len(devs))
    return Shards([t[lo:hi].to(dev).contiguous() for (lo, hi), dev in zip(ranges, devs)],
                  [lo for lo, _ in ranges], t.shape[0])


def replicate(x, mesh: Mesh) -> dict:
    """A tensor (or host array) copied once to each distinct device of the
    mesh: {device: tensor}."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    out = {}
    for dev in mesh.devices.flat:
        if dev not in out:
            out[dev] = t.to(dev)
    return out
