"""The vision tower's parameters laid out over a mesh of data x model shards.

The JAX trainer places its parameter tree with `NamedSharding`s from
`param_partition_spec` and lets XLA insert the collectives. The port keeps
the model of a mesh in `parallel/sharding.py`: one process, a mesh an
array of `torch.device`, and the collectives become device copies inside
autograd.

Layout (`ModelShards`):

- A parameter whose spec names the model axis is cut along that dimension
  into `tp` equal contiguous pieces, the mesh's model axis size.
  Column-parallel weights (q/k/v, fc1; the port's Linear is [out, in]) are
  cut by their output rows and their biases likewise, so model shard m
  holds heads m H / tp .. (m + 1) H / tp whole; row-parallel weights
  (out_proj, fc2) are cut by their input columns. Piece m lives on the
  mesh's device at (data 0, model m).
- Every other parameter is replicated: it lives once, on `mesh.first`, as
  the tower module's own parameter. The module keeps None in place of each
  cut parameter, so it cannot run the one-device forward by mistake.
- Data shard d computes on the mesh's row d: model shard m on the device
  at (d, m), the replicated layers on (d, 0), the data shard's home.
  Pieces and replicated parameters reach those devices through `.to`
  inside autograd, so each parameter's gradient is the sum over every data
  shard that used it (the gradient all-reduce over "data"); the partial
  outputs of the model shards are summed on the home device (the
  all-reduce over "model").
- A mesh may name one device more than once: shards that share a device
  run one after another on it, `.to` copies nothing, and the pieces on
  one device stay separate tensors.
- The model axis must divide the heads and the MLP's hidden width
  (attention runs whole heads on a shard); otherwise the layout raises,
  naming both sizes.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .sharding import Mesh

_COLUMN = ("q_proj", "k_proj", "v_proj", "fc1")
_ROW = ("out_proj", "fc2")


def param_partition_spec(params: Mapping[str, Any], tp_axis: str = "model") -> Dict[str, tuple]:
    """Tensor-parallel split of each tower parameter, by name, as a tuple
    of mesh axes per dimension (the JAX package's PartitionSpecs, in this
    package's Linear layout [out, in]).

    Column-parallel: attention q/k/v (heads shard), MLP fc1: weight
    (tp, None), bias (tp,). Row-parallel: attention out_proj, MLP fc2:
    weight (None, tp). Everything else (embeddings, norms, pooling,
    projection, row-parallel biases) replicated: ()."""
    def spec_for(name: str) -> tuple:
        leaf = name.rsplit(".", 1)[-1]
        if "attn_pool" in name:
            return ()
        if any(s in name for s in _COLUMN):
            if leaf == "weight":
                return (tp_axis, None)
            if leaf == "bias":
                return (tp_axis,)
        if any(s in name for s in _ROW) and leaf == "weight":
            return (None, tp_axis)
        return ()

    return {name: spec_for(name) for name in params}


def mesh_grid(mesh: Mesh, data_axis: str = "data", model_axis: str = "model") -> np.ndarray:
    """The mesh's devices as a [data, model] array; a mesh with any other
    axis raises."""
    if sorted(mesh.axis_names) != sorted((data_axis, model_axis)):
        raise ValueError(f"mesh axes {mesh.axis_names}: the trainer takes exactly "
                         f"({data_axis!r}, {model_axis!r})")
    order = [mesh.axis_names.index(a) for a in (data_axis, model_axis)]
    return np.transpose(mesh.devices, order)


class ModelShards:
    """A tower's parameters over a mesh (the layout in the module
    docstring). `pieces[name]` is the list of a parameter's pieces in model
    order (one piece, the module's own parameter, where it is replicated);
    `dims[name]` the dimension it is cut along, or None."""

    def __init__(self, module: nn.Module, mesh: Mesh, *, data_axis: str = "data",
                 model_axis: str = "model"):
        self.grid = mesh_grid(mesh, data_axis, model_axis)
        self.first = mesh.first
        self.tp = tp = self.grid.shape[1]
        cfg = module.cfg
        hidden = int(cfg.width * cfg.mlp_ratio)
        for what, n in (("heads", cfg.num_heads), ("hidden units of the MLP", hidden)):
            if n % tp:
                raise ValueError(f"a model axis of {tp} shards does not divide the {n} {what}")
        self.module = module.to(self.first)
        self.spec = param_partition_spec(dict(module.named_parameters()), model_axis)
        self.pieces: Dict[str, list] = {}
        self.dims: Dict[str, Any] = {}
        self._names: Dict[tuple, str] = {}     # (Linear module, leaf) -> name
        for name, p in list(module.named_parameters()):
            spec = self.spec[name]
            dim = spec.index(model_axis) if model_axis in spec else None
            self.dims[name] = dim
            if dim is None:
                self.pieces[name] = [p]
                continue
            with torch.no_grad():
                self.pieces[name] = [
                    nn.Parameter(torch.empty(c.shape, dtype=c.dtype, device=dev).copy_(c))
                    for c, dev in zip(p.chunk(tp, dim), self.grid[0])]
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            setattr(owner, leaf, None)
            self._names[(owner, leaf)] = name

    def parameters(self) -> list:
        """Every piece, in the tower's parameter order."""
        return [p for ps in self.pieces.values() for p in ps]

    def split(self, name: str, whole: torch.Tensor) -> list:
        """A whole tensor of parameter `name`'s shape cut as its pieces are,
        each part on its piece's device."""
        ps = self.pieces[name]
        if self.dims[name] is None:
            return [whole.to(ps[0].device)]
        return [c.to(p.device) for c, p in zip(whole.chunk(self.tp, self.dims[name]), ps)]

    def join(self, name: str, parts) -> torch.Tensor:
        """Parameter `name`'s whole tensor from its pieces' `parts` (the
        pieces themselves, their gradients or their moments), on
        `mesh.first`; a replicated parameter's one part as it is."""
        if self.dims[name] is None:
            return parts[0]
        return torch.cat([t.to(self.first) for t in parts], self.dims[name])

    def gather(self) -> Dict[str, torch.Tensor]:
        """The whole parameters by name (replicated ones live, cut ones
        joined on `mesh.first`)."""
        return {name: self.join(name, ps) for name, ps in self.pieces.items()}

    def scatter(self, whole: Mapping[str, torch.Tensor]) -> None:
        """Copy whole parameters by name (a state dict,
        `vision_params_from_flax`'s or a checkpoint's) into the pieces."""
        if set(whole) != set(self.pieces):
            raise ValueError("parameter names differ from the tower's")
        with torch.no_grad():
            for name, ps in self.pieces.items():
                for p, part in zip(ps, self.split(name, whole[name])):
                    p.copy_(part)

    def forward(self, images: torch.Tensor, d: int) -> torch.Tensor:
        """The tower over data shard d's images (on its home device): the
        replicated layers with their parameters on the home device, each
        block's attention and MLP by model shard (`DataShard`)."""
        shard = DataShard(self, d)
        home = shard.devices[0]
        replicated = {name: ps[0].to(home) for name, ps in self.pieces.items()
                      if self.dims[name] is None}
        return functional_call(self.module, replicated, (images,), {"tp": shard})


class DataShard:
    """One data shard's view of a `ModelShards`: its devices by model
    index (the first is its home), the pieces of the cut Linears on them,
    and the sum of the model shards' partial outputs."""

    def __init__(self, shards: ModelShards, d: int):
        self.shards = shards
        self.devices = list(shards.grid[d])
        self.size = len(self.devices)

    def piece(self, linear: nn.Module, leaf: str, m: int) -> torch.Tensor:
        """The resident piece m of a cut Linear's `leaf` ("weight", "bias")."""
        return self.shards.pieces[self.shards._names[(linear, leaf)]][m]

    def column(self, linear: nn.Module, m: int) -> tuple:
        """A column-parallel Linear's weight and bias pieces m on model
        shard m's device."""
        dev = self.devices[m]
        return self.piece(linear, "weight", m).to(dev), self.piece(linear, "bias", m).to(dev)

    def row(self, linear: nn.Module, m: int) -> torch.Tensor:
        """A row-parallel Linear's weight piece m on model shard m's device
        (its bias is replicated: the module's own)."""
        return self.piece(linear, "weight", m).to(self.devices[m])

    def reduce(self, partials: list) -> torch.Tensor:
        """The model shards' partial outputs summed on the home device in
        model order, in fp32, cast back to their dtype."""
        home, dt = self.devices[0], partials[0].dtype
        return functools.reduce(torch.add, (p.to(home, torch.float32) for p in partials)).to(dt)
