"""Contrastive fine-tuning of the vision tower (SigLIP pairwise loss).

The JAX package's trainer (`reverso_tpu/train/clip.py`) is a DP x TP
trainer on a mesh. So is this one: with `mesh=None` it trains on the
caller's device (default CUDA) as one module; with a mesh of data x model
shards (`parallel.sharding.make_mesh`) the batch is wrap-padded and cut
over "data" and the tower's weights over "model" by
`param_partition_spec` (`parallel/tensor.py::ModelShards`: one process,
the collectives device copies inside autograd). Every model shard's
attention runs K3 on its heads and every model shard's MLP K4 on its
hidden units.

On the card the tower's attention (K3) and MLP (K4) run their forward
kernels under autograd and take their gradients through hand-written
backward kernels (`ops/attention.py::FlashHeadsFunction`,
`ops/fused_mlp.py::FusedMLPFunction`); LayerNorm, LayerScale, the patch
embedding, the attention pool and the projections take PyTorch's own
autograd. On the CPU every op is its plain version, differentiated by
PyTorch.

Divergences from the JAX package: `use_flash` is accepted and ignored
(the tower routes by device, and on the card always takes K3); the JAX
trainer cannot take a step on a TPU at all, since its Pallas kernels have
no backward (ROADMAP queue 3); the model axis must divide the heads (the
JAX trainer lets XLA cut within a head).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.pe import resolve_device
from ..models.vit import VisionTransformer
from ..ops.norm import l2_normalize
from ..parallel.sharding import Mesh, shard_rows
from ..parallel.tensor import ModelShards, param_partition_spec
from ..utils.profiling import span

__all__ = ["ClipTrainer", "TrainState", "param_partition_spec", "siglip_loss"]


@dataclasses.dataclass
class TrainState:
    """The trainer's state in one layout on one device and on a mesh: whole
    tensors by parameter name."""
    params: Dict[str, torch.Tensor]   # tower parameters by name
    opt_state: Dict[str, Any]         # AdamW's state by name ("t", "b" too):
    #                                   {name: {"step", "exp_avg", "exp_avg_sq"}}
    t: torch.Tensor                   # log temperature
    b: torch.Tensor                   # logit bias (SigLIP)
    step: torch.Tensor                # int32 scalar


def siglip_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                t: torch.Tensor, b: torch.Tensor, valid=None) -> torch.Tensor:
    """Pairwise sigmoid contrastive loss over the global batch.

    `valid` [B] (0/1 float) masks PAD rows out of the pair grid: a
    wrap-padded batch duplicates rows, and a duplicate's off-diagonal
    pair is a genuine positive that the identity labels would mark -1."""
    logits = emb_a @ emb_b.T * torch.exp(t) + b          # [B, B]
    n = emb_a.shape[0]
    labels = 2.0 * torch.eye(n, dtype=logits.dtype, device=logits.device) - 1.0
    ll = F.logsigmoid(labels * logits)
    if valid is None:
        return -torch.mean(ll)
    w = valid[:, None] * valid[None, :]
    return -torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1.0)


class ClipTrainer:
    """SigLIP trainer for the vision tower, on one device or on a mesh.

    The JAX package's signature. `mesh=None` trains on `device` (default
    CUDA) as one module. A mesh (`parallel.sharding.Mesh` with the axes
    `data_axis` and `model_axis`, e.g. `make_mesh(MeshConfig(axis_sizes=(4,
    2)))`, or `devices=["cpu"] * 8`) trains data x tensor parallel over its
    devices (`ModelShards`; `device` must then be None, and the trainer's
    device is the mesh's first). `use_flash` is accepted and ignored.
    AdamW with betas (0.9, 0.999), eps 1e-8 and `weight_decay` on the
    tower, none on t and b (optax's mask), once over every parameter
    piece; t starts at log 10, b at -10."""

    def __init__(self, cfg: ModelConfig, mesh: Optional[Mesh] = None, *,
                 learning_rate: float = 1e-4, weight_decay: float = 1e-4,
                 data_axis: str = "data", model_axis: str = "model",
                 use_flash: Optional[bool] = None, seed: int = 0, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.data_axis = data_axis
        module = VisionTransformer(cfg)
        module.init_weights(torch.Generator().manual_seed(seed))
        if mesh is None:
            self.shards = None
            self.device = resolve_device(device)
            self.module = module.to(self.device)
            tower = list(self.module.parameters())
        else:
            if device is not None:
                raise ValueError("ClipTrainer: pass a mesh or a device, not both")
            self.shards = ModelShards(module, mesh, data_axis=data_axis,
                                      model_axis=model_axis)
            self.device = mesh.first
            self.module = self.shards.module
            tower = self.shards.parameters()
        f32 = dict(dtype=torch.float32, device=self.device)
        self.t = torch.nn.Parameter(torch.log(torch.tensor(10.0, **f32)))
        self.b = torch.nn.Parameter(torch.tensor(-10.0, **f32))
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        self.opt = torch.optim.AdamW(
            [{"params": tower, "weight_decay": weight_decay},
             {"params": [self.t, self.b], "weight_decay": 0.0}],
            lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def _pieces(self) -> Dict[str, list]:
        """Each parameter's pieces by name (one, where it is not cut), with
        t's and b's."""
        tower = ({name: [p] for name, p in self.module.named_parameters()}
                 if self.shards is None else self.shards.pieces)
        return {**tower, "t": [self.t], "b": [self.b]}

    def _join(self, name: str, parts) -> torch.Tensor:
        """A whole tensor of parameter `name` from its pieces' parts."""
        return parts[0] if len(parts) == 1 else self.shards.join(name, parts)

    def _split(self, name: str, whole: torch.Tensor, pieces: list) -> list:
        """A whole tensor of parameter `name` cut as its `pieces` are, each
        part on its piece's device."""
        if len(pieces) == 1:
            return [whole.to(pieces[0].device)]
        return self.shards.split(name, whole)

    @property
    def state(self) -> TrainState:
        """The state, whole tensors by name: on one device the live
        parameters and moments (no copies); on a mesh the replicated ones
        live and the cut ones joined on the mesh's first device."""
        params, moments = {}, {}
        for name, ps in self._pieces().items():
            if name not in ("t", "b"):
                params[name] = self._join(name, ps)
            st = [self.opt.state.get(p) for p in ps]
            if st[0]:
                moments[name] = {f: v if f == "step" else self._join(name, [e[f] for e in st])
                                 for f, v in st[0].items()}
        return TrainState(params=params, opt_state=moments, t=self.t, b=self.b,
                          step=self.step)

    @state.setter
    def state(self, state: TrainState) -> None:
        """Load a state (`restore_train_state`'s, or another trainer's on
        any mesh) into the trainer: copies, cut onto the pieces. The
        learning rate and weight decay stay the trainer's."""
        pieces = self._pieces()
        tower = {name: ps for name, ps in pieces.items() if name not in ("t", "b")}
        if set(state.params) != set(tower):
            raise ValueError("train state: parameter names differ from the tower's")
        if not set(state.opt_state) <= set(pieces):
            raise ValueError("train state: optimizer state for names the trainer lacks")
        with torch.no_grad():
            for name, ps in tower.items():
                for p, part in zip(ps, self._split(name, state.params[name], ps)):
                    p.copy_(part)
            self.t.copy_(state.t)
            self.b.copy_(state.b)
            self.step.copy_(state.step)
        self.opt.state.clear()
        for name, moments in state.opt_state.items():
            ps = pieces[name]
            cut = {f: self._split(name, v, ps) for f, v in moments.items() if f != "step"}
            for i, p in enumerate(ps):
                # AdamW keeps each piece's step count on the CPU (it is
                # neither capturable nor fused here) and adds to it in place
                entry = {"step": moments["step"].detach().to("cpu", copy=True)}
                entry.update({f: torch.empty_like(p).copy_(parts[i]) for f, parts in cut.items()})
                self.opt.state[p] = entry

    def shard_batch(self, batch):
        """The batch (a numpy array, any view, or a tensor) as fp32. On one
        device: the tensor on the trainer's device. On a mesh: its rows
        wrap-padded up to a multiple of the data axis as the JAX trainer
        pads them (`arange(n + pad) % n`; pad rows are masked out of the
        loss), cut into equal contiguous ranges, each on its data shard's
        home device (a `Shards`)."""
        if not isinstance(batch, torch.Tensor):
            batch = torch.as_tensor(np.ascontiguousarray(batch, np.float32))
        if self.shards is None:
            return batch.to(self.device, torch.float32)
        batch = batch.to(dtype=torch.float32)
        n = batch.shape[0]
        pad = (-n) % self.shards.grid.shape[0]
        if pad:
            batch = batch[torch.arange(n + pad, device=batch.device) % n]
        return shard_rows(batch, self.mesh, axis=self.data_axis)

    def _embed(self, views) -> torch.Tensor:
        """The L2-normalized fp32 embeddings of a view: on a mesh each data
        shard's through the tensor-parallel tower, gathered on the first
        device in data order."""
        if self.shards is None:
            return l2_normalize(self.module(views).float())
        return torch.cat([l2_normalize(self.shards.forward(x, d).float()).to(self.device)
                          for d, x in enumerate(views.parts)])

    def value_and_grad(self, view_a, view_b):
        """(loss, grads) of one step without applying it: the SigLIP loss
        of the two views' embeddings over the global batch (pad rows masked
        out) and its gradients as whole tensors by parameter name, with
        "t" and "b"."""
        n_valid = len(view_a)
        with span("train_step.upload"):
            view_a, view_b = self.shard_batch(view_a), self.shard_batch(view_b)
            n = view_a.shape[0] if self.shards is None else view_a.n
            valid = (torch.arange(n, device=self.device) < n_valid).to(torch.float32)
        with span("train_step.forward"):
            self.opt.zero_grad(set_to_none=True)
            emb_a, emb_b = self._embed(view_a), self._embed(view_b)
            loss = siglip_loss(emb_a, emb_b, self.t, self.b, valid)
        with span("train_step.backward"):
            loss.backward()
        with span("train_step.grads"):
            grads = {name: self._join(name, [p.grad for p in ps])
                     for name, ps in self._pieces().items()}
        return loss.detach(), grads

    def train_step(self, view_a, view_b) -> float:
        """One optimizer step on two augmented views [B, H, W, 3]."""
        with span("train_step"):
            loss, _ = self.value_and_grad(view_a, view_b)
            with span("train_step.optimizer"):
                self.opt.step()
            self.step += 1
            with span("train_step.sync", waits=True):
                return float(loss)
