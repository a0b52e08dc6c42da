"""Contrastive fine-tuning of the vision tower (SigLIP pairwise loss).

The JAX package's trainer (`reverso_tpu/train/clip.py`) is a DP x TP
trainer on a mesh. This port trains on one device: `mesh=None` takes the
caller's device (default CUDA), and any other mesh raises, naming ROADMAP
queue 1 item 21b (the trainer on a mesh; the indexes shard over meshes).
`param_partition_spec` still returns the tensor-parallel split per
parameter, as data for that item.

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
no backward (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.pe import resolve_device
from ..models.vit import VisionTransformer
from ..ops.norm import l2_normalize

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


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]   # tower parameters by name
    opt_state: Dict[str, Any]         # torch.optim.AdamW.state_dict()
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
    """SigLIP trainer for the vision tower on one device.

    The JAX package's signature, with `mesh=None` for the caller's
    `device` (default CUDA); a mesh raises (ROADMAP queue 1 item 21b).
    `use_flash` and the mesh axis names are accepted and ignored. AdamW with betas (0.9, 0.999),
    eps 1e-8 and `weight_decay` on the tower, none on t and b (optax's
    mask); t starts at log 10, b at -10."""

    def __init__(self, cfg: ModelConfig, mesh=None, *,
                 learning_rate: float = 1e-4, weight_decay: float = 1e-4,
                 data_axis: str = "data", model_axis: str = "model",
                 use_flash: Optional[bool] = None, seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "ClipTrainer: meshes (data and tensor parallel training) are "
                "not ported yet (ROADMAP queue 1 item 21b); pass mesh=None")
        self.cfg = cfg
        self.device = resolve_device(device)
        module = VisionTransformer(cfg)
        module.init_weights(torch.Generator().manual_seed(seed))
        self.module = module.to(self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.t = torch.nn.Parameter(torch.log(torch.tensor(10.0, **f32)))
        self.b = torch.nn.Parameter(torch.tensor(-10.0, **f32))
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        self.opt = torch.optim.AdamW(
            [{"params": list(self.module.parameters()), "weight_decay": weight_decay},
             {"params": [self.t, self.b], "weight_decay": 0.0}],
            lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    @property
    def state(self) -> TrainState:
        """The live state: the tower's parameters, the optimizer's state,
        t, b and the step (no copies)."""
        return TrainState(params=dict(self.module.named_parameters()),
                          opt_state=self.opt.state_dict(), t=self.t, b=self.b,
                          step=self.step)

    @state.setter
    def state(self, state: TrainState) -> None:
        """Load a state (`restore_train_state`'s) into the trainer in place."""
        own = dict(self.module.named_parameters())
        if set(state.params) != set(own):
            raise ValueError("train state: parameter names differ from the tower's")
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(state.params[name])
            self.t.copy_(state.t)
            self.b.copy_(state.b)
            self.step.copy_(state.step)
        self.opt.load_state_dict(state.opt_state)

    def shard_batch(self, batch) -> torch.Tensor:
        """The batch (a numpy array, any view, or a tensor) on the trainer's
        device, as fp32. One device is a data axis of size 1, so no rows
        are padded."""
        if not isinstance(batch, torch.Tensor):
            batch = torch.as_tensor(np.ascontiguousarray(batch, np.float32))
        return batch.to(self.device, torch.float32)

    def value_and_grad(self, view_a, view_b):
        """(loss, grads) of one step without applying it: the SigLIP loss
        of the two views' embeddings, each L2-normalized in fp32 after the
        tower, and its gradients by parameter name, with "t" and "b"."""
        view_a, view_b = self.shard_batch(view_a), self.shard_batch(view_b)
        valid = torch.ones(view_a.shape[0], dtype=torch.float32, device=self.device)
        self.opt.zero_grad(set_to_none=True)
        emb_a = l2_normalize(self.module(view_a).float())
        emb_b = l2_normalize(self.module(view_b).float())
        loss = siglip_loss(emb_a, emb_b, self.t, self.b, valid)
        loss.backward()
        grads = {name: p.grad for name, p in self.module.named_parameters()}
        grads.update(t=self.t.grad, b=self.b.grad)
        return loss.detach(), grads

    def train_step(self, view_a, view_b) -> float:
        """One optimizer step on two augmented views [B, H, W, 3]."""
        loss, _ = self.value_and_grad(view_a, view_b)
        self.opt.step()
        self.step += 1
        return float(loss)
