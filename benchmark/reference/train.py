"""Plain SigLIP fine-tuning of the tower: the pairwise sigmoid loss of two
views' unit embeddings (arXiv:2303.15343: t' = log 10, b = -10 at the
start), its gradient by autograd through `vit.Tower` in fp32, and AdamW
(decoupled weight decay on the tower, none on t and b) written out."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import vit

BETAS, EPS = (0.9, 0.999), 1e-8
T0, B0 = math.log(10.0), -10.0   # SigLIP's initial log temperature and bias


def siglip(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor, bias: torch.Tensor):
    logits = a @ b.t() * torch.exp(t) + bias
    labels = 2.0 * torch.eye(len(a), device=a.device) - 1.0
    return -F.logsigmoid(labels * logits).mean()


class Trainer:
    """Parameters by name (the tower's and "t", "b"), AdamW's moments, the
    step count. `mm` as `vit.Tower` takes it."""

    def __init__(self, cfg: dict, params: dict, lr: float, weight_decay: float, mm=vit.matmul):
        vit.plain_fp32()
        dev = next(iter(params.values())).device
        self.p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.p["t"] = torch.tensor(T0, device=dev, requires_grad=True)
        self.p["b"] = torch.tensor(B0, device=dev, requires_grad=True)
        self.cfg, self.lr, self.wd, self.mm = cfg, lr, weight_decay, mm
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.steps = 0

    def loss_and_grads(self, view_a, view_b):
        tower = vit.Tower(self.cfg, self.p, self.mm)
        wrap = lambda fn, x, i: checkpoint(fn, x, i, use_reentrant=False)  # noqa: E731
        a = vit.unit(tower.embed(view_a, wrap))
        b = vit.unit(tower.embed(view_b, wrap))
        loss = siglip(a, b, self.p["t"], self.p["b"])
        grads = torch.autograd.grad(loss, list(self.p.values()))
        return loss.detach(), dict(zip(self.p, grads))

    @torch.no_grad()
    def apply(self, grads: dict) -> None:
        self.steps += 1
        bc1, bc2 = 1 - BETAS[0] ** self.steps, 1 - BETAS[1] ** self.steps
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
            self.v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
            if k not in ("t", "b"):
                p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr / bc1 * self.m[k] / ((self.v[k] / bc2).sqrt() + EPS))

    def step(self, view_a, view_b):
        """(loss, the gradients the step applied)."""
        loss, grads = self.loss_and_grads(view_a, view_b)
        self.apply(grads)
        return loss, grads
