"""Fine-tuning the tower: a closed loop of optimizer steps, each
`ClipTrainer.train_step(view_a, view_b)` on two seeded views of `batch`
images (the second a mirror of the first plus N(0, 0.02^2) noise, as
the CLI makes them), ending in the loss on the host.

Traffic keys: `batch` (images a view), `pool` (distinct view pairs,
cycled), `lr`, `weight_decay`, `check_steps` (the first steps, which
set-up drives through the same call and the reference follows).

Set-up builds one trainer, loads the seeded weights into it and takes
its first `check_steps` steps on pairs whose rows all differ; the window
goes on with the same trainer. Read from the program, as far as the next
step keeps them: each step's loss, the first gradient as AdamW holds it
after step 1 (its first moment over 1 - beta1), and each parameter's
change after the last checked step. `reference/train.py` follows the
same steps in fp32. Numbers (each by the worst leaf, against the larger
of that leaf's reference norm and the median leaf's): `loss_gap`, the
largest relative gap of a step's loss; `grad_gap`, the gap between the
norms of a leaf's first gradient; `delta_gap`, between the norms of a
leaf's change. Leaves whose reference gradient is under a thousandth of
the median leaf's move by round-off alone and are left out of both (a
key projection's bias under softmax). The control is the reference with
its products in fp8 in the program's place.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from harness import device, program, weights
from reference import train as ref
from reference import vit

UNITS = "steps"
# a leaf is left out where its reference gradient is under this share of
# the median leaf's
NEGLIGIBLE = 1e-3


def views(cell, dev):
    """[(view_a, view_b)] of `pool` seeded pairs on the card."""
    t, size = cell.traffic, cell.config["image_size"]
    n = t["pool"] * t["batch"]
    a = weights.images(n, size, cell.seed, weights.IMAGES, dev)
    g = weights.generator(cell.seed, weights.VIEWS, dev)
    b = a.flip(2) + 0.02 * torch.randn(a.shape, generator=g, device=dev)
    return list(zip(a.split(t["batch"]), b.contiguous().split(t["batch"])))


class ControlTrainer:
    """The reference in the program's place, its products in fp8."""

    def __init__(self, cell, params):
        t = cell.traffic
        self.r = ref.Trainer(cell.config, params, t["lr"], t["weight_decay"],
                             mm=vit.lowp(torch.float8_e4m3fn))

    def train_step(self, view_a, view_b) -> float:
        return float(self.r.step(view_a, view_b)[0])

    def first_grads(self) -> dict:
        return {k: m / (1 - ref.BETAS[0]) for k, m in self.r.m.items()}

    def params(self) -> dict:
        return {k: v.detach() for k, v in self.r.p.items()}


class ProgramTrainer:
    """`ClipTrainer` on one card with the seeded weights loaded."""

    def __init__(self, cell, params):
        from reverso_tpu_torch.train.clip import ClipTrainer

        t = cell.traffic
        self.tr = ClipTrainer(program.model_config(cell.config), learning_rate=t["lr"],
                              weight_decay=t["weight_decay"], device=params["proj.weight"].device)
        self.tr.module.load_state_dict(params)

    def train_step(self, view_a, view_b) -> float:
        return self.tr.train_step(view_a, view_b)

    def first_grads(self) -> dict:
        return {k: s["exp_avg"] / (1 - ref.BETAS[0])
                for k, s in self.tr.state.opt_state.items()}

    def params(self) -> dict:
        st = self.tr.state
        return {**st.params, "t": st.t.detach(), "b": st.b.detach()}


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


class Train:
    def __init__(self, cell, control: bool = False):
        self.cell = cell
        dev = torch.device(cell.device)
        self.pairs = views(cell, dev)
        params = weights.seeded_tower(cell, dev)
        self.tr = ControlTrainer(cell, params) if control else ProgramTrainer(cell, params)
        del params
        self.losses, self.grads, self.deltas = [], None, None

    @torch.no_grad()
    def _changes(self) -> dict:
        """Each parameter's change since the seeded start, its norm taken in
        fp64 on the device that holds it."""
        dev = torch.device(self.cell.device)
        start = weights.seeded_tower(self.cell, dev)
        start.update(t=torch.tensor(ref.T0, device=dev), b=torch.tensor(ref.B0, device=dev))
        now = self.tr.params()
        return {k: float((now[k].double() - start[k].double()).norm()) for k in now}

    def warm_up(self) -> None:
        """The first steps, through the window's own call: what the
        reference follows is read here."""
        steps = self.cell.traffic["check_steps"]
        for i in range(steps):
            self.call(i)
            if i == 0:
                self.grads = leaf_norms(self.tr.first_grads())
        self.deltas = self._changes()

    def call(self, i: int) -> int:
        a, b = self.pairs[i % len(self.pairs)]
        loss = self.tr.train_step(a, b)
        if len(self.losses) < self.cell.traffic["check_steps"]:
            self.losses.append(loss)
        return 1

    def check(self) -> list:
        cell, dev = self.cell, torch.device(self.cell.device)
        del self.tr
        device.free_cache()
        t = cell.traffic
        r = ref.Trainer(cell.config, weights.seeded_tower(cell, dev), t["lr"], t["weight_decay"])
        losses, grads = [], None
        start = {k: v.detach().clone() for k, v in r.p.items()}
        for i in range(t["check_steps"]):
            loss, g = r.step(*self.pairs[i % len(self.pairs)])
            losses.append(float(loss))
            if i == 0:
                grads = leaf_norms(g)
        deltas = {k: float((r.p[k].detach().double() - start[k].double()).norm())
                  for k in start}
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, losses))
        grad_gap, delta_gap = leaf_gaps(self.grads, self.deltas, grads, deltas)
        return [("loss_gap", loss_gap, cell.limits["loss_gap"]),
                ("grad_gap", grad_gap, cell.limits["grad_gap"]),
                ("delta_gap", delta_gap, cell.limits["delta_gap"])]


def leaf_gaps(p_grads: dict, p_deltas: dict, r_grads: dict, r_deltas: dict) -> tuple:
    """(grad_gap, delta_gap): by the worst leaf, |program norm - reference
    norm| over the larger of the reference leaf's norm and the median
    leaf's, over the leaves whose reference gradient is not negligible."""
    med = float(np.median(list(r_grads.values())))
    keep = [k for k, v in r_grads.items() if v >= NEGLIGIBLE * med]
    if set(p_grads) != set(r_grads) or set(p_deltas) != set(r_deltas):
        return float("inf"), float("inf")
    med_d = float(np.median([r_deltas[k] for k in keep]))
    grad_gap = max(abs(p_grads[k] - r_grads[k]) / max(r_grads[k], med) for k in keep)
    delta_gap = max(abs(p_deltas[k] - r_deltas[k]) / max(r_deltas[k], med_d) for k in keep)
    return grad_gap, delta_gap


@contextlib.contextmanager
def _patched_step(step):
    from reverso_tpu_torch.train.clip import ClipTrainer

    produce = ClipTrainer.train_step
    ClipTrainer.train_step = lambda self, a, b: step(self, produce, a, b)
    try:
        yield
    finally:
        ClipTrainer.train_step = produce


def frozen_state():
    """Fault: a step that returns its state unchanged (the loss and the
    gradients computed, no update applied)."""
    def step(self, produce, view_a, view_b):
        loss, _ = self.value_and_grad(view_a, view_b)
        self.step += 1
        return float(loss)

    return _patched_step(step)


def half_batch():
    """Fault: half of the batch left out, the mean taken over the rest."""
    def step(self, produce, view_a, view_b):
        n = len(view_a) // 2
        return produce(self, view_a[:n], view_b[:n])

    return _patched_step(step)


# faults a run of this entry can have, planted in the program
FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch}


def setup(cell, control: bool = False) -> Train:
    return Train(cell, control)


def end_to_end(work: dict, seconds: float) -> dict:
    return {"train_step_ms": seconds / work[UNITS] * 1e3}
