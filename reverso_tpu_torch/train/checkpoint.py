"""Checkpointing of the trainer's state, in this package's own format.

The JAX package persists its TrainState with orbax, which is JAX-only.
Here the state (the tower's parameters, AdamW's state, t, b and the step)
goes to one file through `torch.save`, written to a temporary file beside
it and renamed into place, so a reader never sees a torn checkpoint.
`restore_train_state` loads it onto the template's device (a mesh's
first device with `mesh=`): the template is the freshly initialized state
of the current trainer (`trainer.state`), and the restored state is
assigned back to it, which cuts it onto the trainer's mesh. The state is
whole tensors by parameter name (`TrainState`), so a run saved on one
mesh resumes on any other, or on one device.
"""
from __future__ import annotations

import os
from typing import Any

import torch

from .clip import TrainState


def _to(obj: Any, device) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def save_train_state(path: str, state: TrainState, *, force: bool = True) -> None:
    """Write `state` to `path` atomically (a temporary file, then a rename).
    With `force=False` an existing checkpoint is an error."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {"params": _to(state.params, "cpu"), "opt_state": _to(state.opt_state, "cpu"),
            "t": _to(state.t, "cpu"), "b": _to(state.b, "cpu"),
            "step": _to(state.step, "cpu")}
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, template: TrainState, mesh=None) -> TrainState:
    """Load the checkpoint at `path` onto the template's device (with
    `mesh`, the mesh's first device), with the template's parameter names,
    shapes and dtypes. AdamW's step counts stay on the CPU, where AdamW
    keeps them."""
    blob = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    device = template.t.device if mesh is None else mesh.first
    params = {}
    for name, ref in template.params.items():
        if name not in blob["params"]:
            raise ValueError(f"checkpoint {path} has no parameter {name}")
        p = blob["params"][name]
        if p.shape != ref.shape:
            raise ValueError(f"checkpoint {path}: {name} is {tuple(p.shape)}, "
                             f"the trainer's {tuple(ref.shape)}")
        params[name] = p.to(device=device, dtype=ref.dtype)
    if set(blob["params"]) != set(template.params):
        raise ValueError(f"checkpoint {path}: parameter names differ from the trainer's")
    names = set(template.params) | {"t", "b"}
    opt = blob["opt_state"]
    if not set(opt) <= names:
        raise ValueError(f"checkpoint {path}: optimizer state for names the trainer lacks")
    opt_state = {name: {f: v if f == "step" else _to(v, device) for f, v in e.items()}
                 for name, e in opt.items()}
    return TrainState(params=params, opt_state=opt_state,
                      t=blob["t"].to(device), b=blob["b"].to(device),
                      step=blob["step"].to(device))
