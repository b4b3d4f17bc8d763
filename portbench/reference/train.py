"""The reference's first training steps, and the readings the check compares."""

from __future__ import annotations

import torch

from portbench.reference import adamw
from portbench.reference.model import exact_matmuls, loss


def leaf_norms(tensors: dict) -> dict:
    """``{name: float32 norm}`` of every tensor, read in one transfer."""
    names = list(tensors)
    vals = torch.stack([tensors[n].detach().float().norm() for n in names])
    return dict(zip(names, vals.tolist()))


def follow(cfg: dict, params: dict, batches, hp: dict, initial,
           prec: str = "f32") -> dict:
    """Train ``params`` (float32, updated in place) on ``batches`` (``{"tokens",
    "labels"}``) and read what the check compares: each step's loss,
    every leaf's first gradient as AdamW takes it (clipped and masked,
    read from the first moment after step 1: m / (1 - b1)), and every
    leaf's change from ``initial()`` (the same weights drawn again) after
    the last step."""
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"losses": []}
    with exact_matmuls():
        for t, batch in enumerate(batches, 1):
            value = loss(params, cfg, batch["tokens"], batch["labels"], prec)
            grads = torch.autograd.grad(value, [params[n] for n in names])
            out["losses"].append(float(value.detach()))
            adamw.step(hp, params, dict(zip(names, grads)), m, v, t)
            del grads, value
            if t == 1:
                out["grads"] = {n: x / (1.0 - hp["b1"])
                                for n, x in leaf_norms(m).items()}
    del m, v
    out["changes"] = change_norms(params, initial())
    return out


def change_norms(params: dict, start: dict) -> dict:
    """``{name: norm of params[name] - start[name]}``, a leaf at a time."""
    names = list(params)
    vals = torch.stack([(params[n].detach().float() - start[n]).norm()
                        for n in names])
    return dict(zip(names, vals.tolist()))
