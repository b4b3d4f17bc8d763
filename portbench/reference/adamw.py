"""AdamW as the cells' training step applies it, in plain float32 PyTorch.

The rule the reference follows: the global gradient norm over every
parameter (the fan-in masks included) clipped to ``clip_norm``; masks
never updated; a masked weight's gradient and new value multiplied by its
layer's mask (``wi_gate`` and ``wi_up`` by ``mask_in``, the FFN's ``wo``
by ``mask_out``); weight decay on every leaf the stacked parameter tree
holds at rank 2 or more (a layer's vectors count one rank up, the hybrid's
one shared layer's do not); b2 0.95 and bias correction as written below.
"""

from __future__ import annotations

import torch

_MASK_OF = {"wi_gate": "mask_in", "wi_up": "mask_in", "wo": "mask_out"}
_STACKED = ("layers", "ssm_layers")


def frozen(name: str) -> bool:
    return "mask" in name


def mask_name(name: str, names) -> str | None:
    """The mask a weight is multiplied by, if its layer has one."""
    prefix, _, leaf = name.rpartition(".")
    if leaf not in _MASK_OF:
        return None
    cand = f"{prefix}.{_MASK_OF[leaf]}"
    return cand if cand in names else None


def decays(name: str, t: torch.Tensor) -> bool:
    return t.dim() + (name.split(".", 1)[0] in _STACKED) >= 2


@torch.no_grad()
def step(hp: dict, params: dict, grads: dict, m: dict, v: dict,
         t: int) -> None:
    """One update of ``params``, ``m`` and ``v`` in place at step ``t``
    (1-based).  ``hp``: lr, b1, b2, eps, weight_decay, clip_norm."""
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = min(1.0, hp["clip_norm"] / max(float(gnorm), 1e-12))
    bc1 = 1.0 - hp["b1"] ** t
    bc2 = 1.0 - hp["b2"] ** t
    for name, p in params.items():
        if frozen(name):
            continue
        mk = mask_name(name, params)
        g = grads[name] * scale
        if mk is not None:
            g = g * params[mk]
        m[name].mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
        v[name].mul_(hp["b2"]).add_((1 - hp["b2"]) * g * g)
        delta = (m[name] / bc1) / (torch.sqrt(v[name] / bc2) + hp["eps"])
        if hp["weight_decay"] > 0 and decays(name, p):
            delta = delta + hp["weight_decay"] * p
        p.sub_(hp["lr"] * delta)
        if mk is not None:
            p.mul_(params[mk])
