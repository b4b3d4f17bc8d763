"""AdamW written out by hand: the port of ``repro.optim.adamw``.

Not ``torch.optim.AdamW``: the reference uses b2 = 0.95, clips the global
gradient norm first, and multiplies a leaf's mask into its gradient *and*
into its updated value, keeping pruned weights exactly zero.

* m/v moments in float32 regardless of the parameter's dtype.
* Name-based policies over a ``{name: tensor}`` dict of parameters:
  ``freeze_fn(name) -> bool`` skips a leaf (default: any name mentioning
  'mask'); ``mask_fn(name, params) -> tensor | None`` gives a leaf's mask;
  ``decay_fn(name, p) -> bool`` says whether it takes weight decay
  (default: the reference's rule, ``p.dim() >= 2``).
* Parameters, moments and the step count are updated in place; the step
  count and every per-step scalar stay on the parameters' device, so an
  update never waits for the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None


def default_freeze(name: str) -> bool:
    return "mask" in name


def default_decay(name: str, p: torch.Tensor) -> bool:
    """The reference's weight-decay rule: matrices and higher-rank leaves
    decay, vectors and scalars do not."""
    return p.dim() >= 2


def init_opt_state(params: dict[str, torch.Tensor]) -> dict:
    """Zero moments for every parameter and a 0 step count (int32)."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of their float32 sums of squares."""
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tensors]).sum())


def adamw_update(cfg: AdamWCfg, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict,
                 mask_fn: Callable[[str, dict], torch.Tensor | None]
                 | None = None,
                 freeze_fn: Callable[[str], bool] = default_freeze,
                 decay_fn: Callable[[str, torch.Tensor], bool] | None = None
                 ) -> None:
    """One AdamW step over ``params`` in place (moments and step too)."""
    decay_fn = decay_fn or default_decay
    with torch.no_grad():
        state["step"] += 1
        step = state["step"].float()
        lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
        gnorm = global_norm(grads.values())
        # a true division: ``float / tensor`` would multiply by a reciprocal
        scale = (torch.clamp(gnorm.new_full((), cfg.clip_norm)
                             / torch.clamp(gnorm, min=1e-12), max=1.0)
                 if cfg.clip_norm > 0 else gnorm.new_ones(()))
        bc1 = 1.0 - torch.pow(step.new_full((), cfg.b1), step)
        bc2 = 1.0 - torch.pow(step.new_full((), cfg.b2), step)
        for name, p in params.items():
            if freeze_fn(name):
                continue
            mask = mask_fn(name, params) if mask_fn is not None else None
            g = grads[name].float() * scale
            if mask is not None:
                g = g * mask.float()
            m, v = state["m"][name], state["v"][name]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay > 0 and decay_fn(name, p):
                delta = delta + cfg.weight_decay * p.float()
            new_p = p.float() - lr * delta
            if mask is not None:
                new_p = new_p * mask.float()
            p.copy_(new_p)


def cosine_schedule(warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warmup to 1, then a cosine decay to ``floor`` at ``total``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return fn


_LOGICNET_WEIGHTS = {"wi_gate": "mask_in", "wi_up": "mask_in",
                     "wo": "mask_out"}


def logicnet_mask_fn(name: str, params: dict[str, torch.Tensor]
                     ) -> torch.Tensor | None:
    """Mask rule for LM-scale LogicNet-FFN layers: a weight named
    ``<prefix>.wi_gate`` / ``wi_up`` / ``wo`` whose sibling mask
    ``<prefix>.mask_in`` (``mask_out`` for ``wo``) is in ``params`` gets
    that mask (``layers.3.ffn.wo`` -> ``layers.3.ffn.mask_out``); any other
    name gets None.  The reference resolves the sibling by its pytree path
    (``['layers']['ffn']['wo']``); the port's parameters are one flat dict
    of dotted names."""
    prefix, _, leaf = name.rpartition(".")
    if leaf not in _LOGICNET_WEIGHTS:
        return None
    return params.get(f"{prefix}.{_LOGICNET_WEIGHTS[leaf]}" if prefix
                      else _LOGICNET_WEIGHTS[leaf])
