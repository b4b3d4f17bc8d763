"""Step functions of the LM zoo: what a server calls for prefill and decode.

The port's counterpart of ``repro.launch.steps`` for serving:
``make_prefill_step`` and ``make_decode_step`` return the functions a
server calls (PyTorch runs eagerly, so nothing is compiled), and
``init_params`` draws a model from a seed on a device.  Training steps
and ``input_specs`` wait for the port's LM training (ROADMAP item 9f).
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelCfg


def init_params(cfg: ModelCfg, seed: int = 0, device=None) -> M.LM:
    """A model with the reference's init distributions, drawn on
    ``device`` (default ``cuda``) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    return M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))


def make_prefill_step(cfg: ModelCfg):
    """``prefill_step(model, batch) -> (B, vocab)`` logits of each
    sequence's last position; every layer's attention goes through the
    flash-attention kernel."""
    def prefill_step(model: M.LM, batch: dict) -> torch.Tensor:
        return M.forward(model, batch, last_only=True)[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ModelCfg):
    """``serve_step(model, cache, tokens, pos) -> ((B, vocab) logits,
    cache)``; the cache is updated in place."""
    def serve_step(model: M.LM, cache: dict, tokens: torch.Tensor,
                   pos: torch.Tensor):
        logits, cache = M.decode_step(model, cache, tokens, pos)
        return logits[:, 0, :], cache

    return serve_step
