"""int8 gradient compression with error feedback: the port of
``repro.optim.compress``.

Per-tensor int8 codes and one float32 scale each; the quantization
residual is carried to the next step, so the compression bias vanishes in
expectation (the 1-bit-Adam argument).  The round trip models what a
gradient reduction would carry on the wire.  Works over the port's
``{name: tensor}`` dicts.

Two details keep the codes and scales the reference's bit for bit:

* ``torch.round`` and ``jnp.round`` both round half to even;
* every division is a true division by a 0-dim tensor on the gradient's
  device: on the card, a Python or CPU-scalar divisor becomes a
  multiplication by its reciprocal, which moves a code that lies on a
  rounding half-way point.
"""

from __future__ import annotations

import torch


def init_error_state(params: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    """A float32 zero residual for every tensor, on its device."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: int8 codes in [-127, 127] and the 0-dim float32
    scale ``max(max|g|, 1e-12) / 127``, with ``q = round(g / scale)``."""
    g = g.float()
    scale = torch.clamp(g.abs().max(), min=1e-12) / g.new_full((), 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_with_feedback(grads: dict[str, torch.Tensor],
                                 err: dict[str, torch.Tensor]
                                 ) -> tuple[dict, dict]:
    """Returns (the decompressed gradients, as a reduction would deliver
    them; the new error state): each gradient plus its residual goes
    through the int8 round trip, and what the round trip lost is the next
    residual."""
    deq, new_err = {}, {}
    for k, g in grads.items():
        g = g.float() + err[k]
        q, s = compress_int8(g)
        deq[k] = decompress_int8(q, s)
        new_err[k] = g - deq[k]
    return deq, new_err
