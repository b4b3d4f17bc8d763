"""Shared model building blocks: norms, RoPE, embeddings, SwiGLU FFN.

The port's counterparts of ``repro.models.layers`` (``rms_norm``,
``init_rms``, ``rope_freqs``, ``apply_rope``, ``ffn_init`` /
``ffn_apply``, ``embed_init``, ``embed_lookup``, ``lm_logits``), with the
reference's layouts and its points of rounding to the compute dtype.
Inits draw the reference's distributions from a ``torch.Generator``; its
``jax.random`` bits cannot be reproduced, so tests carry the reference's
parameters instead (``repro_torch.models.model.from_reference``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in float32, returned in ``x``'s dtype; ``scale`` is added
    to 1 (zeros at init)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def init_rms(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer.  Rotates the two halves
    of the head dim in float32; returns ``x``'s dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def normal_init(shape, std: float, gen: torch.Generator,
                dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * std
            ).to(dtype)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> dict:
    s_in = 1.0 / d_model ** 0.5
    s_out = 1.0 / d_ff ** 0.5
    return {"wi_gate": normal_init((d_model, d_ff), s_in, gen, dtype),
            "wi_up": normal_init((d_model, d_ff), s_in, gen, dtype),
            "wo": normal_init((d_ff, d_model), s_out, gen, dtype)}


_ACTS = {"silu": F.silu,
         # jax.nn.gelu's default is the tanh approximation
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


def ffn_apply(p: dict, x: torch.Tensor, act_fn: str = "silu") -> torch.Tensor:
    act = _ACTS[act_fn]
    h = act(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               tie: bool) -> dict:
    p = {"tok": normal_init((vocab, d_model), 0.02, gen, dtype)}
    if not tie:
        p["head"] = normal_init((vocab, d_model), 0.02, gen, dtype)
    return p


def embed_lookup(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p["tok"][tokens.long()].to(compute_dtype)


def lm_logits(p: dict, h: torch.Tensor, compute_dtype) -> torch.Tensor:
    w = p.get("head", p["tok"]).to(compute_dtype)
    return h @ w.t()
