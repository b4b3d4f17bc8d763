"""Shared model building blocks: norms, RoPE, embeddings, SwiGLU FFN and
the LogicNet-FFN.

The port's counterparts of ``repro.models.layers`` (``rms_norm``,
``init_rms``, ``rope_freqs``, ``apply_rope``, ``apply_mrope``, ``ffn_init`` /
``ffn_apply``, ``logicnet_ffn_init`` / ``logicnet_ffn_apply``,
``embed_init``, ``embed_lookup``, ``lm_logits``), with the reference's
layouts and its points of rounding to the compute dtype.
Inits draw the reference's distributions from a ``torch.Generator``; its
``jax.random`` bits cannot be reproduced, so tests carry the reference's
parameters instead (``repro_torch.models.model.from_reference``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QuantizerCfg, quantize
from repro_torch.core.sparsity import apriori_mask
from repro_torch.kernels.masked_matmul import (MaskedMatmulFn,
                                               logicnet_ffn_route,
                                               masked_matmul_swiglu_quant,
                                               quant_relu)
from repro_torch.models.config import LogicNetFFNCfg
from repro_torch.parallel.local import (any_dtensor, gather_fsdp,
                                        replicate_like, vocab_embed)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             mean_sq=None) -> torch.Tensor:
    """Computed in float32, returned in ``x``'s dtype; ``scale`` is added
    to 1 (zeros at init).  ``mean_sq``, if given, maps the mean of squares
    of ``x``'s last dimension to the one to normalise by (a tensor-
    parallel rank's share of it summed over its group)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    if mean_sq is not None:
        var = mean_sq(var)
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
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """The two halves of the head dim of ``x`` (B, S, H, D) rotated by
    ``angles`` (B, S, D/2), in float32; returns ``x``'s dtype."""
    cos = replicate_like(torch.cos(angles)[:, :, None, :], x)
    sin = replicate_like(torch.sin(angles)[:, :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int, sections=(16, 24, 24)) -> list[int]:
    """Frequency slots of each M-RoPE stream (t, h, w): ``sections`` (the
    published half-dims for head_dim 128) scaled by ``half // total``, at
    least 1 each, the last taking what the first two leave: ``[16, 24,
    24]`` at 128, ``[2, 3, 3]`` at 16."""
    half = head_dim // 2
    total = sum(sections)
    sec = [max(1, s * half // total) for s in sections]
    sec[-1] = half - sec[0] - sec[1]
    return sec


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL's M-RoPE: x (B, S, H, D); positions (B, S, 3) integer, the
    (t, h, w) streams.  Frequency slot ``j`` takes its angle from the
    stream :func:`mrope_sections` gives it, then the rotation of
    :func:`apply_rope`."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    stream = torch.tensor([i for i, n in enumerate(mrope_sections(
        d, sections)) for _ in range(n)], device=x.device)
    pos = positions.index_select(-1, stream).float()           # (B, S, D/2)
    return _rotate(x, pos * freqs)


def normal_init(shape, std: float, gen: torch.Generator,
                dtype) -> torch.Tensor:
    if gen.device.type == "meta":
        # shapes only (``models.model.param_shapes``): nothing to draw
        return torch.empty(shape, dtype=dtype, device="meta")
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


def logicnet_masks(d_model: int, d_ff: int, cfg: LogicNetFFNCfg,
                   seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The LogicNet-FFN's fan-in masks, float32 on the CPU: ``mask_in``
    (d_model, d_ff), every hidden neuron reading ``min(fan_in, d_model)``
    inputs, and ``mask_out`` (d_ff, d_model), from ``apriori_mask`` at
    ``seed`` and ``seed + 1`` (numpy, so the reference's masks)."""
    return (apriori_mask(seed, d_model, d_ff, min(cfg.fan_in, d_model)),
            apriori_mask(seed + 1, d_ff, d_model, min(cfg.fan_in, d_ff)))


def logicnet_ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
                      masks: tuple, dtype=torch.float32) -> dict:
    """FFN with per-neuron fan-in masks and activation fake-quant: the
    SwiGLU weights of :func:`ffn_init` plus ``mask_in`` and ``mask_out``,
    copies of ``masks`` (:func:`logicnet_masks`) on ``gen``'s device.  The
    reference draws the masks once at seed 0 for every layer (its init is
    one ``vmap`` call), so the caller computes them once for all layers."""
    mask_in, mask_out = masks
    p = ffn_init(gen, d_model, d_ff, dtype)
    p["mask_in"] = mask_in.to(device=gen.device, dtype=dtype, copy=True)
    p["mask_out"] = mask_out.to(device=gen.device, dtype=dtype, copy=True)
    return p


def logicnet_ffn_apply(p: dict, x: torch.Tensor, cfg: LogicNetFFNCfg,
                       act_fn: str = "silu") -> torch.Tensor:
    """``quantize(h) @ (wo * mask_out)`` with ``h = act(xq @ (wi_gate *
    mask_in)) * (xq @ (wi_up * mask_in))`` and ``xq = quantize(x)``: the
    quantizers run in float32 and their outputs return to ``x``'s dtype,
    as in the reference.  The ``wo`` product is one
    :class:`MaskedMatmulFn` call on the (rows, features) view of ``hq``.
    The ``wi`` stage takes the path ``kernels.masked_matmul.
    logicnet_ffn_route`` names (``logicnet_ffn_apply.paths`` counts each
    call's): ``"fused"`` (bfloat16 on the card without a gradient to take)
    is two launches, the input quantizer and the fused products, SiLU and
    quantizer; ``"composed"`` (training, float32, the CPU, meshes, other
    activations or quantizers) runs each step as its own op, each masked
    product a :class:`MaskedMatmulFn` call, so on the card every product
    (and its input gradient) is a masked-matmul kernel launch.  Both give
    the same ``hq`` bit for bit."""
    q = QuantizerCfg(cfg.bw, cfg.max_val)
    lead = x.shape[:-1]
    ops = (x, p["wi_gate"], p["wi_up"], p["mask_in"])
    route = logicnet_ffn_route(
        x.device.type, x.dtype, *p["wi_gate"].shape, q.bit_width, act_fn,
        dtensor=any_dtensor(*ops),
        needs_grad=(torch.is_grad_enabled()
                    and any(t.requires_grad for t in ops)))
    logicnet_ffn_apply.paths[route] += 1
    if route == "fused":
        hq = masked_matmul_swiglu_quant(
            quant_relu(x.reshape(-1, x.shape[-1]), q), p["wi_gate"],
            p["wi_up"], p["mask_in"], q)
    else:
        act = _ACTS[act_fn]
        xq = quantize(q, x.float()).value.to(x.dtype).reshape(-1, x.shape[-1])
        h = act(MaskedMatmulFn.apply(xq, p["wi_gate"], p["mask_in"])) \
            * MaskedMatmulFn.apply(xq, p["wi_up"], p["mask_in"])
        hq = quantize(q, h.float()).value.to(x.dtype)
    return MaskedMatmulFn.apply(hq, p["wo"], p["mask_out"]).reshape(
        *lead, p["wo"].shape[1])


logicnet_ffn_apply.paths = {"fused": 0, "composed": 0}


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               tie: bool) -> dict:
    p = {"tok": normal_init((vocab, d_model), 0.02, gen, dtype)}
    if not tie:
        p["head"] = normal_init((vocab, d_model), 0.02, gen, dtype)
    return p


def embed_lookup(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """On a mesh, the vocab-parallel lookup (``parallel.local.
    vocab_embed``) of the table gathered over the FSDP axes."""
    if any_dtensor(p["tok"], tokens):
        return vocab_embed(gather_fsdp(p["tok"]),
                           tokens.long()).to(compute_dtype)
    return p["tok"][tokens.long()].to(compute_dtype)


def lm_logits(p: dict, h: torch.Tensor, compute_dtype) -> torch.Tensor:
    """On a mesh the head is gathered over the FSDP axes and stays
    vocab-sharded: the logits come out sharded over the vocab."""
    w = gather_fsdp(p.get("head", p["tok"]).to(compute_dtype))
    return h @ w.t()
