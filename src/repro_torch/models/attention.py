"""GQA attention: prefill through the flash-attention kernel, training
through the chunked attention, cached decode, cross-attention.

The port's counterpart of ``repro.models.attention``: ``attn_init``,
``_project_qkv``, ``_chunked_attention``, ``attn_apply``, ``attn_decode``,
``cross_memory`` and ``cross_attn_apply``.  The reference computes
full-sequence attention with its pure-XLA ``_chunked_attention``, the same
function its Pallas ``flash_attention`` kernel computes.  Here ``attn_apply`` calls the
port's counterpart of that kernel (``repro_torch.kernels.flash_attention``,
which launches on the card) for prefill; with ``train=True`` it calls
``_chunked_attention`` in differentiable torch ops, as the reference
trains through its XLA version: the flash kernel has no backward, in
either package.  Decode attends one query per row against the KV cache
with ``_chunked_attention``, as the reference does in XLA.

Supports qk-norm (qwen3), sliding windows with gemma3's per-layer
local/global mix (window 0 = global), M-RoPE (qwen2-vl: positions
(B, S, 3)) and cross-attention (whisper's decoder against its encoder's
memory, through the flash kernel at ``Sq != Skv`` in prefill and decode).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelCfg
from repro_torch.models.layers import (apply_mrope, apply_rope, init_rms,
                                       normal_init, rms_norm)

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelCfg,
              dtype=torch.float32) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = 1.0 / d ** 0.5
    p = {"wq": normal_init((d, cfg.n_heads, hd), s, gen, dtype),
         "wk": normal_init((d, cfg.n_kv_heads, hd), s, gen, dtype),
         "wv": normal_init((d, cfg.n_kv_heads, hd), s, gen, dtype),
         "wo": normal_init((cfg.n_heads, hd, d), s, gen, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, gen.device)
        p["k_norm"] = init_rms(hd, gen.device)
    return p


def _project_qkv(p: dict, cfg: ModelCfg, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, D) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd);
    ``positions`` (B, S), or (B, S, 3) with ``cfg.mrope``."""
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    rope = apply_mrope if cfg.mrope else apply_rope
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset, window: int, causal: bool, chunk: int,
                       kv_len_valid=None) -> torch.Tensor:
    """Online softmax over KV chunks, in float32; output in q's dtype.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D).  ``window`` 0 = global.
    ``q_offset`` and ``kv_len_valid`` (valid cache slots; None = all) may be
    0-d tensors.  As in the reference, where ``chunk`` does not divide
    ``Skv`` the last chunk's slice is clamped to end at ``Skv`` (XLA's
    ``dynamic_slice``) while its key positions are not.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / d ** 0.5
    qf = (q.float() * scale).reshape(b, sq, hkv, group, d)
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        off = ci * chunk
        start = min(off, skv - chunk)
        kc = k[:, start:start + chunk].float()
        vc = v[:, start:start + chunk].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc)        # (B,Hkv,G,Sq,C)
        kpos = off + torch.arange(chunk, device=dev)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len_valid is not None:
            mask &= kpos[None, :] < kv_len_valid
        else:
            mask &= kpos[None, :] < skv
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return out.to(q.dtype)


def attn_apply(p: dict, cfg: ModelCfg, x: torch.Tensor,
               positions: torch.Tensor, window: int = 0,
               causal: bool = True, train: bool = False) -> torch.Tensor:
    """Full-sequence attention: prefill through the flash kernel, or with
    ``train`` through the differentiable ``_chunked_attention`` in chunks
    of ``cfg.attn_chunk`` keys (the flash kernel raises on inputs that
    require grad; the chunked form computes the true function where the
    chunk divides the sequence or is at least as long, ROADMAP §3).

    The model holds heads as (B, S, H, D); the kernel takes (B, H, S, D)
    views, so q, k and v go in as transposed views, without copies, and the
    bfloat16 kernel writes its output straight into a (B, S, H, D) buffer
    (``out.transpose(1, 2)`` below is then that buffer).  The layer's
    window 0 (global) is the kernel's ``window=None``.
    """
    q, k, v = _project_qkv(p, cfg, x, positions)
    if train:
        out = _chunked_attention(q, k, v, q_offset=0, window=window,
                                 causal=causal, chunk=cfg.attn_chunk)
    else:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window if window > 0 else None
                              ).transpose(1, 2)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def attn_decode(p: dict, cfg: ModelCfg, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, window: int = 0):
    """One-token decode against a KV cache; returns (out, cache_k, cache_v).

    x: (B, 1, D); cache_{k,v}: (B, S_cache, Hkv, hd), written in place (the
    reference returns new arrays); pos: (B,) integer, tokens already in
    the cache.  RoPE and the ``onehot`` write use each row's own position
    (M-RoPE at ``(p, p, p)``: decode emits text tokens, as in the
    reference);
    ``dus`` writes every row at ``pos[0]`` (clamped into the cache, as XLA's
    ``dynamic_update_slice``); the attention mask of every row uses
    ``pos[0]``, as in the reference.
    """
    positions = pos[:, None]
    if cfg.mrope:
        positions = positions[..., None].expand(*positions.shape, 3)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    s_cache = cache_k.shape[1]
    if cfg.cache_update == "dus":
        start = pos[0].clamp(0, s_cache - 1).reshape(1).long()
        cache_k.index_copy_(1, start, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, start, v_new.to(cache_v.dtype))
    else:
        # the one-hot blend: a row whose position lies outside the cache
        # writes nothing
        hit = (torch.arange(s_cache, device=pos.device)[None, :]
               == pos[:, None])[:, :, None, None]
        cache_k.copy_(torch.where(hit, k_new.to(cache_k.dtype), cache_k))
        cache_v.copy_(torch.where(hit, v_new.to(cache_v.dtype), cache_v))
    out = _chunked_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                             q_offset=pos[0], window=window, causal=True,
                             chunk=cfg.attn_chunk, kv_len_valid=pos[0] + 1)
    return torch.einsum("bshe,hed->bsd", out, p["wo"]), cache_k, cache_v


def cross_memory(p: dict, cfg: ModelCfg, memory: torch.Tensor):
    """Cross-attention K and V (B, Sm, Hkv, hd) from the encoder's memory
    (B, Sm, D), in the type the two promote to: whisper's float32 memory
    against bfloat16 weights gives float32, as in the reference."""
    dt = torch.promote_types(memory.dtype, p["wk"].dtype)
    m = memory.to(dt)
    k = torch.einsum("bsd,dhe->bshe", m, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", m, p["wv"].to(dt))
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def cross_attn_apply(p: dict, cfg: ModelCfg, x: torch.Tensor,
                     memory_k: torch.Tensor, memory_v: torch.Tensor,
                     train: bool = False) -> torch.Tensor:
    """x (B, Sq, D) queries against memory_{k,v} (B, Sm, Hkv, hd), no mask.

    Prefill and decode run the flash kernel at ``Sq != Skv`` (non-causal,
    no window); ``train`` runs ``_chunked_attention`` as the reference
    does, its clamp of a ragged last chunk included.  The attention
    computes in the type q and the memory promote to (bfloat16 queries
    against whisper's float32 memory: float32, the ``tf32x3`` route) and
    returns q's dtype, as the reference's does."""
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if train:
        out = _chunked_attention(q, memory_k, memory_v, q_offset=0, window=0,
                                 causal=False, chunk=cfg.attn_chunk)
    else:
        dt = torch.promote_types(q.dtype, memory_k.dtype)
        out = flash_attention(q.to(dt).transpose(1, 2),
                              memory_k.to(dt).transpose(1, 2),
                              memory_v.to(dt).transpose(1, 2),
                              causal=False).transpose(1, 2).to(q.dtype)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])
