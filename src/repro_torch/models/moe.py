"""Mixture-of-Experts FFN: top-k router and three dispatch strategies.

The port's counterpart of ``repro.models.moe``: ``moe_init``, ``_router``,
``_expert_ffn``, ``GROUP_TOKENS``, ``moe_apply_dense`` (GShard one-hot
dispatch with a capacity, the default), ``moe_apply_sorted`` (one global
sort) and ``moe_apply_sorted_local`` (a sort within each group of
``GROUP_TOKENS`` tokens), and ``moe_apply``.  The reference computes the
dispatch and the expert products as XLA einsums outside any Pallas
kernel; here they are torch products, each einsum of more than two
operands written as two-operand steps (``torch.einsum`` optimises no
contraction path).

What must match the reference exactly, since a different choice keeps
different (token, k) pairs:

* the router reads its weights as the layer holds them: in bfloat16
  compute the ``(d, E)`` router is a bfloat16 matrix (the reference casts
  every matrix leaf) that the float32 product promotes back to float32;
* top-k takes the larger logit first and, at equal logits, the lower
  expert index (``jax.lax.top_k``), here a stable descending sort;
* the capacity ``max(1, int(capacity_factor * gs * k / e))`` in Python
  float arithmetic, the token-major (token, k) order of the capacity
  cumsum, and stable sorts by expert.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelCfg
from repro_torch.models.layers import normal_init

GROUP_TOKENS = 1024  # GShard group size: bounds the (G_s, E, C) tensors


def moe_init(gen: torch.Generator, cfg: ModelCfg, dtype) -> dict:
    """Router normal x 1/sqrt(d) in float32 (whatever ``dtype``); expert
    weights ``wi_gate`` / ``wi_up`` (E, d, f) normal x 1/sqrt(d) and ``wo``
    (E, f, d) normal x 1/sqrt(f), as the reference's ``moe_init``."""
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    s_in, s_out = 1.0 / d ** 0.5, 1.0 / f ** 0.5
    return {"router": normal_init((d, e), s_in, gen, torch.float32),
            "wi_gate": normal_init((e, d, f), s_in, gen, dtype),
            "wi_up": normal_init((e, d, f), s_in, gen, dtype),
            "wo": normal_init((e, f, d), s_out, gen, dtype)}


def capacity(cfg: ModelCfg, group: int) -> int:
    """Slots an expert has in a group of ``group`` tokens."""
    return max(1, int(cfg.moe.capacity_factor * group * cfg.moe.top_k
                      / cfg.moe.n_experts))


def _router(p: dict, x: torch.Tensor, cfg: ModelCfg):
    """Softmax-after-top-k routing: ``(topi (B, S, K) int64, weights
    (B, S, K) float32, aux)``, aux the Switch load-balancing loss
    ``E * sum_e f_e * p_e`` (float32, 0-d)."""
    logits = x.float() @ p["router"].float()                 # (B, S, E)
    k, e = cfg.moe.top_k, cfg.moe.n_experts
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    weights = torch.softmax(topv, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(topi, e).float()                      # (B,S,K,E)
    frac = onehot.sum(2).reshape(-1, e).mean(0)
    aux = e * torch.sum(frac * probs.reshape(-1, e).mean(0))
    return topi, weights, aux


def _expert_ffn(p: dict, xs: torch.Tensor, act=F.silu) -> torch.Tensor:
    """xs: (E, C, D) per-expert token slabs -> (E, C, D)."""
    h = act(torch.bmm(xs, p["wi_gate"])) * torch.bmm(xs, p["wi_up"])
    return torch.bmm(h, p["wo"])


def _groups(cfg: ModelCfg, tokens: int) -> tuple[int, int, int]:
    """(group size, groups, capacity) of the grouped dispatches."""
    gs = min(GROUP_TOKENS, tokens)
    assert tokens % gs == 0, (tokens, gs)
    return gs, tokens // gs, capacity(cfg, gs)


def dropped_pairs(topi: torch.Tensor, n_experts: int, cap: int) -> int:
    """(token, k) pairs of ``topi`` (G, S, K) that the grouped dispatches
    (``dense``, ``sorted_local``) drop at capacity ``cap``."""
    return int((~dense_keep(topi, n_experts, cap)[2]).all(-1).sum())


def dense_keep(topi: torch.Tensor, n_experts: int, cap: int):
    """GShard's capacity rule on ``topi`` (G, S, K): ``(onehot, pos,
    keep)``, each (G, S, K, E): the choice one-hot in float32, each pair's
    place in its expert's buffer (token-major over (token, k)), and whether
    it got a place."""
    g, s, k = topi.shape
    onehot = F.one_hot(topi, n_experts).float()              # (G,S,K,E)
    # the cumsum along the pairs, taken along the last dimension: along an
    # outer one it took 45 ms of olmoe-1b-7b's 149 ms 4 x 2048 prefill on
    # an H100.  It counts 0s and 1s, so it is exact in float32 either way
    pos = torch.cumsum(onehot.reshape(g, s * k, n_experts).transpose(1, 2)
                       .contiguous(), dim=-1).transpose(1, 2) - 1
    pos = pos.reshape(g, s, k, n_experts)
    keep = (pos < cap) & (onehot > 0)
    return onehot, pos, keep


def moe_apply_dense(p: dict, cfg: ModelCfg, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard dense dispatch: tokens in groups of ``GROUP_TOKENS``, each
    group dispatched into (E, C) buffers by one-hot products; a (token, k)
    pair past its expert's capacity is dropped."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    gs, n_g, cap = _groups(cfg, b * s)
    topi, weights, aux = _router(p, x, cfg)
    k = topi.shape[-1]
    flat_w = weights.reshape(n_g, gs, k).to(x.dtype)
    onehot, pos, keep = dense_keep(topi.reshape(n_g, gs, k), e, cap)
    sel = torch.where(keep, onehot, 0.0).to(x.dtype)          # (G,S,K,E)
    pos_sel = (pos * onehot).sum(-1).int()                   # (G,S,K)
    cap_oh = F.one_hot(pos_sel.clamp(0, cap - 1).long(), cap).to(x.dtype)
    # dispatch "gske,gskc->gsec"; combine "gsk,gske,gskc->gsec" as the
    # weight times the selection (exact: sel is 0 or 1) then the same
    # product.  A token picks an expert once, so each (e, c) sums one term
    sel_t = sel.reshape(n_g * gs, k, e).transpose(1, 2)      # (GS, E, K)
    cap_f = cap_oh.reshape(n_g * gs, k, cap)
    dispatch = torch.bmm(sel_t, cap_f).reshape(n_g, gs, e * cap)
    comb_t = (flat_w[..., None] * sel).reshape(n_g * gs, k, e).transpose(1, 2)
    combine = torch.bmm(comb_t, cap_f).reshape(n_g, gs, e * cap)
    xg = x.reshape(n_g, gs, d)
    # "gsec,gsd->egcd"
    expert_in = torch.bmm(dispatch.transpose(1, 2), xg)      # (G, E*C, D)
    expert_in = expert_in.reshape(n_g, e, cap, d).transpose(0, 1).reshape(
        e, n_g * cap, d)
    expert_out = _expert_ffn(p, expert_in)                   # (E, G*C, D)
    expert_out = expert_out.reshape(e, n_g, cap, d).transpose(0, 1).reshape(
        n_g, e * cap, d)
    out = torch.bmm(combine, expert_out)                     # "gsec,egcd->gsd"
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_apply_sorted(p: dict, cfg: ModelCfg, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based ragged dispatch, one group over all tokens (the
    reference's global variant, kept for the record): capacity
    ``int(capacity_factor * tokens * k / e)``."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    tokens = b * s
    cap = capacity(cfg, tokens)
    topi, weights, aux = _router(p, x, cfg)
    k = topi.shape[-1]
    flat_i = topi.reshape(tokens * k)
    flat_w = weights.reshape(tokens * k)
    tok_id = torch.arange(tokens, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_i, stable=True)
    sorted_e, sorted_t, sorted_w = flat_i[order], tok_id[order], flat_w[order]
    same = torch.cumsum(F.one_hot(sorted_e, e), dim=0)
    rank = same.gather(1, sorted_e[:, None])[:, 0] - 1
    keep = rank < cap
    slot = (sorted_e * cap + rank).clamp(0, e * cap - 1)
    xf = x.reshape(tokens, d)
    slab = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    slab.index_add_(0, slot, torch.where(keep[:, None], xf[sorted_t], 0))
    expert_out = _expert_ffn(p, slab.reshape(e, cap, d))
    flat_out = expert_out.reshape(e * cap, d)
    contrib = torch.where(keep[:, None],
                          flat_out[slot] * sorted_w[:, None].to(x.dtype), 0)
    out = torch.zeros((tokens, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, sorted_t, contrib)
    return out.reshape(b, s, d), aux


def moe_apply_sorted_local(p: dict, cfg: ModelCfg, x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based ragged dispatch within each group of ``GROUP_TOKENS``
    tokens: the dense path's groups and capacity (so the same kept pairs),
    gathers and scatter-adds in place of the one-hot products."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    gs, n_g, cap = _groups(cfg, b * s)
    topi, weights, aux = _router(p, x, cfg)
    k = topi.shape[-1]
    flat_i = topi.reshape(n_g, gs * k)
    flat_w = weights.reshape(n_g, gs * k).to(x.dtype)
    tok_id = torch.arange(gs, device=x.device).repeat_interleave(k).expand(
        n_g, gs * k)
    order = torch.argsort(flat_i, dim=1, stable=True)
    sorted_e = flat_i.gather(1, order)
    sorted_t = tok_id.gather(1, order)
    sorted_w = flat_w.gather(1, order)
    same = torch.cumsum(F.one_hot(sorted_e, e), dim=1)
    rank = same.gather(2, sorted_e[:, :, None])[:, :, 0] - 1
    keep = rank < cap
    slot = (sorted_e * cap + rank).clamp(0, e * cap - 1)
    xg = x.reshape(n_g, gs, d)
    gathered = xg.gather(1, sorted_t[:, :, None].expand(-1, -1, d))
    gathered = torch.where(keep[:, :, None], gathered, 0)
    slab = torch.zeros((n_g, e * cap, d), dtype=x.dtype, device=x.device)
    slab.scatter_add_(1, slot[:, :, None].expand(-1, -1, d), gathered)
    # "gecd,edf->gecf" and "gecf,efd->gecd": each expert's slabs of every
    # group in one product
    slab = slab.reshape(n_g, e, cap, d).transpose(0, 1).reshape(
        e, n_g * cap, d)
    expert_out = _expert_ffn(p, slab).reshape(e, n_g, cap, d)
    flat_out = expert_out.transpose(0, 1).reshape(n_g, e * cap, d)
    back = flat_out.gather(1, slot[:, :, None].expand(-1, -1, d))
    contrib = torch.where(keep[:, :, None], back * sorted_w[:, :, None], 0)
    out = torch.zeros((n_g, gs, d), dtype=x.dtype, device=x.device)
    out.scatter_add_(1, sorted_t[:, :, None].expand(-1, -1, d), contrib)
    return out.reshape(b, s, d), aux


def moe_apply(p: dict, cfg: ModelCfg, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.dispatch == "sorted":
        return moe_apply_sorted(p, cfg, x)
    if cfg.moe.dispatch == "sorted_local":
        return moe_apply_sorted_local(p, cfg, x)
    return moe_apply_dense(p, cfg, x)
