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
from repro_torch.parallel.local import any_dtensor, data_parallel, gather_fsdp

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
    e = cfg.moe.n_experts
    topi, weights, onehot = _top_k(logits, cfg)
    probs = torch.softmax(logits, dim=-1)
    frac = onehot.sum(2).reshape(-1, e).mean(0)
    aux = e * torch.sum(frac * probs.reshape(-1, e).mean(0))
    return topi, weights, aux


def _top_k(logits: torch.Tensor, cfg: ModelCfg):
    """``(topi, weights, onehot)`` of router logits (B, S, E): each
    token's own choice, the choices' one-hot (B, S, K, E) in float32."""
    k, e = cfg.moe.top_k, cfg.moe.n_experts
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    weights = torch.softmax(topv, dim=-1)
    onehot = F.one_hot(topi, e).float()                      # (B,S,K,E)
    return topi, weights, onehot


def _expert_ffn(p: dict, xs: torch.Tensor, act=F.silu) -> torch.Tensor:
    """xs: (E, C, D) per-expert token slabs -> (E, C, D)."""
    h = act(torch.bmm(xs, p["wi_gate"])) * torch.bmm(xs, p["wi_up"])
    return torch.bmm(h, p["wo"])


def _groups(cfg: ModelCfg, tokens: int,
            group: int | None = None) -> tuple[int, int, int]:
    """(group size, groups, capacity) of the grouped dispatches; ``group``
    overrides the size (a mesh rank's share of the groups keeps the whole
    batch's size)."""
    gs = group or min(GROUP_TOKENS, tokens)
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


def moe_apply_dense(p: dict, cfg: ModelCfg, x: torch.Tensor, routed=None,
                    group=None, first: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard dense dispatch: tokens in groups of ``GROUP_TOKENS``, each
    group dispatched into (E, C) buffers by one-hot products; a (token, k)
    pair past its expert's capacity is dropped.  ``p``'s experts may be a
    slice, experts ``first`` on (a mesh rank's): the capacity rule still
    reads every expert's choices, the buffers and products hold only the
    slice's, and the output is their share of the sum."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    gs, n_g, cap = _groups(cfg, b * s, group)
    topi, weights, aux = _route(p, x, cfg, routed)
    k = topi.shape[-1]
    flat_w = weights.reshape(n_g, gs, k).to(x.dtype)
    onehot, pos, keep = dense_keep(topi.reshape(n_g, gs, k), e, cap)
    el = p["wi_gate"].shape[0]
    sel = torch.where(keep, onehot, 0.0)[..., first:first + el].to(
        x.dtype)                                               # (G,S,K,E)
    pos_sel = (pos * onehot).sum(-1).int()                   # (G,S,K)
    cap_oh = F.one_hot(pos_sel.clamp(0, cap - 1).long(), cap).to(x.dtype)
    # dispatch "gske,gskc->gsec"; combine "gsk,gske,gskc->gsec" as the
    # weight times the selection (exact: sel is 0 or 1) then the same
    # product.  A token picks an expert once, so each (e, c) sums one term
    sel_t = sel.reshape(n_g * gs, k, el).transpose(1, 2)     # (GS, E, K)
    cap_f = cap_oh.reshape(n_g * gs, k, cap)
    dispatch = torch.bmm(sel_t, cap_f).reshape(n_g, gs, el * cap)
    comb_t = (flat_w[..., None] * sel).reshape(n_g * gs, k, el).transpose(1, 2)
    combine = torch.bmm(comb_t, cap_f).reshape(n_g, gs, el * cap)
    xg = x.reshape(n_g, gs, d)
    # "gsec,gsd->egcd"
    expert_in = torch.bmm(dispatch.transpose(1, 2), xg)      # (G, E*C, D)
    expert_in = expert_in.reshape(n_g, el, cap, d).transpose(0, 1).reshape(
        el, n_g * cap, d)
    expert_out = _expert_ffn(p, expert_in)                   # (E, G*C, D)
    expert_out = expert_out.reshape(el, n_g, cap, d).transpose(0, 1).reshape(
        n_g, el * cap, d)
    out = torch.bmm(combine, expert_out)                     # "gsec,egcd->gsd"
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_apply_sorted(p: dict, cfg: ModelCfg, x: torch.Tensor, routed=None,
                     first: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based ragged dispatch, one group over all tokens (the
    reference's global variant, kept for the record): capacity
    ``int(capacity_factor * tokens * k / e)``; ``p``'s experts a slice
    from ``first`` as in :func:`moe_apply_dense`."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    tokens = b * s
    cap = capacity(cfg, tokens)
    topi, weights, aux = _route(p, x, cfg, routed)
    k = topi.shape[-1]
    flat_i = topi.reshape(tokens * k)
    flat_w = weights.reshape(tokens * k)
    tok_id = torch.arange(tokens, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_i, stable=True)
    sorted_e, sorted_t, sorted_w = flat_i[order], tok_id[order], flat_w[order]
    same = torch.cumsum(F.one_hot(sorted_e, e), dim=0)
    rank = same.gather(1, sorted_e[:, None])[:, 0] - 1
    keep, slot, el = _slots(p, sorted_e, rank, cap, first, e)
    xf = x.reshape(tokens, d)
    slab = torch.zeros((el * cap, d), dtype=x.dtype, device=x.device)
    slab.index_add_(0, slot, torch.where(keep[:, None], xf[sorted_t], 0))
    expert_out = _expert_ffn(p, slab.reshape(el, cap, d))
    flat_out = expert_out.reshape(el * cap, d)
    contrib = torch.where(keep[:, None],
                          flat_out[slot] * sorted_w[:, None].to(x.dtype), 0)
    out = torch.zeros((tokens, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, sorted_t, contrib)
    return out.reshape(b, s, d), aux


def moe_apply_sorted_local(p: dict, cfg: ModelCfg, x: torch.Tensor,
                           routed=None, group=None, first: int = 0
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based ragged dispatch within each group of ``GROUP_TOKENS``
    tokens: the dense path's groups and capacity (so the same kept pairs),
    gathers and scatter-adds in place of the one-hot products; ``p``'s
    experts a slice from ``first`` as in :func:`moe_apply_dense`."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    gs, n_g, cap = _groups(cfg, b * s, group)
    topi, weights, aux = _route(p, x, cfg, routed)
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
    keep, slot, el = _slots(p, sorted_e, rank, cap, first, e)
    xg = x.reshape(n_g, gs, d)
    gathered = xg.gather(1, sorted_t[:, :, None].expand(-1, -1, d))
    gathered = torch.where(keep[:, :, None], gathered, 0)
    slab = torch.zeros((n_g, el * cap, d), dtype=x.dtype, device=x.device)
    slab.scatter_add_(1, slot[:, :, None].expand(-1, -1, d), gathered)
    # "gecd,edf->gecf" and "gecf,efd->gecd": each expert's slabs of every
    # group in one product
    slab = slab.reshape(n_g, el, cap, d).transpose(0, 1).reshape(
        el, n_g * cap, d)
    expert_out = _expert_ffn(p, slab).reshape(el, n_g, cap, d)
    flat_out = expert_out.transpose(0, 1).reshape(n_g, el * cap, d)
    back = flat_out.gather(1, slot[:, :, None].expand(-1, -1, d))
    contrib = torch.where(keep[:, :, None], back * sorted_w[:, :, None], 0)
    out = torch.zeros((n_g, gs, d), dtype=x.dtype, device=x.device)
    out.scatter_add_(1, sorted_t[:, :, None].expand(-1, -1, d), contrib)
    return out.reshape(b, s, d), aux


def _slots(p: dict, sorted_e, rank, cap: int, first: int, e: int):
    """The sorted dispatches' ``(keep, slot, experts)`` for ``p``'s
    experts, a slice from ``first``: a pair is kept where its expert is
    in the slice and it is within capacity, its slot counted from the
    slice's first expert."""
    el = p["wi_gate"].shape[0]
    keep = rank < cap
    if el != e:
        keep = keep & (sorted_e >= first) & (sorted_e < first + el)
    slot = ((sorted_e - first) * cap + rank).clamp(0, el * cap - 1)
    return keep, slot, el


def _route(p: dict, x: torch.Tensor, cfg: ModelCfg, routed):
    """``_router``'s ``(topi, weights, aux)``, or, given ``routed``
    ``(topi, weights)`` (a mesh rank's share of choices made whole),
    those with aux None."""
    if routed is None:
        return _router(p, x, cfg)
    return (*routed, None)


_DISPATCH = {"dense": moe_apply_dense, "sorted": moe_apply_sorted,
             "sorted_local": moe_apply_sorted_local}


def _moe_apply_mesh(p: dict, cfg: ModelCfg, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on a mesh (DTensor weights), expert-parallel: the
    router's product and its load-balancing loss as DTensor ops over the
    whole batch, each token's top-k on its rank's rows, then the dispatch
    on each rank's token groups and its own experts
    (``parallel.local.data_parallel`` with the experts' placement kept).

    The rules shard the expert dimension over the model axis (EP) and
    ``d_model`` over the FSDP axes, which the layer's cast gathers
    (``cast_weights``): a rank holds E / M experts whole, never the
    others.  The activations keep the batch over ``data`` and replicate
    it over ``model``, so every model rank already holds the tokens its
    experts read: no token travels for the dispatch (no all-to-all).  The
    capacity rule reads every expert's choices on every rank, so the kept
    (token, k) pairs are the whole batch's; each rank dispatches only the
    pairs its experts take, runs those experts and combines them, a
    partial sum over the model axis that the residual add reduces (as a
    row-parallel FFN's output).  A rank takes a share of the batch only
    where its tokens are whole groups of the full batch's size (the
    global ``sorted`` dispatch, one group of every token, never shards
    its batch; it takes the same expert slice).  Where the model axis
    does not divide the experts they stay whole on every rank, each
    running all of them."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.local import tp_group, tp_placement
    b, s, _ = x.shape
    e = cfg.moe.n_experts
    logits = x.float() @ gather_fsdp(p["router"]).float()
    topi, weights, onehot = data_parallel(
        lambda lg, _: _top_k(lg, cfg), logits, {}, n_out=3)
    probs = torch.softmax(logits, dim=-1)
    # means over (B, S) in place of the reshape to (B * S, E): DTensor's
    # backward of that view fails on the batch-sharded gradient
    frac = onehot.sum(2).mean(dim=(0, 1))
    aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))
    dispatch = _DISPATCH.get(cfg.moe.dispatch, moe_apply_dense)
    gs = min(GROUP_TOKENS, b * s)
    experts = {k: p[k] for k in ("wi_gate", "wi_up", "wo")}
    ep = all(tp_placement(w) == Shard(0) for w in experts.values())
    coord, size, _ = tp_group(p["wi_gate"])
    first = coord * (e // size) if ep else 0

    def local(xl, w, ti, tw):
        kw = {} if dispatch is moe_apply_sorted else {"group": gs}
        return dispatch(w, cfg, xl, routed=(ti, tw), first=first, **kw)[0]

    def whole_groups(n: int) -> bool:
        return dispatch is not moe_apply_sorted and (b // n * s) % gs == 0

    out = data_parallel(local, x, experts, topi, weights,
                        shards_ok=whole_groups,
                        tp=[Shard(0)] * 3 + [Replicate()] * 2 if ep else None,
                        tp_out=Partial() if ep else None)
    return out, aux


def moe_apply(p: dict, cfg: ModelCfg, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if any_dtensor(x, *p.values()):
        return _moe_apply_mesh(p, cfg, x)
    return _DISPATCH.get(cfg.moe.dispatch, moe_apply_dense)(p, cfg, x)
