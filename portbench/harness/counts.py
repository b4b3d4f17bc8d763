"""The yardstick: the chip's peaks, the model FLOPs of a step or a call,
and the least time of the masked-matmul and flash products.

Model FLOPs count what the model's mathematics needs, whatever the
implementation runs: every weight product at 2 FLOP a kept weight a
token (the LogicNet-FFN's at its kept connections, 2·M·nnz), causal
attention at 4·head_dim·heads a (query, key) pair with key <= query, the
SSD at 6·d_state·head_dim a head a token (its recurrence: decay, the
B x outer product, the C read-out), the LM head at the positions whose
logits are used.  Norms, activations, quantizers, RoPE, softmax and the
SSM's convolution are not counted.  Backward is twice the forward;
recomputation (remat) is not counted.  So no implementation reads above
100 % of the peak, and no implementation moves the count.
"""

from __future__ import annotations

from portbench.reference.model import (fan_ins, head_dim, is_hybrid,
                                       ssm_dims)

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def attn_sites(cfg: dict) -> int:
    """Attention (and FFN) layers a forward runs: every layer of a
    decoder, the shared layer's sites of a hybrid."""
    if is_hybrid(cfg):
        return cfg["n_layers"] // cfg["hybrid_attn_every"]
    return cfg["n_layers"]


def ffn_nnz(cfg: dict) -> tuple[int, int]:
    """Kept weights of one FFN's input products (each of wi_gate, wi_up)
    and of its output product."""
    if not cfg.get("logicnet_ffn"):
        return cfg["d_model"] * cfg["d_ff"], cfg["d_ff"] * cfg["d_model"]
    k_in, k_out = fan_ins(cfg)
    return k_in * cfg["d_ff"], k_out * cfg["d_model"]


def token_weights(cfg: dict) -> int:
    """Kept weights a token multiplies once in a forward, LM head apart."""
    d, hd = cfg["d_model"], head_dim(cfg)
    nnz_in, nnz_out = ffn_nnz(cfg)
    site = (d * hd * (cfg["n_heads"] + 2 * cfg["n_kv_heads"])
            + cfg["n_heads"] * hd * d + 2 * nnz_in + nnz_out)
    total = attn_sites(cfg) * site
    if is_hybrid(cfg):
        d_in, nh, _, g, n = ssm_dims(cfg)
        total += cfg["n_layers"] * (d * (2 * d_in + 2 * g * n + nh)
                                    + d_in * d)
    return total


def forward_flops(cfg: dict, batch: int, seq: int, head_rows: int) -> float:
    """Model FLOPs of a forward over ``batch`` sequences of ``seq`` tokens
    with the LM head at ``head_rows`` positions."""
    tokens = batch * seq
    flops = 2.0 * token_weights(cfg) * tokens
    pairs = batch * seq * (seq + 1) / 2
    flops += 4.0 * head_dim(cfg) * cfg["n_heads"] * pairs * attn_sites(cfg)
    if is_hybrid(cfg):
        _, nh, hp, _, n = ssm_dims(cfg)
        flops += 6.0 * n * hp * nh * tokens * cfg["n_layers"]
    return flops + 2.0 * cfg["vocab"] * cfg["d_model"] * head_rows


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward (3 x forward) of a training step."""
    return 3.0 * forward_flops(cfg, batch, seq, batch * seq)


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """A prefill call: the forward, the LM head at the last position."""
    return forward_flops(cfg, batch, seq, batch)


def product_bound_s(m: int, k: int, n: int, nnz: int) -> float:
    """Least time of a bfloat16 masked product x (M, K) @ (w * mask) (K,
    N): x, w, mask and the output moved once, or 2·M·nnz FLOP."""
    moved = BF16_BYTES * (m * k + 2 * k * n + m * n)
    return max(moved / HBM_BYTES_PER_S, 2.0 * m * nnz / PEAK_BF16_FLOPS)


def masked_matmul_bound_s(cfg: dict, rows: int, backward: bool) -> float:
    """Least time of the FFN's logical masked products over ``rows``
    tokens, every FFN site: the forward's three (wi_gate, wi_up, wo) and,
    with ``backward``, the three input gradients, each counted once."""
    d, dff = cfg["d_model"], cfg["d_ff"]
    nnz_in, nnz_out = ffn_nnz(cfg)
    fwd = 2 * product_bound_s(rows, d, dff, nnz_in) \
        + product_bound_s(rows, dff, d, nnz_out)
    grad = 2 * product_bound_s(rows, dff, d, nnz_in) \
        + product_bound_s(rows, d, dff, nnz_out)
    return attn_sites(cfg) * (fwd + (grad if backward else 0.0))


def flash_bound_s(cfg: dict, batch: int, seq: int) -> float:
    """Least time of the causal flash attention of a prefill, every
    attention site: q, k, v and o moved once, or 4·head_dim·heads FLOP a
    causal (query, key) pair."""
    hd, hq, hkv = head_dim(cfg), cfg["n_heads"], cfg["n_kv_heads"]
    moved = BF16_BYTES * batch * seq * hd * (2 * hq + 2 * hkv)
    flops = 4.0 * hd * hq * batch * seq * (seq + 1) / 2
    return attn_sites(cfg) * max(moved / HBM_BYTES_PER_S,
                                 flops / PEAK_BF16_FLOPS)
