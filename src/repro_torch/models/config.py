"""Unified model configuration covering every assigned architecture.

The port's own copy of ``repro.models.config`` (the port imports nothing
of ``repro``), field for field.  One dataclass; family-specific behavior
is driven by ``block_kind`` and the optional MoE / SSM / enc-dec / VLM
sub-configs.  Exact per-arch values live in ``repro_torch.configs.<arch_id>``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    # 'dense' = GShard one-hot einsum dispatch (baseline);
    # 'sorted' = sort-based ragged dispatch (optimized, §Perf).
    dispatch: str = "dense"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1
    # the gated RMSNorm over each of the n_groups groups of d_in / n_groups
    # channels (Zamba2's Mamba2 layers), not over all of d_in at once
    grouped_norm: bool = False


@dataclasses.dataclass(frozen=True)
class LogicNetFFNCfg:
    """Paper integration at LM scale: per-neuron fan-in sparsity +
    activation QAT on the FFN (DESIGN.md §4)."""

    fan_in: int = 16
    bw: int = 4
    max_val: float = 4.0


# Zamba2's own config.json keys, which a configuration file may carry
# beside the port's fields: the benchmark's zamba2-7b file holds its
# source's config whole.  ``hybrid_layer_ids``, ``num_mem_blocks``,
# ``adapter_rank`` and ``rope_theta`` are the port's fields themselves.
# Each checked key that is given must read what the port runs
# (:func:`zamba2_source_values`); the recorded ones only initialise
# weights or bound inference, and are kept as given.
ZAMBA2_CHECKED_KEYS = (
    "add_bias_linear", "attention_head_dim", "attention_hidden_size",
    "chunk_size", "ffn_hidden_size", "hidden_act", "hidden_size",
    "intermediate_size", "kv_channels", "layers_block_type", "mamba_d_conv",
    "mamba_d_state", "mamba_expand", "mamba_headdim", "mamba_ngroups",
    "model_type", "n_mamba_heads", "num_attention_heads",
    "num_hidden_layers", "num_key_value_heads", "num_query_groups",
    "rms_norm_eps", "time_step_limit", "use_conv_bias", "use_long_context",
    "use_mem_rope", "use_shared_attention_adapter", "use_shared_mlp_adapter",
    "vocab_size")
ZAMBA2_RECORDED_KEYS = ("max_position_embeddings", "num_logits_to_keep",
                        "time_step_floor", "time_step_max", "time_step_min")
ZAMBA2_SOURCE_KEYS = ZAMBA2_CHECKED_KEYS + ZAMBA2_RECORDED_KEYS

# None: not given
_Zamba2SourceKeys = dataclasses.make_dataclass(
    "_Zamba2SourceKeys",
    [(k, object, dataclasses.field(default=None))
     for k in ZAMBA2_SOURCE_KEYS],
    frozen=True, kw_only=True)


def zamba2_source_values(cfg: "ModelCfg") -> dict:
    """What each of ``ZAMBA2_CHECKED_KEYS`` reads, in transformers'
    ``Zamba2Config``, for the model the port runs from ``cfg``."""
    d, s, ids = cfg.d_model, cfg.ssm, set(cfg.hybrid_layer_ids)
    out = {
        "add_bias_linear": False, "use_conv_bias": True,
        "use_long_context": False, "use_mem_rope": True,
        "use_shared_attention_adapter": False,
        "use_shared_mlp_adapter": cfg.adapter_rank > 0,
        "time_step_limit": None,       # softplus(dt + dt_bias) unclamped
        "hidden_act": {"gelu_exact": "gelu", "gelu": "gelu_pytorch_tanh",
                       "silu": "silu"}.get(cfg.act_fn),
        "hidden_size": d, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "num_query_groups": cfg.n_kv_heads,
        "attention_head_dim": cfg.resolved_head_dim,
        "attention_hidden_size": 2 * d, "kv_channels": d // cfg.n_heads,
        "ffn_hidden_size": cfg.d_ff, "intermediate_size": cfg.d_ff,
        "vocab_size": cfg.vocab, "rms_norm_eps": cfg.norm_eps,
        "layers_block_type": tuple("hybrid" if i in ids else "mamba"
                                   for i in range(cfg.n_layers))}
    if s is not None:
        out.update(mamba_d_state=s.d_state, mamba_headdim=s.head_dim,
                   mamba_expand=s.expand, mamba_d_conv=s.conv_width,
                   mamba_ngroups=s.n_groups, chunk_size=s.chunk,
                   n_mamba_heads=s.expand * d // s.head_dim)
        if cfg.has_shared_blocks and s.grouped_norm:
            out["model_type"] = "zamba2"
    return out


@dataclasses.dataclass(frozen=True)
class ModelCfg(_Zamba2SourceKeys):
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    # 'attn' | 'ssm'; hybrids interleave (e.g. zamba2 shared attn every k).
    block_kind: str = "attn"
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    logicnet_ffn: LogicNetFFNCfg | None = None

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0            # 0 = global everywhere
    local_global_ratio: int = 0        # gemma3: N local per 1 global
    mrope: bool = False                # qwen2-vl 3-section M-RoPE

    # hybrid (zamba2): one *shared* attention block every `attn_every` SSM
    # layers (weight re-use across sites, as in the paper).
    hybrid_attn_every: int = 0
    # Zamba2's own layout (Zamba2-7B; the keys are its config's): before
    # each SSM layer of ``hybrid_layer_ids`` one of ``num_mem_blocks``
    # shared transformer blocks, in turn, reads the residual stream
    # concatenated with the embedding; each such site has its own rank
    # ``adapter_rank`` LoRA on the block's MLP and its own output linear,
    # whose result enters only that SSM layer's input.  Empty: no such
    # sites (``hybrid_attn_every`` gives the reference's hybrid).
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 0
    adapter_rank: int = 0

    # enc-dec (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500             # frozen whisper encoder length

    # vlm (qwen2-vl): first `vision_tokens` positions come from the stub
    # patch-embedding frontend.
    vision_tokens: int = 0

    # numerics / training
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"                # 'none' | 'full' | 'dots'
    attn_chunk: int = 1024             # KV block for chunked (flash-style)
    act_fn: str = "silu"               # swiglu gate activation

    # Dry-run cost-accounting knobs (XLA cost_analysis counts while-loop
    # bodies ONCE; see launch/dryrun.py): scan_unroll=u makes layer-scan
    # bodies u-wide so a two-point fit recovers true per-step cost;
    # attn_unroll fully unrolls the KV-chunk loop (trip count follows seq
    # len, not layers, so it must be inlined to be counted).
    scan_unroll: int = 1
    attn_unroll: bool = False

    # KV-cache write strategy (§Perf): 'onehot' (baseline; blend rewrites
    # the whole cache — supports ragged per-row positions) vs 'dus'
    # (dynamic_update_slice at pos[0]: O(one token) traffic; rows share a
    # step, the lowered serve_step shape).
    cache_update: str = "onehot"

    def __post_init__(self):
        # a JSON list arrives as a list; the config stays hashable
        for k in ("hybrid_layer_ids",) + ZAMBA2_SOURCE_KEYS:
            if isinstance(getattr(self, k), list):
                object.__setattr__(self, k, tuple(getattr(self, k)))
        ids = self.hybrid_layer_ids
        if ids and not (self.is_ssm and self.hybrid_attn_every == 0
                        and self.num_mem_blocks > 0
                        and list(ids) == sorted(set(ids))
                        and 0 <= ids[0] and ids[-1] < self.n_layers):
            raise ValueError(
                f"hybrid_layer_ids {ids} need an SSM stack of more than "
                f"{ids[-1]} layers, no hybrid_attn_every and "
                f"num_mem_blocks > 0, each id once in order")
        given = {k: getattr(self, k) for k in ZAMBA2_CHECKED_KEYS
                 if getattr(self, k) is not None}
        if given:
            want = zamba2_source_values(self)
            bad = {k: (v, want.get(k)) for k, v in given.items()
                   if k not in want or v != want[k]}
            if bad:
                raise ValueError(f"source keys that differ from the model "
                                 f"run, (given, run): {bad}")

    @property
    def fit_unroll(self) -> int:
        """Second unroll point u2 for the cost fit (must divide the layer
        scan length: n_layers, or n_sites for hybrids)."""
        length = (self.n_layers // self.hybrid_attn_every
                  if self.is_hybrid else self.n_layers)
        return 3 if length % 2 else 2

    @property
    def scan_length(self) -> int:
        """Trip count of the (outer) layer scan, for the cost fit."""
        return (self.n_layers // self.hybrid_attn_every
                if self.is_hybrid else self.n_layers)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_ssm(self) -> bool:
        return self.block_kind == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.is_ssm and self.hybrid_attn_every > 0

    @property
    def has_shared_blocks(self) -> bool:
        """Zamba2's layout: shared blocks at ``hybrid_layer_ids``."""
        return bool(self.hybrid_layer_ids)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM state decode)."""
        return self.is_ssm

    def param_count(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6*N*D."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.is_ssm:
            assert self.ssm is not None
            d_in = self.ssm.expand * d
            nh = d_in // self.ssm.head_dim
            per = (d * (2 * d_in + 2 * self.ssm.n_groups * self.ssm.d_state
                        + nh)
                   + d_in * self.ssm.conv_width + d_in * d + 2 * nh)
            total = self.n_layers * per
            if self.has_shared_blocks:
                d2 = 2 * d
                block = (d2 * hd * (self.n_heads + 2 * self.n_kv_heads)
                         + self.n_heads * hd * d + 3 * d * self.d_ff)
                site = d * d + self.adapter_rank * (d + 2 * self.d_ff)
                total += (self.num_mem_blocks * block
                          + len(self.hybrid_layer_ids) * site)
            if self.is_hybrid:
                attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                        + self.n_heads * hd * d + 3 * d * self.d_ff)
                total += attn  # shared block counted once
            return emb + total
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * self.d_ff + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        layers = self.n_layers * (attn + ffn)
        if self.enc_dec:
            # encoder layers (self-attn + ffn) + decoder cross-attn
            layers += self.n_enc_layers * (attn + 3 * d * self.d_ff)
            layers += self.n_layers * attn
        return emb + layers

    def active_param_count(self) -> int:
        """N_active for MoE MODEL_FLOPS accounting."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.moe.n_experts * 3 * d * self.d_ff
        active = self.n_layers * self.moe.top_k * 3 * d * self.d_ff
        return full - all_experts + active
