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


@dataclasses.dataclass(frozen=True)
class LogicNetFFNCfg:
    """Paper integration at LM scale: per-neuron fan-in sparsity +
    activation QAT on the FFN (DESIGN.md §4)."""

    fan_in: int = 16
    bw: int = 4
    max_val: float = 4.0


@dataclasses.dataclass(frozen=True)
class ModelCfg:
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
