"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-235B-A22B family]"""

from repro_torch.models.config import ModelCfg, MoECfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="qwen3-moe-235b-a22b",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936,
        moe=MoECfg(n_experts=128, top_k=8),
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="qwen3-moe-235b-a22b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=256,
        moe=MoECfg(n_experts=8, top_k=2),
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False, attn_chunk=64, remat="none",
    )
