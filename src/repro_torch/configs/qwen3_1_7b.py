"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm.  [hf:Qwen/Qwen3-1.7B]"""

from repro_torch.models.config import ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="qwen3-1.7b",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="qwen3-1.7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        qk_norm=True, tie_embeddings=True, attn_chunk=64, remat="none",
    )
