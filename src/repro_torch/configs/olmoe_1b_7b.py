"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060]"""

from repro_torch.models.config import ModelCfg, MoECfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="olmoe-1b-7b",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304,
        moe=MoECfg(n_experts=64, top_k=8),
        rope_theta=10_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="olmoe-1b-7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256,
        moe=MoECfg(n_experts=4, top_k=2),
        tie_embeddings=False, attn_chunk=64, remat="none",
    )
