"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064; RoPE + SwiGLU.  [arXiv:2404.14219]"""

from repro_torch.models.config import ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="phi3-mini-3.8b",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064,
        rope_theta=10_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="phi3-mini-3.8b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        tie_embeddings=False, attn_chunk=64, remat="none",
    )
