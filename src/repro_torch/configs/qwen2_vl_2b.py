"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; M-RoPE, dynamic resolution.  Vision frontend is a STUB:
input_specs feeds precomputed patch embeddings for the first
``vision_tokens`` positions.  [arXiv:2409.12191]"""

from repro_torch.models.config import ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="qwen2-vl-2b",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab=151936,
        mrope=True, vision_tokens=256,
        rope_theta=1_000_000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="qwen2-vl-2b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        mrope=True, vision_tokens=16,
        tie_embeddings=True, attn_chunk=32, remat="none",
    )
