"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA + RoPE.  [arXiv:2402.19173]

Note: starcoder2 uses a non-gated MLP; we keep the zoo-uniform SwiGLU with
d_ff as given (parameter count differs by the gate matrix; recorded in
DESIGN.md as an adaptation).
"""

from repro_torch.models.config import ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="starcoder2-15b",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
        d_ff=24576, vocab=49152,
        rope_theta=100_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="starcoder2-15b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=256,
        tie_embeddings=False, attn_chunk=64, remat="none",
    )
