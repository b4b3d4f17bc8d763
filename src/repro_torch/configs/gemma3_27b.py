"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global attention, 1024-token sliding window,
128k context.  [hf:google/gemma-3-27b family]"""

from repro_torch.models.config import ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="gemma3-27b",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab=262144,
        sliding_window=1024, local_global_ratio=5,
        rope_theta=1_000_000.0, act_fn="gelu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="gemma3-27b-smoke",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        sliding_window=32, local_global_ratio=5, act_fn="gelu",
        tie_embeddings=True, attn_chunk=32, remat="none",
    )
