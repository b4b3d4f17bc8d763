"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks
(weight re-use), one shared block every 6 layers.  [arXiv:2411.15242]"""

from repro_torch.models.config import ModelCfg, SSMCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="zamba2-2.7b",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000,
        block_kind="ssm",
        ssm=SSMCfg(d_state=64, head_dim=64, expand=2),
        hybrid_attn_every=6,
        tie_embeddings=True,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="zamba2-2.7b-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        block_kind="ssm",
        ssm=SSMCfg(d_state=16, head_dim=16, expand=2, chunk=16),
        hybrid_attn_every=2,
        tie_embeddings=True, attn_chunk=64, remat="none",
    )
