"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060]"""

from repro_torch.models.config import ModelCfg, SSMCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="mamba2-370m",
        n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,  # unused
        d_ff=0, vocab=50280,
        block_kind="ssm",
        ssm=SSMCfg(d_state=128, head_dim=64, expand=2),
        tie_embeddings=True,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="mamba2-370m-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=256,
        block_kind="ssm",
        ssm=SSMCfg(d_state=16, head_dim=16, expand=2, chunk=16),
        tie_embeddings=True, remat="none",
    )
