"""zamba2-7b [Zamba2 hybrid]: 81 Mamba2 layers d_model=3584 (112 SSD heads
of 64, 2 groups, state 64), and before each of 13 of them one of two
shared transformer blocks in turn (32 heads of 224 over the 7168-wide
concatenation of the stream and the embedding, a GELU MLP of 14336 with a
rank-128 LoRA a site), vocab 32000.  Zyphra/Zamba2-7B-Instruct's
config.json; arXiv:2411.15242.  Trains and prefills (no decode cache).

Not in ``ARCH_IDS``: the zoo mirrors the JAX package's configurations,
which hold no such layout."""

from repro_torch.models.config import ModelCfg, SSMCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="zamba2-7b",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=224,
        d_ff=14336, vocab=32000,
        block_kind="ssm",
        ssm=SSMCfg(d_state=64, head_dim=64, expand=2, conv_width=4,
                   chunk=256, n_groups=2, grouped_norm=True),
        hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
        num_mem_blocks=2, adapter_rank=128,
        rope_theta=10_000.0, norm_eps=1e-5, act_fn="gelu_exact",
        tie_embeddings=True,
    )


def smoke_config() -> ModelCfg:
    """Two groups, both blocks (sites A B A), a rank-4 LoRA."""
    return ModelCfg(
        arch_id="zamba2-7b-smoke",
        n_layers=6, d_model=32, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab=128,
        block_kind="ssm",
        ssm=SSMCfg(d_state=8, head_dim=8, expand=2, conv_width=4, chunk=8,
                   n_groups=2, grouped_norm=True),
        hybrid_layer_ids=(1, 3, 4), num_mem_blocks=2, adapter_rank=4,
        rope_theta=10_000.0, norm_eps=1e-5, act_fn="gelu_exact",
        tie_embeddings=True, attn_chunk=16, remat="none",
    )
