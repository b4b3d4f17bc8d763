"""whisper-medium [audio]: enc-dec, 24L decoder (+24L encoder)
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865; conv frontend is a STUB —
input_specs feeds precomputed 1500-frame embeddings.  [arXiv:2212.04356]

Adaptation note (DESIGN.md): sinusoidal/learned absolute positions in the
original are a learned encoder pos-emb + decoder RoPE here.
"""

from repro_torch.models.config import ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch_id="whisper-medium",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865,
        enc_dec=True, n_enc_layers=24, enc_frames=1500,
        act_fn="gelu", tie_embeddings=True,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        arch_id="whisper-medium-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        enc_dec=True, n_enc_layers=2, enc_frames=16,
        act_fn="gelu", tie_embeddings=True, attn_chunk=32, remat="none",
    )
