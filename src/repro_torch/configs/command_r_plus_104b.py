"""command-r-plus-104b [dense] — 64L d=12288 96H (GQA kv=8) ff=33792 vocab=256000.

[hf:CohereForAI lineage; unverified] — parallel attention+FFN blocks, no bias,
LayerNorm, SwiGLU, tied embeddings (Cohere ties input/output embeddings).
"""

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "command-r-plus-104b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=256_000, d_model=12_288, n_layers=64,
        n_heads=96, n_kv=8, d_ff=33_792, head_dim=128,
        act="silu", glu=True, norm="ln", parallel_block=True,
        tie_embeddings=True, rope_theta=75_000.0,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=96, n_layers=2,
        n_heads=6, n_kv=2, d_ff=192, head_dim=16,
        act="silu", glu=True, norm="ln", parallel_block=True,
        tie_embeddings=True,
    )
