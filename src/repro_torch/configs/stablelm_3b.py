"""stablelm-3b [dense] — 32L d=2560 32H (kv=32, MHA) ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b lineage; unverified] — LayerNorm, SwiGLU,
partial rotary (25% of head dim), untied embeddings.
"""

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "stablelm-3b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=50_304, d_model=2_560, n_layers=32,
        n_heads=32, n_kv=32, d_ff=6_912,
        act="silu", glu=True, norm="ln", rope_frac=0.25, rope_theta=10_000.0,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=64, n_layers=2,
        n_heads=4, n_kv=4, d_ff=128,
        act="silu", glu=True, norm="ln", rope_frac=0.25,
    )
