"""llama3-8b — the paper's own evaluation model ([27], §IV-a).

32L d=4096 32H (GQA kv=8) ff=14336 vocab=128256, RMSNorm+SwiGLU, untied,
rope_theta 500k.
"""

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "llama3-8b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=128_256, d_model=4_096, n_layers=32,
        n_heads=32, n_kv=8, d_ff=14_336, head_dim=128,
        act="silu", glu=True, norm="rms", rope_theta=500_000.0,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=64, n_layers=2,
        n_heads=4, n_kv=2, d_ff=128, head_dim=16,
        act="silu", glu=True, norm="rms",
    )
