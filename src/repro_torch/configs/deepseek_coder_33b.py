"""deepseek-coder-33b [dense] — 62L d=7168 56H (GQA kv=8) ff=19200 vocab=32256.

[arXiv:2401.14196; hf] — llama-architecture: RMSNorm, SwiGLU, RoPE, untied.
"""

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "deepseek-coder-33b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=32_256, d_model=7_168, n_layers=62,
        n_heads=56, n_kv=8, d_ff=19_200, head_dim=128,
        act="silu", glu=True, norm="rms", rope_theta=100_000.0,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=56, n_layers=2,
        n_heads=7, n_kv=1, d_ff=128, head_dim=8,
        act="silu", glu=True, norm="rms",
    )
