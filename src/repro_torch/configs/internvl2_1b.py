"""internvl2-1b [vlm] — 24L d=896 14H (GQA kv=2) ff=4864 vocab=151655.

[arXiv:2404.16821; hf] — Qwen2-0.5B-class language backbone; the InternViT
vision frontend is a stub, as in the JAX package: ``input_specs()`` ships 256
precomputed patch embeddings (ViT hidden size 1024) which are linearly
projected and prepended to the text sequence.  Tied embeddings.
"""

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "internvl2-1b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=151_655, d_model=896, n_layers=24,
        n_heads=14, n_kv=2, d_ff=4_864, head_dim=64,
        act="silu", glu=True, norm="rms", tie_embeddings=True,
        rope_theta=1_000_000.0,
        prefix_tokens=256, prefix_dim=1_024,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=56, n_layers=2,
        n_heads=7, n_kv=1, d_ff=112, head_dim=8,
        act="silu", glu=True, norm="rms", tie_embeddings=True,
        prefix_tokens=8, prefix_dim=16,
    )
