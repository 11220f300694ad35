"""gemma2-9b [dense] — 42L d=3584 16H (GQA kv=8) ff=14336 vocab=256000.

[arXiv:2408.00118; hf] — alternating local(4096)/global attention, attn logit
softcap 50, final logit softcap 30, pre+post sandwich RMSNorm (1+scale),
GeGLU, head_dim 256, query scale 1/sqrt(224), scaled tied embeddings.
"""

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "gemma2-9b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=256_000, d_model=3_584, n_layers=42,
        n_heads=16, n_kv=8, d_ff=14_336, head_dim=256,
        act="gelu", glu=True, norm="rms1", post_norm=True,
        attn_softcap=50.0, final_softcap=30.0,
        window_pattern=(4_096, 0), attn_scale=224.0 ** -0.5,
        tie_embeddings=True, embed_scale=True,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=64, n_layers=4,
        n_heads=4, n_kv=2, d_ff=128, head_dim=32,
        act="gelu", glu=True, norm="rms1", post_norm=True,
        attn_softcap=50.0, final_softcap=30.0,
        window_pattern=(16, 0), attn_scale=16.0 ** -0.5,
        tie_embeddings=True, embed_scale=True,
    )
