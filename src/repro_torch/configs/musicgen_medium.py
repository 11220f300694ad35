"""musicgen-medium [audio] — 48L d=1536 24H (MHA kv=24) ff=6144 vocab=2048.

[arXiv:2306.05284; hf] — decoder-only transformer over EnCodec codebook
tokens.  The EnCodec frontend (audio → token ids) and the 4-codebook delay
pattern are the modality frontend and are stubbed, as in the JAX package:
the backbone is a single-stream LM over the 2048-entry codebook vocabulary.
Adaptation note: MusicGen uses sinusoidal absolute positions;
we use RoPE, the repo-wide positional scheme — backbone compute is identical.
Plain GELU MLP (no GLU), LayerNorm.
"""

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "musicgen-medium"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=2_048, d_model=1_536, n_layers=48,
        n_heads=24, n_kv=24, d_ff=6_144, head_dim=64,
        act="gelu", glu=False, norm="ln",
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=128, d_model=48, n_layers=2,
        n_heads=6, n_kv=6, d_ff=96, head_dim=8,
        act="gelu", glu=False, norm="ln",
    )
