"""recurrentgemma-9b [hybrid] — 38L d=4096 16H (MQA kv=1) ff=12288 vocab=256000.

arXiv:2402.19427 — Griffin: (rec, rec, attn) 1:2 pattern, RG-LRU recurrence
(K5; lru_width 4096, block-diagonal gates in 16 heads) + local attention
(K1) with window 2048 and head_dim 256, GeGLU, gemma-style norms, tied
scaled embeddings, final soft-cap 30.  38 = 12 x (r, r, a) groups + 2
trailing recurrent layers.  The attention cache is a ring of the window.
"""

from repro_torch.models.griffin import GriffinConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> GriffinConfig:
    return GriffinConfig(
        name=ARCH_ID, vocab=256_000, d_model=4_096, n_layers=38,
        n_heads=16, head_dim=256, d_ff=12_288,
        lru_width=4_096, n_lru_heads=16, window=2_048,
        pattern=("rec", "rec", "attn"),
        tie_embeddings=True, embed_scale=True, final_softcap=30.0,
    )


def reduced() -> GriffinConfig:
    return GriffinConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=64, n_layers=5,
        n_heads=4, head_dim=16, d_ff=128,
        lru_width=64, n_lru_heads=4, window=16,
        pattern=("rec", "rec", "attn"),
        tie_embeddings=True, embed_scale=True, final_softcap=30.0,
    )
