"""qwen3-moe-30b-a3b [moe] — 48L d=2048 32H (GQA kv=4) vocab=151936.

[hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8 (no shared expert), per-expert
FFN width 768, head_dim 128, QK-RMSNorm, RMSNorm+SwiGLU, untied.
"""

from repro_torch.models.transformer import MoEConfig, TransformerConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=151_936, d_model=2_048, n_layers=48,
        n_heads=32, n_kv=4, d_ff=768, head_dim=128,
        act="silu", glu=True, norm="rms", qk_norm=True, rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=768, num_shared=0),
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=64, n_layers=2,
        n_heads=4, n_kv=2, d_ff=64, head_dim=16,
        act="silu", glu=True, norm="rms", qk_norm=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64, num_shared=0),
    )
