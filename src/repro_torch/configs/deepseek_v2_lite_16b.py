"""deepseek-v2-lite-16b [moe] — 27L d=2048 16H ff(expert)=1408 vocab=102400.

[arXiv:2405.04434; hf] — MLA with kv_lora=512 + decoupled RoPE (64-dim shared
key), MoE with 64 routed experts top-6 + 2 shared experts, first layer dense
(ff 10944).  160 routed experts is the non-Lite DeepSeek-V2; this is the
Lite config (64 routed), as in the HF reference and the JAX package.
"""

from repro_torch.models.transformer import MLAConfig, MoEConfig, TransformerConfig

ARCH_ID = "deepseek-v2-lite-16b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID, vocab=102_400, d_model=2_048, n_layers=27,
        n_heads=16, n_kv=16, d_ff=10_944,
        act="silu", glu=True, norm="rms",
        mla=MLAConfig(kv_lora=512, rope_head_dim=64, nope_head_dim=128,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1_408, num_shared=2,
                      first_dense_layers=1, dense_d_ff=10_944),
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-reduced", vocab=512, d_model=64, n_layers=3,
        n_heads=4, n_kv=4, d_ff=256,
        act="silu", glu=True, norm="rms",
        mla=MLAConfig(kv_lora=32, rope_head_dim=8, nope_head_dim=16,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                      first_dense_layers=1, dense_d_ff=256),
    )
