"""mamba2-1.3b [ssm] — 48L d=2048 attn-free vocab=50280 ssm_state=128.

arXiv:2405.21060 — SSD (state-space duality): expand 2 (d_inner 4096),
head_dim 64 (64 heads), 1 group, conv4, chunked scan (K4), tied embeddings.
No KV cache: decode carries an O(1) SSM state.
"""

from repro_torch.models.mamba2 import Mamba2Config

ARCH_ID = "mamba2-1.3b"


def config() -> Mamba2Config:
    return Mamba2Config(
        name=ARCH_ID, vocab=50_280, d_model=2_048, n_layers=48,
        d_state=128, expand=2, head_dim=64, n_groups=1, d_conv=4, chunk=256,
        tie_embeddings=True,
    )


def reduced() -> Mamba2Config:
    return Mamba2Config(
        name=ARCH_ID + "-reduced", vocab=512, d_model=64, n_layers=2,
        d_state=16, expand=2, head_dim=16, n_groups=1, d_conv=4, chunk=16,
        tie_embeddings=True,
    )
