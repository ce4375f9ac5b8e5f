"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768, d_inner=1536 (expand 2), ssm_state=128, head_dim 64
(→24 SSD heads, padded to 32 for TP), vocab=50280 (padded to 50432).
Sub-quadratic → runs long_500k. [arXiv:2405.21060; unverified]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_heads=24,
    ssm_head_dim=64,
    expand=2,
    conv_kernel=4,
    chunk=256,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", num_layers=4, d_model=64,
        ssm_state=16, ssm_heads=4, ssm_head_dim=16, vocab_size=512,
        chunk=16, tp_heads_multiple=1, vocab_pad=16)
