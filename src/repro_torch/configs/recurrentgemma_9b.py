"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.

38L d_model=4096 16H (GQA kv=1, head_dim 256) d_ff=12288 vocab=256000,
lru_width=4096, local window 2048. [arXiv:2402.19427; unverified]
Sub-quadratic (recurrence + sliding window) → runs long_500k.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    window=2048,
    lru_width=4096,
    block_pattern=("rec", "rec", "attn"),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", num_layers=6, d_model=128,
        num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256, vocab_size=512,
        lru_width=128, window=32, tp_heads_multiple=1, vocab_pad=16)
