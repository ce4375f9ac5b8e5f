"""tinyllama-1.1b [dense] — llama2-arch small.

22L d_model=2048 32H (GQA kv=4, head_dim 64) d_ff=5632 vocab=32000.
[arXiv:2401.02385; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32_000,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="tinyllama-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        tp_heads_multiple=1, vocab_pad=16)
