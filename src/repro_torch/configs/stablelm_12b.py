"""stablelm-12b [dense].

40L d_model=5120 32H (GQA kv=8, head_dim 160) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-12b; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100_352,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        tp_heads_multiple=1, vocab_pad=16)
