"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2.

32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff(expert)=6400
vocab=32064. [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32_064,
    num_experts=16,
    top_k=2,
    moe_d_ff=6400,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi35-moe-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        num_experts=4, top_k=2, moe_d_ff=256, tp_heads_multiple=1, vocab_pad=16)
