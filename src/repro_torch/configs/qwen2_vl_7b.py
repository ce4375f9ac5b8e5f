"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (frontend stubbed).

28L d_model=3584 28H (GQA kv=4, head_dim 128) d_ff=18944 vocab=152064.
Heads padded 28→32 for TP. The vision tower is a stub per the assignment:
``input_specs()`` provides precomputed patch embeddings + M-RoPE position
ids (t/h/w sections 16/24/24 of the 64 rotary half-dims).
[arXiv:2409.12191; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    mrope_sections=(16, 24, 24),
    frontend="vision_patches",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2vl-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        mrope_sections=(4, 6, 6), tp_heads_multiple=1, vocab_pad=16)
