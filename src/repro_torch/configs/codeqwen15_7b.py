"""codeqwen1.5-7b [dense] — qwen1.5-arch (MHA).

32L d_model=4096 32H (kv=32, head_dim 128) d_ff=13440 vocab=92416.
[hf:Qwen/CodeQwen1.5-7B; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92_416,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="codeqwen-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        tp_heads_multiple=1, vocab_pad=16)
