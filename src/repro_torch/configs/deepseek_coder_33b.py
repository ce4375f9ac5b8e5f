"""deepseek-coder-33b [dense] — llama-arch.

62L d_model=7168 56H (GQA kv=8, head_dim 128) d_ff=19200 vocab=32256.
Heads padded 56→64 for 16-way tensor parallelism (dead-weight heads are
counted as padding overhead in the roofline). [arXiv:2401.14196; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32_256,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="dscoder-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        tp_heads_multiple=1, vocab_pad=16)
