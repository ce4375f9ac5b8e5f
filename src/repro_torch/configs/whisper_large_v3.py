"""whisper-large-v3 [audio] — encoder-decoder backbone, conv frontend stub.

32L decoder (+32L encoder) d_model=1280 20H (MHA, head_dim 64) d_ff=5120
vocab=51866 (padded 51968). Heads padded 20→32 for TP. ``input_specs()``
provides precomputed mel-frame embeddings (post-conv features) per the
assignment. [arXiv:2212.04356; unverified]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    encoder_layers=32,
    ffn_kind="gelu",
    frontend="audio_frames",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encoder_layers=2, tp_heads_multiple=1, vocab_pad=16)
