"""The model, ported from ``repro.models``: every family of the JAX
package (the dense GQA decoder with SwiGLU, the RG-LRU hybrid, M-RoPE,
the MoE family with MLA, the Mamba2 SSD model and whisper's
encoder-decoder), in PyTorch."""

from repro_torch.models.config import ModelConfig, Segment  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    Model,
    ParamTree,
    decode_step,
    encode,
    forward,
    init_caches,
    init_params,
    lm_loss,
)
