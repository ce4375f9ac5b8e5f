"""The model, ported from ``repro.models``: the dense family (GQA decoder
with SwiGLU), the RG-LRU hybrid, M-RoPE, and the MoE family with MLA, in
PyTorch."""

from repro_torch.models.config import ModelConfig, Segment  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    Model,
    ParamTree,
    decode_step,
    forward,
    init_caches,
    init_params,
    lm_loss,
)
