"""Fused flush pipeline: one device pass of diff + pack + checksum per
leaf on every delta save."""

from repro_torch.kernels.flush_pack.ops import FlushPack, flush_pack  # noqa: F401
from repro_torch.kernels.flush_pack.ref import (  # noqa: F401
    compact_index,
    exclusive_prefix_sum,
)
