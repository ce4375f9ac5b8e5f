"""Plain PyTorch version of the popcount-checksum kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import as_blocks, block_popcounts


def popcnt_blocks_ref(buf: torch.Tensor, block_bytes: int) -> torch.Tensor:
    """Flat uint8 ``buf`` → ``(nblocks,)`` int32 per-block popcounts."""
    return block_popcounts(as_blocks(buf, block_bytes)).to(torch.int32)
