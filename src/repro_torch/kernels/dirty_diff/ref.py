"""Plain PyTorch version of the dirty_diff kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import as_blocks


def dirty_diff_ref(cur: torch.Tensor, snap: torch.Tensor,
                   block_bytes: int) -> torch.Tensor:
    """Flat uint8 ``cur``/``snap`` → ``(nblocks,)`` int32 dirty flags."""
    return (as_blocks(cur, block_bytes) != as_blocks(snap, block_bytes)
            ).any(dim=1).to(torch.int32)
