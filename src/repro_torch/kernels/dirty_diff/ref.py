"""Plain PyTorch version of the dirty_diff kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import BYTES, blocks_differ


def dirty_diff_ref(cur: torch.Tensor, snap: torch.Tensor,
                   block_bytes: int, kind: int = BYTES) -> torch.Tensor:
    """Flat uint8 ``cur``/``snap`` → ``(nblocks,)`` int32 dirty flags,
    lanes compared as ``kind`` (``common.compare_kind``)."""
    return blocks_differ(cur, snap, block_bytes, kind).to(torch.int32)
