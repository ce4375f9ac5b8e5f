"""Plain PyTorch version of the flush scan kernel."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import as_blocks, block_popcounts, blocks_differ


def flush_scan_ref(cur: torch.Tensor, snap: torch.Tensor, block_bytes: int,
                   kind: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat uint8 ``cur``/``snap`` → ``(flags, counts)``, both
    ``(nblocks,)`` int32: dirty flags (lanes compared as ``kind``) and
    popcounts of ``cur``."""
    flags = blocks_differ(cur, snap, block_bytes, kind).to(torch.int32)
    counts = block_popcounts(as_blocks(cur, block_bytes)).to(torch.int32)
    return flags, counts
