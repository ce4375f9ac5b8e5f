"""Plain PyTorch version of the fused flush pipeline.

Dirty block *b* lands at packed row ``offsets[b]``, the exclusive prefix
sum of the dirty flags. ``compact_index`` and ``exclusive_prefix_sum`` are
also the staged save path's compaction (the JAX package computes them
with jnp, outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import as_blocks, block_popcounts


def exclusive_prefix_sum(flags: torch.Tensor) -> torch.Tensor:
    """``(nblocks,)`` dirty flags → ``(nblocks,)`` int32 exclusive prefix
    sum (the packed row of each dirty block)."""
    f = flags.to(torch.int32)
    return torch.cumsum(f, 0, dtype=torch.int32) - f


def compact_index(flags: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(index, total)``: the first ``total`` entries of the
    ``(nblocks,)`` int32 ``index`` are the dirty block ids in ascending
    order, the rest zero."""
    index = torch.zeros(flags.shape[0], dtype=torch.int32, device=flags.device)
    dirty = torch.nonzero(flags).reshape(-1).to(torch.int32)
    total = int(dirty.numel())
    index[:total] = dirty
    return index, total


def flush_pack_ref(cur: torch.Tensor, snap: torch.Tensor, block_bytes: int):
    """Flat uint8 ``cur``/``snap`` → ``(flags, counts, offsets, packed,
    index, total)``: int32 flags, int32 popcounts of ``cur``, int32
    exclusive prefix sum of the flags, ``(nblocks, block_bytes)`` uint8
    ``packed`` whose first ``total`` rows are the dirty blocks in
    ascending order, int32 ``index`` of their ids; tails zero."""
    cb = as_blocks(cur, block_bytes)
    sb = as_blocks(snap, block_bytes)
    flags = (cb != sb).any(dim=1).to(torch.int32)
    counts = block_popcounts(cb).to(torch.int32)
    offsets = exclusive_prefix_sum(flags)
    index, total = compact_index(flags)
    packed = torch.zeros_like(cb)
    packed[:total] = cb[index[:total].long()]
    return flags, counts, offsets, packed, index, total
