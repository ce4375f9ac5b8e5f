"""Popcount checksum: per-block bit counts (buffer checksum = sum + 1, so
zero means never written)."""

from repro_torch.kernels.popcnt_checksum.ops import (  # noqa: F401
    popcount_blocks,
    popcount_checksum,
)
