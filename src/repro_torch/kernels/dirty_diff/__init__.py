"""Dirty diff: per-block changed/clean flags of a live buffer against its
last-flushed snapshot."""

from repro_torch.kernels.dirty_diff.ops import dirty_blocks  # noqa: F401
