"""Flush scan: per-block dirty flags and popcounts of a live buffer in one
pass (flush_pack's first launch on its own)."""

from repro_torch.kernels.flush_scan.ops import flush_scan  # noqa: F401
