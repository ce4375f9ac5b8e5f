"""Fused restore pipeline: one device pass of verify + scatter + apply per
leaf on every restore (flush_pack's inverse)."""

from repro_torch.kernels.apply_unpack.ops import ApplyUnpack, apply_unpack  # noqa: F401
