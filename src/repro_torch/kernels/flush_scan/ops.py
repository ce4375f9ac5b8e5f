"""Public op: per-block dirty flags and popcounts of a flat buffer in one
pass.

``flush_pack`` subsumes it on the save path; it is the two-output
primitive, equal to ``dirty_blocks`` and ``popcount_blocks`` composed. On
a CUDA tensor it launches ``csrc/flush_scan.cu``, which replaces the TPU
kernel ``flush_scan_blocked`` (src/repro/kernels/flush_scan/kernel.py).
It is bound by device-memory bytes: it reads both buffers once and
writes 8 bytes per block; one CTA per block. The reference pads the
block count to a whole TPU tile; the port returns exactly ``nblocks``
entries and pads nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    I32,
    I64,
    TPU_TILE,
    VOIDP,
    as_bytes,
    check_block_bytes,
    check_kernel_input,
    compare_kind,
    nblocks_for,
    stream_of,
    use_kernel,
)
from repro_torch.kernels.flush_scan.ref import flush_scan_ref

_SIGNATURES = {"flush_scan": (VOIDP, VOIDP, I64, I64, I64, I32, VOIDP, VOIDP,
                              VOIDP)}


def flush_scan(cur: torch.Tensor, snap: torch.Tensor, *,
               block_bytes: int = TPU_TILE,
               impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flags, counts)``, both ``(nblocks,)`` int32: 1 where a block of
    ``cur`` differs from ``snap``'s (values for a floating dtype, else
    bytes) and the popcount of ``cur``'s block (the tail reads as
    zero-padded). A CUDA tensor launches the kernel, a CPU tensor or
    ``impl="ref"`` takes the plain version."""
    if cur.shape != snap.shape or cur.dtype != snap.dtype:
        raise ValueError("cur and snap must match in shape and dtype")
    if cur.device != snap.device:
        raise ValueError("cur and snap must lie on one device")
    block_bytes = check_block_bytes(block_bytes)
    kind = compare_kind(cur.dtype)
    a, b = as_bytes(cur), as_bytes(snap)
    if not use_kernel(a, impl):
        return flush_scan_ref(a, b, block_bytes, kind)
    check_kernel_input(a, "cur")
    check_kernel_input(b, "snap")
    nb = nblocks_for(a.numel(), block_bytes)
    flags = torch.empty(nb, dtype=torch.int32, device=a.device)
    counts = torch.empty(nb, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        lib = build.library("flush_scan", _SIGNATURES)
        build.check(lib.flush_scan(a.data_ptr(), b.data_ptr(), a.numel(),
                                   block_bytes, nb, kind, flags.data_ptr(),
                                   counts.data_ptr(), stream_of(a)),
                    "flush_scan")
    flush_scan.launches += 1
    return flags, counts


#: kernel launches since the count was last set to 0
flush_scan.launches = 0
