"""Public op: per-block popcounts of a flat buffer of any dtype.

The checkpoint's page checksums (popcount + 1 mod 2**32, the Zero-log
validity word) come from these counts. On a CUDA tensor the op launches
``csrc/popcnt_checksum.cu``, which replaces the TPU kernel
``popcnt_blocked`` (src/repro/kernels/popcnt_checksum/kernel.py). It is
bound by device-memory bytes: it reads each byte once and writes 4 bytes
per block; one CTA per block streams 16-byte vectors and reduces with
warp shuffles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    I64,
    TPU_TILE,
    VOIDP,
    as_bytes,
    check_block_bytes,
    check_kernel_input,
    nblocks_for,
    stream_of,
    use_kernel,
)
from repro_torch.kernels.popcnt_checksum.ref import popcnt_blocks_ref

_SIGNATURES = {"popcnt_blocks": (VOIDP, I64, I64, I64, VOIDP, VOIDP)}


def popcount_blocks(x: torch.Tensor, *, block_bytes: int = TPU_TILE,
                    impl: str = "auto") -> torch.Tensor:
    """``(nblocks,)`` int32 popcounts of ``x``'s bytes in blocks of
    ``block_bytes`` (the tail reads as zero-padded). A CUDA tensor
    launches the kernel, a CPU tensor or ``impl="ref"`` takes the plain
    version. The launch does not synchronise."""
    block_bytes = check_block_bytes(block_bytes)
    buf = as_bytes(x)
    if not use_kernel(buf, impl):
        return popcnt_blocks_ref(buf, block_bytes)
    check_kernel_input(buf, "x")
    nb = nblocks_for(buf.numel(), block_bytes)
    counts = torch.empty(nb, dtype=torch.int32, device=buf.device)
    with torch.cuda.device(buf.device):
        lib = build.library("popcnt_checksum", _SIGNATURES)
        build.check(lib.popcnt_blocks(buf.data_ptr(), buf.numel(), block_bytes,
                                      nb, counts.data_ptr(), stream_of(buf)),
                    "popcnt_blocks")
    popcount_blocks.launches += 1
    return counts


#: kernel launches since the count was last set to 0
popcount_blocks.launches = 0


def popcount_checksum(x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """0-d int64: popcount(x) + 1 (mod 2**32), so 0 always means "never
    written" — the paper's cnt==0 convention."""
    per_block = popcount_blocks(x, impl=impl)
    return (per_block.sum(dtype=torch.int64) + 1) & 0xFFFFFFFF
