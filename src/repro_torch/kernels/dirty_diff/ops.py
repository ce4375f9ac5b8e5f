"""Public op: dirty-block bitmap of a flat buffer against its snapshot.

The ``kernel_impl="staged"`` save path's first pass. On a CUDA tensor the
op launches ``csrc/dirty_diff.cu``, which replaces the TPU kernel
``dirty_diff_blocked`` (src/repro/kernels/dirty_diff/kernel.py). It is
bound by device-memory bytes: it reads both buffers once and writes 4
bytes per block; one CTA per block XORs 16-byte vectors and reduces with
``__syncthreads_or``. A floating dtype compares IEEE values, as the
reference's ``cur != snap`` does, any other dtype its bytes; the
checkpoint passes ``uint8`` views, so its flags are byte compares.
"""

from __future__ import annotations

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
from repro_torch.kernels.dirty_diff.ref import dirty_diff_ref

_SIGNATURES = {"dirty_diff": (VOIDP, VOIDP, I64, I64, I64, I32, VOIDP,
                              VOIDP)}


def dirty_blocks(cur: torch.Tensor, snap: torch.Tensor, *,
                 block_bytes: int = TPU_TILE,
                 impl: str = "auto") -> torch.Tensor:
    """``(nblocks,)`` int32: 1 where a block of ``cur`` differs from
    ``snap``'s (values for a floating dtype, else bytes; the tail reads
    as zero-padded on both sides)."""
    if cur.shape != snap.shape or cur.dtype != snap.dtype:
        raise ValueError("cur and snap must match in shape and dtype")
    if cur.device != snap.device:
        raise ValueError("cur and snap must lie on one device")
    block_bytes = check_block_bytes(block_bytes)
    kind = compare_kind(cur.dtype)
    a, b = as_bytes(cur), as_bytes(snap)
    if not use_kernel(a, impl):
        return dirty_diff_ref(a, b, block_bytes, kind)
    check_kernel_input(a, "cur")
    check_kernel_input(b, "snap")
    nb = nblocks_for(a.numel(), block_bytes)
    flags = torch.empty(nb, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        lib = build.library("dirty_diff", _SIGNATURES)
        build.check(lib.dirty_diff(a.data_ptr(), b.data_ptr(), a.numel(),
                                   block_bytes, nb, kind, flags.data_ptr(),
                                   stream_of(a)),
                    "dirty_diff")
    dirty_blocks.launches += 1
    return flags


#: kernel launches since the count was last set to 0
dirty_blocks.launches = 0
