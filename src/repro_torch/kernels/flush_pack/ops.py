"""Public op: fused diff + pack + checksum of a flat buffer.

Every delta save runs this once per leaf: dirty flags against the
snapshot, popcounts of the live bytes, prefix-sum offsets, the packed
dirty blocks and their ids. On a CUDA tensor it launches
``csrc/flush_pack.cu`` (three launches on the current stream: scan,
prefix sum, pack), which replaces the TPU kernel ``flush_pack_blocked``
(src/repro/kernels/flush_pack/kernel.py). It is bound by device-memory
bytes: 2n read by the scan, the dirty blocks read again and all of
``packed`` written by the pack (see the source for why the TPU's
in-order carry became a separate scan). The dirty total is the one host
sync, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

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
from repro_torch.kernels.flush_pack.ref import flush_pack_ref

_SIGNATURES = {"flush_pack": (VOIDP, VOIDP, I64, I64, I64, VOIDP, VOIDP,
                              VOIDP, VOIDP, VOIDP, VOIDP)}


class FlushPack(NamedTuple):
    """Everything one fused pass yields about a buffer.

    ``flags``: (nblocks,) int32 dirty bitmap vs the snapshot.
    ``counts``: (nblocks,) int32 popcounts of the live bytes.
    ``offsets``: (nblocks,) int32 exclusive prefix sum of ``flags``.
    ``packed``: (nblocks, block_bytes // itemsize) in the live dtype; the
    first ``total`` rows are the dirty blocks in ascending order, the
    rest zero.
    ``index``: (nblocks,) int32; the first ``total`` entries are the dirty
    block ids, the rest zero.
    ``total``: python int dirty-block count (the only host sync).
    """

    flags: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    packed: torch.Tensor
    index: torch.Tensor
    total: int


def flush_pack(cur: torch.Tensor, snap: torch.Tensor, *,
               block_bytes: int = TPU_TILE,
               impl: str = "auto") -> FlushPack:
    """Fused diff + pack + checksum of ``cur`` against ``snap`` (same
    shape and dtype, one device). A CUDA tensor launches the kernel, a CPU
    tensor or ``impl="ref"`` takes the plain version."""
    if cur.shape != snap.shape or cur.dtype != snap.dtype:
        raise ValueError("cur and snap must match in shape and dtype")
    if cur.device != snap.device:
        raise ValueError("cur and snap must lie on one device")
    block_bytes = check_block_bytes(block_bytes)
    a, b = as_bytes(cur), as_bytes(snap)
    if not use_kernel(a, impl):
        flags, counts, offsets, packed, index, total = flush_pack_ref(
            a, b, block_bytes)
    else:
        check_kernel_input(a, "cur")
        check_kernel_input(b, "snap")
        nb = nblocks_for(a.numel(), block_bytes)
        dev = a.device
        flags = torch.empty(nb, dtype=torch.int32, device=dev)
        counts = torch.empty(nb, dtype=torch.int32, device=dev)
        offs = torch.empty(nb + 1, dtype=torch.int32, device=dev)
        packed = torch.empty(nb, block_bytes, dtype=torch.uint8, device=dev)
        index = torch.empty(nb, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            lib = build.library("flush_pack", _SIGNATURES)
            build.check(lib.flush_pack(
                a.data_ptr(), b.data_ptr(), a.numel(), block_bytes, nb,
                flags.data_ptr(), counts.data_ptr(), offs.data_ptr(),
                packed.data_ptr(), index.data_ptr(), stream_of(a)),
                "flush_pack")
        flush_pack.launches += 3          # scan, prefix sum, pack
        offsets = offs[:nb]
        total = int(offs[nb])
    packed = packed.view(cur.dtype) if cur.dtype != torch.uint8 else packed
    return FlushPack(flags, counts, offsets, packed, index, total)


#: CUDA launches (three for each call) since the count was last set to 0
flush_pack.launches = 0
