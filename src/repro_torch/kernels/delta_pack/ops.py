"""Public ops: pack blocks of a flat buffer into a dense delta, and apply
a delta back onto a buffer.

The staged chain's copies: ``pack_dirty`` is the save's gather after
``dirty_blocks`` and the shared compaction, ``apply_delta`` the restore's
scatter after a popcount verify. On a CUDA tensor they launch
``csrc/delta_pack.cu`` (``delta_gather``, ``delta_scatter``), which
replaces the TPU kernels ``delta_pack_blocked`` and
``delta_apply_blocked`` (src/repro/kernels/delta_pack/kernel.py). They are
bound by device-memory bytes: each reads and writes k blocks; each CTA
reads its block id from device memory and streams a chunk of the block
in 16-byte vectors. ``pack_dirty``'s dirty count is the one host sync, as
in the JAX package; ``pack_delta`` and ``apply_delta`` have none.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    I64,
    TPU_TILE,
    VOIDP,
    as_bytes,
    as_vector,
    check_block_bytes,
    check_kernel_input,
    stream_of,
    use_kernel,
)
from repro_torch.kernels.delta_pack.ref import delta_gather_ref, delta_scatter_ref
from repro_torch.kernels.flush_pack.ref import compact_index

_SIGNATURES = {
    "delta_gather": (VOIDP, I64, I64, I64, VOIDP, VOIDP, VOIDP),
    "delta_scatter": (VOIDP, I64, I64, VOIDP, VOIDP, I64, VOIDP),
}


def pack_delta(buf: torch.Tensor, idx, *, block_bytes: int = TPU_TILE,
               impl: str = "auto") -> torch.Tensor:
    """Gather blocks ``idx`` (k ids in ``[0, nblocks)``, any order) of the
    flat buffer ``buf`` → ``(k, block_bytes // itemsize)`` in ``buf``'s
    dtype; a ragged last block reads as zero-padded. A CUDA ``buf``
    launches the kernel, a CPU one or ``impl="ref"`` takes the plain
    version."""
    block_bytes = check_block_bytes(block_bytes)
    src = as_bytes(buf)
    ids = as_vector(idx, "int32", torch.int32, buf.device)
    k = ids.numel()
    if not use_kernel(src, impl):
        out = delta_gather_ref(src, ids, block_bytes)
    else:
        check_kernel_input(src, "buf")
        out = torch.empty(k, block_bytes, dtype=torch.uint8, device=buf.device)
        if k:
            with torch.cuda.device(buf.device):
                lib = build.library("delta_pack", _SIGNATURES)
                build.check(lib.delta_gather(
                    src.data_ptr(), src.numel(), block_bytes, k,
                    ids.data_ptr(), out.data_ptr(), stream_of(src)),
                    "delta_gather")
            pack_delta.launches += 1
    return out if buf.dtype == torch.uint8 else out.view(buf.dtype)


#: kernel launches since the count was last set to 0
pack_delta.launches = 0


def pack_dirty(buf: torch.Tensor, flags: torch.Tensor, *,
               block_bytes: int = TPU_TILE,
               impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pack the dirty blocks of ``buf`` given its ``(nblocks,)`` dirty
    flags: ``(delta (k, block_bytes // itemsize), idx (k,) int32, k)``,
    the ids ascending. The compaction is ``flush_pack``'s
    (``compact_index``); only ``k`` crosses to the host."""
    index, k = compact_index(flags)
    idx = index[:k]
    return pack_delta(buf, idx, block_bytes=block_bytes, impl=impl), idx, k


def apply_delta(buf: torch.Tensor, delta: torch.Tensor, idx, *,
                block_bytes: int = TPU_TILE,
                impl: str = "auto") -> torch.Tensor:
    """Scatter ``delta`` (k whole blocks in ``buf``'s dtype) onto the flat
    buffer ``buf`` **in place**: row i overwrites block ``idx[i]`` (ids
    duplicate-free; only the bytes below ``buf``'s end are written, and
    other blocks keep theirs). Returns ``buf`` itself, where the JAX
    package returns a new array. A CUDA ``buf`` launches the kernel, a CPU
    one or ``impl="ref"`` takes the plain version."""
    if delta.dtype != buf.dtype:
        raise ValueError("buf and delta must share a dtype")
    if delta.device != buf.device:
        raise ValueError("buf and delta must lie on one device")
    block_bytes = check_block_bytes(block_bytes)
    out = as_bytes(buf)
    upd = as_bytes(delta)
    if upd.numel() % block_bytes:
        raise ValueError(f"delta ({upd.numel()} bytes) is not whole "
                         f"{block_bytes}-byte blocks")
    k = upd.numel() // block_bytes
    ids = as_vector(idx, "int32", torch.int32, buf.device)
    if ids.numel() != k:
        raise ValueError(f"idx needs {k} entries, got {ids.numel()}")
    if k == 0:
        return buf
    if not use_kernel(out, impl):
        delta_scatter_ref(out, upd, ids, block_bytes)
        return buf
    check_kernel_input(out, "buf")
    check_kernel_input(upd, "delta")
    with torch.cuda.device(buf.device):
        lib = build.library("delta_pack", _SIGNATURES)
        build.check(lib.delta_scatter(
            upd.data_ptr(), block_bytes, k, ids.data_ptr(), out.data_ptr(),
            out.numel(), stream_of(out)),
            "delta_scatter")
    apply_delta.launches += 1
    return buf


#: kernel launches since the count was last set to 0
apply_delta.launches = 0
