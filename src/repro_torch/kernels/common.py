"""Shared byte geometry and dispatch of the port's persistence kernels.

The JAX package views a flat buffer as ``(nblocks, rows, 128)`` so that
every block is whole (8, 128) TPU tiles. On the card a block is plain
bytes: each kernel takes a 16-byte-aligned byte buffer, its length, and
``block_bytes``, and reads a ragged tail as if zero-padded to the next
block — what :func:`as_blocks` does for the plain versions here and what
``repro.kernels.common.as_blocks`` does on the TPU. The 4 KiB dirty block
itself (``TPU_TILE``) stays: it is a file-format constant recorded in the
pool superblock, so that either package restores the other's checkpoints.

Dirty flags compare values where the reference does: a block of float16,
bfloat16 or float32 is dirty iff some element differs in IEEE terms (±0
are equal, a NaN differs from everything, itself included), as ``cur !=
snap`` in the JAX package. Integer and bool dtypes compare their bytes,
which is their value compare; other floating and complex dtypes are
refused, as the reference takes 1-, 2- and 4-byte dtypes only. The
checkpoint hands the kernels ``uint8`` views, so on its path a flag is a
byte compare in both packages.

Dispatch follows the tensor, not a backend probe: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version, and
``impl="ref"`` forces the plain version on any device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.blocks import TPU_TILE

__all__ = ["IMPLS", "TPU_TILE", "as_blocks", "as_bytes", "as_vector",
           "block_popcounts", "blocks_differ", "check_block_bytes",
           "check_kernel_input", "compare_kind", "nblocks_for", "stream_of",
           "use_kernel"]

#: the ``impl=`` values every wrapper takes (the JAX package's names):
#: "auto", "fused" and "pallas" run the hand-written kernel on a CUDA
#: tensor; "ref" runs the plain version on any device
IMPLS = ("auto", "fused", "pallas", "ref")

#: the kernels count a block's set bits in 32 bits; the wrappers return
#: them as int32, exact below 2**31 bits = 2**28 bytes
MAX_BLOCK_BYTES = 1 << 28

VOIDP = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int

#: how the dirty-flag kernels compare a lane (``repro::Compare`` in
#: ``csrc/blocks.cuh``): bytes, or IEEE values of the lane's float type
BYTES, F16, BF16, F32 = range(4)
_LANE_DTYPE = {F16: torch.float16, BF16: torch.bfloat16, F32: torch.float32}
_KIND_OF = {dt: kind for kind, dt in _LANE_DTYPE.items()}


def use_kernel(t: torch.Tensor, impl: str) -> bool:
    """True when the call goes to the CUDA kernel: ``t`` lies on a CUDA
    device and ``impl`` does not ask for the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: expected one of {IMPLS}")
    return impl != "ref" and t.device.type == "cuda"


def check_block_bytes(block_bytes: int) -> int:
    block_bytes = int(block_bytes)
    if block_bytes <= 0 or block_bytes % 16 or block_bytes > MAX_BLOCK_BYTES:
        raise ValueError(f"block_bytes={block_bytes}: must be a positive "
                         f"multiple of 16 bytes, at most {MAX_BLOCK_BYTES}")
    return block_bytes


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """Flat ``uint8`` view of a contiguous tensor's bytes (no copy)."""
    if not t.is_contiguous():
        raise ValueError("the persistence kernels take contiguous tensors")
    flat = t.reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def compare_kind(dtype: torch.dtype) -> int:
    """The dirty-flag compare of ``dtype``: IEEE values for float16,
    bfloat16 and float32, bytes for integer and bool dtypes."""
    if dtype in _KIND_OF:
        return _KIND_OF[dtype]
    if dtype.is_floating_point or dtype.is_complex:
        raise ValueError(f"dirty flags compare float16, bfloat16 and float32 "
                         f"by value, as the reference does; {dtype} is not "
                         f"supported (pass a uint8 view to compare bytes)")
    return BYTES


def blocks_differ(cur: torch.Tensor, snap: torch.Tensor, block_bytes: int,
                  kind: int) -> torch.Tensor:
    """Plain ``(nblocks,)`` bool: some lane of a block of flat uint8
    ``cur`` differs from ``snap``'s under compare ``kind`` (the tails are
    zero-padded on both sides, so they never differ)."""
    a, b = as_blocks(cur, block_bytes), as_blocks(snap, block_bytes)
    if kind != BYTES:
        a, b = a.view(_LANE_DTYPE[kind]), b.view(_LANE_DTYPE[kind])
    return (a != b).any(dim=1)


def as_vector(x, np_dtype, dtype: torch.dtype, device) -> torch.Tensor:
    """A flat contiguous ``dtype`` tensor on ``device`` from a tensor or
    anything numpy takes (an index or a vector of checksums)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(-1).contiguous()
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, dtype=np_dtype).reshape(-1))
    ).to(device=device, dtype=dtype)


def nblocks_for(nbytes: int, block_bytes: int) -> int:
    """Blocks of a ``nbytes`` buffer (at least one, like ``as_blocks``)."""
    return max(1, -(-int(nbytes) // int(block_bytes)))


def as_blocks(flat: torch.Tensor, block_bytes: int) -> torch.Tensor:
    """``(nblocks, block_bytes)`` uint8 of a flat byte tensor, the tail
    zero-padded (a copy only when padding is needed)."""
    n = flat.numel()
    nb = nblocks_for(n, block_bytes)
    if nb * block_bytes != n:
        flat = torch.nn.functional.pad(flat, (0, nb * block_bytes - n))
    return flat.view(nb, block_bytes)


def block_popcounts(blocks: torch.Tensor) -> torch.Tensor:
    """Plain per-row popcount of a ``(nblocks, block_bytes)`` uint8 tensor
    → ``(nblocks,)`` int64 (bit tricks on bytes: no lookup table, no
    widening of the whole buffer)."""
    x = blocks - ((blocks >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dim=1, dtype=torch.int64)


def check_kernel_input(t: torch.Tensor, what: str) -> None:
    """What every kernel needs of a byte buffer it is given."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on a CUDA device, got {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned for the kernel's "
                         f"vector loads")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream

