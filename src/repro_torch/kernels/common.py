"""Shared byte geometry and dispatch of the port's persistence kernels.

The JAX package views a flat buffer as ``(nblocks, rows, 128)`` so that
every block is whole (8, 128) TPU tiles. On the card a block is plain
bytes: each kernel takes a 16-byte-aligned byte buffer, its length, and
``block_bytes``, and reads a ragged tail as if zero-padded to the next
block — what :func:`as_blocks` does for the plain versions here and what
``repro.kernels.common.as_blocks`` does on the TPU. The 4 KiB dirty block
itself (``TPU_TILE``) stays: it is a file-format constant recorded in the
pool superblock, so that either package restores the other's checkpoints.

Dispatch follows the tensor, not a backend probe: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version, and
``impl="ref"`` forces the plain version on any device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.blocks import TPU_TILE

__all__ = ["IMPLS", "TPU_TILE", "as_blocks", "as_bytes", "block_popcounts",
           "check_block_bytes", "check_kernel_input", "nblocks_for",
           "stream_of", "use_kernel"]

#: the ``impl=`` values every wrapper takes (the JAX package's names):
#: "auto", "fused" and "pallas" run the hand-written kernel on a CUDA
#: tensor; "ref" runs the plain version on any device
IMPLS = ("auto", "fused", "pallas", "ref")

#: the kernels count a block's set bits in 32 bits; the wrappers return
#: them as int32, exact below 2**31 bits = 2**28 bytes
MAX_BLOCK_BYTES = 1 << 28

VOIDP = ctypes.c_void_p
I64 = ctypes.c_longlong


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

