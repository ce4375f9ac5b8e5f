"""Plain PyTorch versions of the delta gather and scatter.

Both work on the flat buffer's bytes cut into ``block_bytes`` blocks, the
last one zero-padded (``as_blocks``): the gather reads the padding as
zero, the scatter writes only the bytes below the buffer's end. A block
id outside ``[0, nblocks)`` gathers a zero block and is dropped as a
scatter destination, as in the CUDA kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import as_blocks, nblocks_for


def delta_gather_ref(src: torch.Tensor, idx: torch.Tensor,
                     block_bytes: int) -> torch.Tensor:
    """Flat uint8 ``src``, int32 ``idx`` (k,) → ``(k, block_bytes)`` uint8
    with row i = block ``idx[i]``."""
    blocks = as_blocks(src, block_bytes)
    ids = idx.to(torch.int64)
    inside = (ids >= 0) & (ids < blocks.shape[0])
    out = blocks[torch.where(inside, ids, 0)]
    out[~inside] = 0
    return out


def delta_scatter_ref(out: torch.Tensor, upd: torch.Tensor, idx: torch.Tensor,
                      block_bytes: int) -> None:
    """Write row i of ``upd`` (k whole blocks, flat uint8) over block
    ``idx[i]`` of flat uint8 ``out``, in place (ids duplicate-free)."""
    k = upd.numel() // block_bytes
    rows = upd.view(k, block_bytes)
    n = out.numel()
    full = n // block_bytes
    dst = idx.to(torch.int64)
    whole = (dst >= 0) & (dst < full)
    if full:
        out[: full * block_bytes].view(full, block_bytes)[dst[whole]] = rows[whole]
    if full < nblocks_for(n, block_bytes):
        last = torch.nonzero(dst == full).reshape(-1)
        if last.numel():
            out[full * block_bytes:] = rows[last[-1], : n - full * block_bytes]
