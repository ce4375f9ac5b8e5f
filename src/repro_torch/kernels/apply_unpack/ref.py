"""Plain PyTorch version of the fused restore pipeline.

Packed block *i* lands at block ``idx[i]`` of the output, in place, and
its popcount is compared with ``expected[i]``. Verification is reported,
not enforced: the caller discards the image when a verdict fails. A
destination past the output's end is dropped (as a JAX scatter drops an
out-of-range update), and a partial last block is clipped.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import block_popcounts, nblocks_for


def apply_unpack_ref(out: torch.Tensor, packed: torch.Tensor,
                     idx: torch.Tensor, expected: torch.Tensor,
                     block_bytes: int):
    """Flat uint8 ``out`` (updated in place) and ``packed`` (k whole
    blocks), int32 ``idx``, int64 ``expected`` → ``(ok, counts)``, both
    ``(k,)`` int32."""
    k = packed.numel() // block_bytes
    pb = packed.view(k, block_bytes)
    counts = block_popcounts(pb)
    ok = (counts == expected.to(torch.int64)).to(torch.int32)
    n = out.numel()
    full = n // block_bytes
    dst = idx.to(torch.int64)
    whole = (dst >= 0) & (dst < full)
    if full:
        out[: full * block_bytes].view(full, block_bytes)[dst[whole]] = pb[whole]
    if full < nblocks_for(n, block_bytes):
        last = torch.nonzero(dst == full).reshape(-1)
        if last.numel():
            out[full * block_bytes:] = pb[last[-1], : n - full * block_bytes]
    return ok, counts.to(torch.int32)
