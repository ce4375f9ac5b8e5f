"""Plain PyTorch version of the fused restore pipeline.

Packed block *i* lands at block ``idx[i]`` of the output, in place, and
its popcount is compared with ``expected[i]``. Verification is reported,
not enforced: the caller discards the image when a verdict fails. A
destination past the output's end is dropped (as a JAX scatter drops an
out-of-range update), and a partial last block is clipped.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import block_popcounts
from repro_torch.kernels.delta_pack.ref import delta_scatter_ref


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
    delta_scatter_ref(out, packed, idx, block_bytes)
    return ok, counts.to(torch.int32)
