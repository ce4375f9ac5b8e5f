"""Public op: fused verify + scatter + apply of packed blocks, in place.

Every restore runs this once per leaf: each packed page is popcounted
against the checksum its manifest recorded and written to its block of
the leaf image. On a CUDA tensor it launches ``csrc/apply_unpack.cu``,
which replaces the TPU kernel ``apply_unpack_blocked``
(src/repro/kernels/apply_unpack/kernel.py). That kernel aliased the base
image into its output; here the base tensor itself is updated in place
and returned as ``out``. It is bound by device-memory bytes: each packed
byte is read once and written once; one CTA per packed block streams
16-byte vectors, counting them on the way through. The count of failed
verdicts is the one host sync, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    I64,
    TPU_TILE,
    VOIDP,
    as_bytes,
    check_block_bytes,
    check_kernel_input,
    stream_of,
    use_kernel,
)
from repro_torch.kernels.apply_unpack.ref import apply_unpack_ref

_SIGNATURES = {"apply_unpack": (VOIDP, I64, I64, VOIDP, VOIDP, VOIDP, I64,
                                VOIDP, VOIDP, VOIDP)}


class ApplyUnpack(NamedTuple):
    """What one fused restore pass yields.

    ``out``: the base tensor, with packed block i written over its block
    ``index[i]`` (other blocks keep their bytes).
    ``ok``: (k,) int32; 1 iff packed block i's popcount equals
    ``expected[i]``.
    ``counts``: (k,) int32 popcounts of the packed blocks.
    ``nbad``: python int count of failed verdicts (the only host sync).
    """

    out: torch.Tensor
    ok: torch.Tensor
    counts: torch.Tensor
    nbad: int


def _vector(x, np_dtype, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(-1).contiguous()
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, dtype=np_dtype).reshape(-1))
    ).to(device=device, dtype=dtype)


def apply_unpack(base: torch.Tensor, packed: torch.Tensor, index, expected,
                 *, block_bytes: int = TPU_TILE,
                 impl: str = "auto") -> ApplyUnpack:
    """Verify and scatter ``packed`` (k whole blocks of ``block_bytes``)
    onto ``base`` in place: block i goes to block ``index[i]``
    (duplicate-free) and is checked against ``expected[i]`` (popcounts,
    0 ≤ value < 2**32). A CUDA ``base`` launches the kernel, a CPU one or
    ``impl="ref"`` takes the plain version."""
    if packed.dtype != base.dtype:
        raise ValueError("base and packed must share a dtype")
    if packed.device != base.device:
        raise ValueError("base and packed must lie on one device")
    block_bytes = check_block_bytes(block_bytes)
    out = as_bytes(base)
    pk = as_bytes(packed)
    if pk.numel() % block_bytes:
        raise ValueError(f"packed ({pk.numel()} bytes) is not whole "
                         f"{block_bytes}-byte blocks")
    k = pk.numel() // block_bytes
    idx = _vector(index, np.int32, torch.int32, base.device)
    exp = _vector(expected, np.int64, torch.int64, base.device)
    if idx.numel() != k or exp.numel() != k:
        raise ValueError(f"index and expected need {k} entries, got "
                         f"{idx.numel()} and {exp.numel()}")
    if k == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=base.device)
        return ApplyUnpack(base, empty, empty.clone(), 0)
    if not use_kernel(out, impl):
        ok, counts = apply_unpack_ref(out, pk, idx, exp, block_bytes)
    else:
        check_kernel_input(out, "base")
        check_kernel_input(pk, "packed")
        ok = torch.empty(k, dtype=torch.int32, device=base.device)
        counts = torch.empty(k, dtype=torch.int32, device=base.device)
        with torch.cuda.device(base.device):
            lib = build.library("apply_unpack", _SIGNATURES)
            build.check(lib.apply_unpack(
                pk.data_ptr(), block_bytes, k, idx.data_ptr(), exp.data_ptr(),
                out.data_ptr(), out.numel(), ok.data_ptr(), counts.data_ptr(),
                stream_of(out)),
                "apply_unpack")
        apply_unpack.launches += 1
    nbad = int(k - int(ok.sum()))
    return ApplyUnpack(base, ok, counts, nbad)


#: kernel launches since the count was last set to 0
apply_unpack.launches = 0
