"""Training state carried between the JAX package and the port.

The JAX trainer checkpoints a flat ``{name: np.ndarray}`` dict
(``repro.launch.train.flatten_state``, bf16 leaves as ``ml_dtypes``
arrays); the port checkpoints ``{name: torch.Tensor}``. Leaves move
across as bytes, so no value is rounded, and the manifest names dtypes
the way numpy does (``"bfloat16"``, ``"float32"``) in both packages, so a
checkpoint written by one restores under the other. Key names stay the
JAX package's (``p/decoder/seg0/b0/attn/wq``, …).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["TINYLLAMA_1_1B_PARAMS", "dtype_name", "from_numpy", "init_state",
           "to_numpy", "torch_dtype"]

_NAMES: Dict[torch.dtype, str] = {
    torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
}
for _n in ("uint16", "uint32", "uint64"):   # newer torch only
    if hasattr(torch, _n):
        _NAMES[getattr(torch, _n)] = _n
_DTYPES = {v: k for k, v in _NAMES.items()}

#: tinyllama-1.1b's parameter leaves as the JAX package's ``init_params``
#: builds them: the 22 layers stacked on the leading axis of every
#: ``decoder/…`` leaf, all bf16 (2,200,096,768 bytes)
TINYLLAMA_1_1B_PARAMS: Dict[str, Tuple[Tuple[int, ...], str]] = {
    "decoder/seg0/b0/attn/wk": ((22, 2048, 256), "bfloat16"),
    "decoder/seg0/b0/attn/wo": ((22, 2048, 2048), "bfloat16"),
    "decoder/seg0/b0/attn/wq": ((22, 2048, 2048), "bfloat16"),
    "decoder/seg0/b0/attn/wv": ((22, 2048, 256), "bfloat16"),
    "decoder/seg0/b0/ffn/down": ((22, 5632, 2048), "bfloat16"),
    "decoder/seg0/b0/ffn/gate": ((22, 2048, 5632), "bfloat16"),
    "decoder/seg0/b0/ffn/up": ((22, 2048, 5632), "bfloat16"),
    "decoder/seg0/b0/norm1": ((22, 2048), "bfloat16"),
    "decoder/seg0/b0/norm2": ((22, 2048), "bfloat16"),
    "embed": ((32000, 2048), "bfloat16"),
    "final_norm": ((2048,), "bfloat16"),
    "head": ((32000, 2048), "bfloat16"),
}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` → ``"bfloat16"``)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"no checkpoint dtype name for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest's numpy dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} has no torch counterpart") from None


def from_numpy(flat: Dict[str, np.ndarray],
               device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's flat numpy state → tensors on ``device``, bytes
    unchanged (bf16 crosses as raw 16-bit words)."""
    out = {}
    for name, arr in flat.items():
        a = np.ascontiguousarray(arr)
        dt = torch_dtype(a.dtype.name)
        raw = torch.from_numpy(a.reshape(-1).view(np.uint8))
        out[name] = raw.view(dt).reshape(a.shape).to(device, copy=True)
    return out


def to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_numpy`: host numpy arrays, bf16 as
    ``ml_dtypes.bfloat16`` (imported only when a bf16 leaf needs it)."""
    out = {}
    for name, t in state.items():
        dn = dtype_name(t.dtype)
        if dn == "bfloat16":
            import ml_dtypes
            npd = np.dtype(ml_dtypes.bfloat16)
        else:
            npd = np.dtype(dn)
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
        out[name] = raw.numpy().view(npd).reshape(tuple(t.shape)).copy()
    return out


def init_state(table: Dict[str, Tuple[Tuple[int, ...], str]], *, seed: int,
               device="cuda", layers: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """Random parameter leaves of ``table`` (keys ``p/<name>``, as the
    trainer checkpoints them) on ``device``, normal times 0.02 from an
    explicit ``torch.Generator`` seeded with ``seed``. ``layers`` cuts the
    depth of the stacked ``decoder/…`` leaves (their leading axis) and
    never a width."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name in sorted(table):
        shape, dn = table[name]
        if layers is not None and name.startswith("decoder/"):
            shape = (int(layers),) + tuple(shape[1:])
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        out["p/" + name] = x.mul_(0.02).to(torch_dtype(dn))
    return out
