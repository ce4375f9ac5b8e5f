"""Shared neural building blocks, the port of ``repro.models.layers``.

Parameters are nested dicts of tensors in the JAX package's layout: a
dense weight is ``(in, out)`` and is applied as ``x @ w`` (not
``nn.Linear``'s transpose), so checkpoint keys, shapes and bytes are the
reference's. Every ``*_init`` draws from an explicit ``torch.Generator``
(``None`` on the ``meta`` device, where nothing is drawn) and takes a
leading ``lead`` shape for leaves stacked over layers. The numerics
mirror the reference: norms, RoPE, softmax and the loss in float32, the
matrix products in the parameters' dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["apply_rope", "dense_init", "embed_apply", "embed_init",
           "ffn_apply", "ffn_init", "gelu_tanh", "mrope_angles", "rmsnorm",
           "rmsnorm_init", "rope_angles", "silu", "softmax_xent",
           "softplus", "unembed_apply"]


def _randn(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, *, device,
               scale: Optional[float] = None, lead=()) -> torch.Tensor:
    """``(*lead, in_dim, out_dim)`` normal times ``1/sqrt(in_dim)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (_randn(gen, (*lead, in_dim, out_dim), device) * scale).to(dtype)


# ------------------------------------------------------------------ RMSNorm

def rmsnorm_init(d: int, dtype, *, device, lead=()) -> torch.Tensor:
    return torch.ones((*lead, d), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, the scale upcast, the result in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# --------------------------------------------------------------------- RoPE

def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int → cos/sin (..., dim/2) in float32."""
    half = dim // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, dim: int, theta: float,
                 sections: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE. positions (3, B, S): temporal, height and width
    ids. ``sections`` split the dim/2 frequency bands among the three, in
    order, all cut from one float32 angle tensor over the three rows (text
    tokens carry equal ids in all three, and then this is 1-D RoPE)."""
    if not positions.shape[0] == len(sections) == 3:
        raise ValueError(f"M-RoPE takes (3, B, S) positions and 3 sections, "
                         f"not {tuple(positions.shape)} and {sections}")
    half = dim // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not sum to {half}")
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang_all = positions.float()[..., None] * freqs       # (3, B, S, half)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                        # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., H, hd) rotated by halves (the first half against the
    second, not interleaved pairs); cos/sin broadcast (..., hd/2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[..., None, :]   # broadcast over heads
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


# ------------------------------------------------------------------- SwiGLU

def ffn_init(gen, d: int, f: int, dtype, kind: str = "swiglu", *, device,
             lead=()) -> dict:
    if kind == "gelu":
        return {"up": dense_init(gen, d, f, dtype, device=device, lead=lead),
                "down": dense_init(gen, f, d, dtype, device=device,
                                   lead=lead)}
    return {
        "gate": dense_init(gen, d, f, dtype, device=device, lead=lead),
        "up": dense_init(gen, d, f, dtype, device=device, lead=lead),
        "down": dense_init(gen, f, d, dtype, device=device, lead=lead),
    }


def _const(dtype, v: float) -> float:
    """``v`` rounded to ``dtype``, as JAX rounds a Python constant that
    meets an array of that dtype."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU that ``jax.nn.gelu`` defaults to,
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))`` with ``c =
    sqrt(2/pi)``, op by op in ``x``'s dtype: the constants are rounded to
    that dtype and ``x**3`` is ``(x * x) * x``, each step rounded, as the
    reference's optimized HLO computes it (``F.gelu(approximate="tanh")``
    rounds once)."""
    dt = x.dtype
    inner = x + _const(dt, 0.044715) * (x * x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_const(dt, math.sqrt(2 / math.pi)) * inner))
    return x * cdf


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` op by op in ``x``'s dtype, the form XLA
    lowers ``jax.nn.silu`` to, so each step rounds where the reference's
    does (``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    at every ``x`` (``F.softplus`` switches to ``x`` above its threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (``silu(x @ gate) * (x @ up)``, :func:`silu` op by op) or,
    without a gate, :func:`gelu_tanh`; then ``@ down``."""
    if "gate" in p:
        h = silu(x @ p["gate"]) * (x @ p["up"])
    else:
        h = gelu_tanh(x @ p["up"])
    return h @ p["down"]


# ---------------------------------------------------------------- embedding

def embed_init(gen, vocab: int, d: int, dtype, *, device) -> torch.Tensor:
    return (_randn(gen, (vocab, d), device) * 0.02).to(dtype)


def embed_apply(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), table)


def unembed_apply(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ table.T


# ------------------------------------------------------------------- loss

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean masked token cross-entropy in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
