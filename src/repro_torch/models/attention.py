"""Grouped-query attention, the port of the GQA part of
``repro.models.attention``: ``gqa_init`` and the full-sequence path of
``gqa_apply`` (causal for the decoder, bidirectional when asked).

Heads are grouped as the reference groups them: q is viewed as
``(B, S, KV, G, hd)``, so q-head ``h = kv * G + g`` shares k/v head
``kv``. Scores are taken in the parameters' dtype and scaled in float32,
masked with ``-1e30``, softmaxed in float32 and cast back to the values'
dtype before the product with v, as ``repro.models.attention._attend``
does.

Not ported yet, and refused rather than computed another way: sequences
longer than ``FLASH_THRESHOLD`` (the reference's ``_attend_flash``),
sliding-window, cross and cached (decode) attention, and MLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, dense_init, rope_angles

__all__ = ["FLASH_THRESHOLD", "gqa_apply", "gqa_init"]

#: the reference switches to its chunked online-softmax path above this
#: length; the port refuses such sequences until that path is ported
FLASH_THRESHOLD = 2048


def gqa_init(gen, cfg, *, dtype, device, lead=()) -> Dict[str, torch.Tensor]:
    D, hd = cfg.d_model, cfg.raw_head_dim
    H, KV = cfg.padded_heads, cfg.padded_kv_heads
    kw = dict(device=device, lead=lead)
    return {
        "wq": dense_init(gen, D, H * hd, dtype, **kw),
        "wk": dense_init(gen, D, KV * hd, dtype, **kw),
        "wv": dense_init(gen, D, KV * hd, dtype, **kw),
        "wo": dense_init(gen, H * hd, D, dtype, scale=1.0 / math.sqrt(H * hd),
                         **kw),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _attend(q, k, v, mask, scale):
    """q (B,S,KV,G,hd), k (B,T,KV,hd), v (B,T,KV,hv), mask broadcastable
    to (B,KV,G,S,T) → (B,S,KV,G,hv)."""
    qh = q.permute(0, 2, 3, 1, 4)                   # B,KV,G,S,hd
    kh = k.permute(0, 2, 3, 1)[:, :, None]          # B,KV,1,hd,T
    scores = torch.matmul(qh, kh).float() * scale   # B,KV,G,S,T
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    vh = v.permute(0, 2, 1, 3)[:, :, None]          # B,KV,1,T,hv
    return torch.matmul(probs, vh).permute(0, 3, 1, 2, 4)


def gqa_apply(
    p,
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,             # (B,S)
    causal: bool = True,
    window: int = 0,
    cross: bool = False,
    kv_input: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention of ``x`` (B,S,D): ``(out @ wo, {"k", "v"})``."""
    if cross or kv_input is not None:
        raise NotImplementedError("cross attention is not ported yet")
    if cache is not None or cache_pos is not None:
        raise NotImplementedError("cached (decode) attention is not ported "
                                  "yet")
    if window:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet")
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE is not ported yet")
    B, S, D = x.shape
    if S > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"sequence length {S} > {FLASH_THRESHOLD}: the reference's "
            f"chunked (flash) attention path is not ported yet")
    hd = cfg.raw_head_dim
    H, KV = cfg.padded_heads, cfg.padded_kv_heads
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(_split_heads(x @ p["wq"], H), cos, sin)
    k = apply_rope(_split_heads(x @ p["wk"], KV), cos, sin)
    v = _split_heads(x @ p["wv"], KV)
    if causal:
        ar = torch.arange(S, device=x.device)
        mask = ar[None, :] <= ar[:, None]
    else:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
    out = _attend(q.reshape(B, S, KV, G, hd), k, v, mask, scale)
    return out.reshape(B, S, H * hd) @ p["wo"], {"k": k, "v": v}
