"""Grouped-query attention, the port of the GQA part of
``repro.models.attention``: ``gqa_init``, ``gqa_cache_init``, the
full-sequence path of ``gqa_apply`` (causal for the decoder,
bidirectional when asked) and its cached (decode) path without a window.

Heads are grouped as the reference groups them: q is viewed as
``(B, S, KV, G, hd)``, so q-head ``h = kv * G + g`` shares k/v head
``kv``. Scores are taken in the parameters' dtype and scaled in float32,
masked with ``-1e30``, softmaxed in float32 and cast back to the values'
dtype before the product with v, as ``repro.models.attention._attend``
does.

The cached path writes the new keys and values into the cache it is
given, in place, and returns that same dict: the reference returns new
arrays, but a copy of the whole cache per token is what a preallocated
PyTorch cache avoids. It mirrors ``jax.lax.dynamic_update_slice``: the
write starts at ``cache_pos`` clamped to ``[0, T - S]``, while RoPE and
the mask (``arange(T) <= cache_pos``) take ``cache_pos`` as given.

Not ported yet, and refused rather than computed another way: sequences
longer than ``FLASH_THRESHOLD`` (the reference's ``_attend_flash``),
sliding-window attention (with or without a cache), cross attention,
M-RoPE and MLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, dense_init, rope_angles

__all__ = ["FLASH_THRESHOLD", "gqa_apply", "gqa_cache_init", "gqa_init"]

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
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention of ``x`` (B,S,D): ``(out @ wo, cache)``. Without a cache,
    over the full sequence, and ``cache`` is ``{"k", "v"}`` of ``x``; with
    ``cache`` and ``cache_pos``, against the cache after writing ``x``'s
    keys and values into it, and ``cache`` is the dict given, updated."""
    if cross or kv_input is not None:
        raise NotImplementedError("cross attention is not ported yet")
    if window:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet")
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE is not ported yet")
    if (cache is None) != (cache_pos is None):
        raise NotImplementedError("attention with only one of cache and "
                                  "cache_pos is not ported")
    cached = cache is not None
    B, S, D = x.shape
    if S > FLASH_THRESHOLD and not cached:
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
    qg = q.reshape(B, S, KV, G, hd)
    if cached:
        # decode: write the S new slots, attend to every slot <= cache_pos
        T = cache["k"].shape[1]
        if S > T:
            raise ValueError(f"{S} tokens do not fit a cache of {T} slots")
        start = min(max(cache_pos, 0), T - S)
        ar = torch.arange(T, device=x.device)
        slots = ar[:S] + start
        cache["k"].index_copy_(1, slots, k)
        cache["v"].index_copy_(1, slots, v)
        out = _attend(qg, cache["k"], cache["v"], ar <= cache_pos, scale)
        return out.reshape(B, S, H * hd) @ p["wo"], cache
    if causal:
        ar = torch.arange(S, device=x.device)
        mask = ar[None, :] <= ar[:, None]
    else:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
    out = _attend(qg, k, v, mask, scale)
    return out.reshape(B, S, H * hd) @ p["wo"], {"k": k, "v": v}


def gqa_cache_init(cfg, batch: int, max_len: int, dtype, *,
                   device) -> Dict[str, torch.Tensor]:
    """Zero ``k`` and ``v`` of shape ``(batch, size, KV, hd)`` in ``dtype``
    and an int32 ``pos`` of shape ``(1, size)`` full of -1, where ``size``
    is ``max_len`` (or ``min(max_len, window)`` with a window)."""
    hd, KV = cfg.raw_head_dim, cfg.padded_kv_heads
    size = min(max_len, cfg.window) if cfg.window else max_len
    return {
        "k": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((1, size), -1, dtype=torch.int32, device=device),
    }
