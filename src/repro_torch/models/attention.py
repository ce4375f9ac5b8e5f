"""Grouped-query attention, the port of the GQA part of
``repro.models.attention``: ``gqa_init``, ``gqa_cache_init`` and
``gqa_apply``'s self-attention, full-sequence and cached, and its cross
attention.

Heads are grouped as the reference groups them: q is viewed as
``(B, S, KV, G, hd)``, so q-head ``h = kv * G + g`` shares k/v head
``kv``. Scores are taken in the parameters' dtype and scaled in float32,
masked with ``-1e30``, softmaxed in float32 and cast back to the values'
dtype before the product with v, as ``repro.models.attention._attend``
does. Rotary positions are ``(B, S)``, or ``(3, B, S)`` under M-RoPE.

The full sequence takes the reference's routes, by its conditions:

- with a window, ``S > window`` and ``S % window == 0``: the chunked band
  (each window-sized query chunk against itself and the chunk before it,
  the first chunk's "previous" keys zeros and masked; O(S·2w) scores);
- without a window and ``S > FLASH_THRESHOLD``: :func:`_attend_flash`, an
  online softmax in float32 over 1024-key chunks (a loop over the chunks;
  the reference's is jnp, not Pallas);
- otherwise the masked dense path, causal (``kpos <= qpos``, and
  ``qpos - kpos < window`` with a window) or bidirectional.

The cached path writes the new keys and values into the cache it is
given, in place, and returns that same dict: the reference returns new
arrays, but a copy of the whole cache per token is what a preallocated
PyTorch cache avoids. It mirrors ``jax.lax.dynamic_update_slice``: the
write starts at the slot (``cache_pos``, or ``cache_pos mod T`` in a
window's ring buffer) clamped to ``[0, T - S]``. Without a window, RoPE
and the mask (``arange(T) <= cache_pos``) take ``cache_pos`` as given.
With one, the ring's ``pos`` leaf records, in place, the position written
to the slot, and a slot is valid when ``0 <= cache_pos - pos < window``
and ``pos >= 0``.

MLA (DeepSeek-V2 multi-head latent attention; ``mla_init``,
``mla_apply``, ``mla_cache_init``) keeps the reference's two forms. The
full sequence materialises per-head keys ``[k_nope, k_rope]`` (the rope
key one shared head, broadcast over H) and values from the latent
``ckv`` and attends with the masked path, or above ``FLASH_THRESHOLD``
with :func:`_attend_flash` (KV = H, G = 1; the query and key width
``nope + rope`` differs from the value width); it returns the new
tokens' ``{"ckv", "k_rope"}``. Decode is absorbed: the queries are
projected into the latent space and attend to the compressed cache
``(ckv, k_rope)`` itself, written in place at ``cache_pos`` with the
start clamped as above. Its two score products are each rounded to the
model dtype and summed in float32, where XLA's excess precision keeps
their sum.

Cross attention (``cross=True``, whisper's ``xattn`` blocks) takes its
keys and values from ``kv_input @ wk/wv`` (the encoder's output) where it
is given, else from the cross cache; no RoPE and no mask, through
:func:`_attend_flash` (not causal) when ``max(S, T) > FLASH_THRESHOLD``,
else the dense path. It returns ``{"k", "v"}``: with a cross cache and
``kv_input`` both given (serving's first step), the new keys and values
are written into the cache's tensors in place and that dict is returned.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (apply_rope, dense_init, mrope_angles,
                                       rmsnorm, rmsnorm_init, rope_angles)

__all__ = ["FLASH_THRESHOLD", "gqa_apply", "gqa_cache_init", "gqa_init",
           "mla_apply", "mla_cache_init", "mla_init"]

#: without a window, full sequences longer than this take the chunked
#: online softmax (:func:`_attend_flash`) instead of (S, S) scores; read
#: at each call, so a test can lower it
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


def _rope_for(cfg, positions: torch.Tensor, hd: int):
    if cfg.mrope_sections:
        return mrope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_angles(positions, hd, cfg.rope_theta)


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


def _attend_flash(q, k, v, *, causal: bool, scale: float,
                  k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over key chunks, in float32: q
    (B,S,KV,G,hd), k (B,T,KV,hd), v (B,T,KV,hv) → (B,S,KV,G,hv) in v's
    dtype. A loop over ``T / k_chunk`` chunks (one chunk of T when
    ``k_chunk`` does not divide it); each keeps a running maximum, sum and
    weighted value, rescaled when the maximum moves, so the scores held at
    once are (S, k_chunk) a head."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    hv = v.shape[-1]
    k_chunk = min(k_chunk, T)
    if T % k_chunk != 0:
        k_chunk = T
    qf = q.float().permute(0, 2, 3, 1, 4)           # B,KV,G,S,hd
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, KV, G, S), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, hv), dtype=torch.float32, device=q.device)
    for start in range(0, T, k_chunk):
        stop = start + k_chunk
        kc = k[:, start:stop].float().permute(0, 2, 3, 1)[:, :, None]
        vc = v[:, start:stop].float().permute(0, 2, 1, 3)[:, :, None]
        s = torch.matmul(qf, kc) * scale            # B,KV,G,S,k_chunk
        if causal:
            kpos = start + torch.arange(k_chunk, device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vc)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


def _attend_band(q, k, v, window: int, scale: float) -> torch.Tensor:
    """The chunked band of a sliding window (``S % window == 0``): q
    (B,S,KV,G,hd), k (B,S,KV,hd), v (B,S,KV,hv) → (B,S,KV,G,hv). Each of
    the ``S / window`` query chunks attends to its own chunk and the one
    before (zeros for the first, masked)."""
    B, S, KV, G, hd = q.shape
    nc = S // window
    kc = k.reshape(B, nc, window, KV, hd)
    vc = v.reshape(B, nc, window, KV, v.shape[-1])
    kk = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1),
                    kc], dim=2)                     # B,nc,2w,KV,hd
    vv = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1),
                    vc], dim=2)
    qh = q.reshape(B, nc, window, KV, G, hd).permute(0, 1, 3, 4, 2, 5)
    kh = kk.permute(0, 1, 3, 4, 2)[:, :, :, None]   # B,nc,KV,1,hd,2w
    scores = torch.matmul(qh, kh).float() * scale   # B,nc,KV,G,w,2w
    qpos = torch.arange(window, device=q.device)[:, None]
    kpos = torch.arange(2 * window, device=q.device)[None, :] - window
    band = (kpos <= qpos) & (qpos - kpos < window)
    first = torch.arange(nc, device=q.device)[:, None, None] == 0
    mask = torch.where(first, band & (kpos >= 0), band)      # nc,w,2w
    scores = torch.where(mask[None, :, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    vh = vv.permute(0, 1, 3, 2, 4)[:, :, :, None]   # B,nc,KV,1,2w,hv
    out = torch.matmul(probs, vh)                   # B,nc,KV,G,w,hv
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, KV, G, -1)


def _write_cache(cache: Dict[str, torch.Tensor],
                 new: Dict[str, torch.Tensor], slot: int) -> None:
    """Write each ``new[name]`` (B, S, ...) into ``cache[name]`` (B, T,
    ...) in place at ``slot``, the start clamped to ``[0, T - S]`` as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    for name, t in new.items():
        T, S = cache[name].shape[1], t.shape[1]
        if S > T:
            raise ValueError(f"{S} tokens do not fit a cache of {T} slots")
        start = min(max(slot, 0), T - S)
        cache[name].index_copy_(
            1, torch.arange(start, start + S, device=t.device), t)


def gqa_apply(
    p,
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,             # (B,S), or (3,B,S) for M-RoPE
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
    keys and values into it, and ``cache`` is the dict given, updated.
    ``cross=True`` is cross attention (the module's docstring), which
    takes no ``cache_pos``."""
    if cross:
        return _cross_attend(p, x, cfg=cfg, kv_input=kv_input, cache=cache)
    if (cache is None) != (cache_pos is None):
        raise NotImplementedError("attention with only one of cache and "
                                  "cache_pos is not ported")
    B, S, D = x.shape
    hd = cfg.raw_head_dim
    H, KV = cfg.padded_heads, cfg.padded_kv_heads
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    cos, sin = _rope_for(cfg, positions, hd)
    q = apply_rope(_split_heads(x @ p["wq"], H), cos, sin)
    k = apply_rope(_split_heads(x @ p["wk"], KV), cos, sin)
    v = _split_heads(x @ p["wv"], KV)
    qg = q.reshape(B, S, KV, G, hd)
    if cache is not None:
        # decode: write the S new slots, attend to the valid ones
        T = cache["k"].shape[1]
        slot = cache_pos % T if window else cache_pos
        ar = torch.arange(T, device=x.device)
        _write_cache(cache, {"k": k, "v": v}, slot)
        if window:
            cache["pos"][:, slot] = cache_pos
            age = cache_pos - cache["pos"]
            valid = (age >= 0) & (age < window) & (cache["pos"] >= 0)
        else:
            valid = ar <= cache_pos
        out = _attend(qg, cache["k"], cache["v"], valid, scale)
        return out.reshape(B, S, H * hd) @ p["wo"], cache
    if window and S > window and S % window == 0:
        out = _attend_band(qg, k, v, window, scale)
    elif not window and S > FLASH_THRESHOLD:
        out = _attend_flash(qg, k, v, causal=causal, scale=scale)
    else:
        ar = torch.arange(S, device=x.device)
        if causal:
            mask = ar[None, :] <= ar[:, None]
            if window:
                mask &= (ar[:, None] - ar[None, :]) < window
        else:
            mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
        out = _attend(qg, k, v, mask, scale)
    return out.reshape(B, S, H * hd) @ p["wo"], {"k": k, "v": v}


def _cross_attend(p, x: torch.Tensor, *, cfg,
                  kv_input: Optional[torch.Tensor],
                  cache: Optional[Dict[str, torch.Tensor]]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross attention of ``x`` (B,S,D) to ``kv_input`` (B,T,D) or, without
    it, to ``cache``'s ``{"k", "v"}`` (B,T,KV,hd): ``(out @ wo, {"k",
    "v"})``, the cache's own dict (written in place) where one is given."""
    B, S, D = x.shape
    hd = cfg.raw_head_dim
    H, KV = cfg.padded_heads, cfg.padded_kv_heads
    scale = 1.0 / math.sqrt(hd)
    qg = _split_heads(x @ p["wq"], H).reshape(B, S, KV, H // KV, hd)
    if kv_input is not None:
        k = _split_heads(kv_input @ p["wk"], KV)
        v = _split_heads(kv_input @ p["wv"], KV)
        if cache is not None:
            if cache["k"].shape != k.shape:
                raise ValueError(f"keys of {tuple(k.shape)} do not fit the "
                                 f"cross cache's {tuple(cache['k'].shape)}")
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    elif cache is not None:
        k, v = cache["k"], cache["v"]
    else:
        raise ValueError("cross attention takes kv_input or a cross cache")
    T = k.shape[1]
    if max(S, T) > FLASH_THRESHOLD:
        out = _attend_flash(qg, k, v, causal=False, scale=scale)
    else:
        out = _attend(qg, k, v, torch.ones((S, T), dtype=torch.bool,
                                           device=x.device), scale)
    return (out.reshape(B, S, H * hd) @ p["wo"],
            cache if cache is not None else {"k": k, "v": v})


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


# =========================================================================
# MLA (DeepSeek-V2)
# =========================================================================


def mla_init(gen, cfg, *, dtype, device, lead=()) -> Dict[str, torch.Tensor]:
    """``wkv_a`` (D → kv_lora + rope), ``kv_norm``, ``wkv_b`` (kv_lora →
    H·(nope + v)), ``wo``, and either the q-LoRA ``wq_a``, ``q_norm``,
    ``wq_b`` (with ``q_lora_rank``) or a plain ``wq``."""
    D = cfg.d_model
    H = cfg.padded_heads
    nope, rope, hv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lq, lkv = cfg.q_lora_rank, cfg.kv_lora_rank
    kw = dict(device=device, lead=lead)
    p = {
        "wkv_a": dense_init(gen, D, lkv + rope, dtype, **kw),
        "kv_norm": rmsnorm_init(lkv, dtype, **kw),
        "wkv_b": dense_init(gen, lkv, H * (nope + hv), dtype, **kw),
        "wo": dense_init(gen, H * hv, D, dtype, scale=1.0 / math.sqrt(H * hv),
                         **kw),
    }
    if lq:
        p["wq_a"] = dense_init(gen, D, lq, dtype, **kw)
        p["q_norm"] = rmsnorm_init(lq, dtype, **kw)
        p["wq_b"] = dense_init(gen, lq, H * (nope + rope), dtype, **kw)
    else:
        p["wq"] = dense_init(gen, D, H * (nope + rope), dtype, **kw)
    return p


def _mla_q(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The queries (B, S, H, nope + rope), through the q-LoRA where the
    parameters have it."""
    if "wq_a" in p:
        q = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    b, s, _ = q.shape
    return q.reshape(b, s, cfg.padded_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_apply(
    p,
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,             # (B, S)
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Latent attention of ``x`` (B,S,D): ``(out @ wo, cache)``. Without a
    cache, over the full sequence (materialised), and ``cache`` is the new
    tokens' ``{"ckv", "k_rope"}``; with ``cache`` and ``cache_pos``,
    absorbed against the cache after writing them into it, and ``cache``
    is the dict given, updated."""
    if (cache is None) != (cache_pos is None):
        raise NotImplementedError("attention with only one of cache and "
                                  "cache_pos is not ported")
    B, S, D = x.shape
    H = cfg.padded_heads
    nope, rope_d, hv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lkv = cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope_d)

    q = _mla_q(p, x, cfg)
    cos, sin = rope_angles(positions, rope_d, cfg.rope_theta)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], cos, sin)

    kv_a = x @ p["wkv_a"]
    ckv_new = rmsnorm(kv_a[..., :lkv], p["kv_norm"], cfg.norm_eps)
    k_rope_new = apply_rope(kv_a[..., None, lkv:], cos, sin)[:, :, 0]

    wkv_b = p["wkv_b"].reshape(lkv, H, nope + hv)

    if cache is not None:
        # absorbed decode: attend in the latent space
        _write_cache(cache, {"ckv": ckv_new, "k_rope": k_rope_new}, cache_pos)
        ckv, k_r = cache["ckv"], cache["k_rope"]
        T = ckv.shape[1]
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, wkv_b[..., :nope])
        scores = (torch.einsum("bshl,btl->bhst", q_lat, ckv).float()
                  + torch.einsum("bshr,btr->bhst", q_rope, k_r).float()) * scale
        valid = torch.arange(T, device=x.device) <= cache_pos
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        lat = torch.einsum("bhst,btl->bshl", probs, ckv)
        out = torch.einsum("bshl,lhv->bshv", lat, wkv_b[..., nope:])
        return out.reshape(B, S, H * hv) @ p["wo"], cache

    # train / prefill: per-head keys and values from the latent
    kv = torch.einsum("btl,lhx->bthx", ckv_new, wkv_b)   # (B,S,H,nope+hv)
    k = torch.cat([kv[..., :nope],
                   k_rope_new[:, :, None, :].expand(B, S, H, rope_d)], dim=-1)
    v = kv[..., nope:]
    qq = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, H, 1,
                                                     nope + rope_d)
    if S > FLASH_THRESHOLD:
        out = _attend_flash(qq, k, v, causal=True, scale=scale)
    else:
        ar = torch.arange(S, device=x.device)
        out = _attend(qq, k, v, ar[None, :] <= ar[:, None], scale)
    return (out.reshape(B, S, H * hv) @ p["wo"],
            {"ckv": ckv_new, "k_rope": k_rope_new})


def mla_cache_init(cfg, batch: int, max_len: int, dtype, *,
                   device) -> Dict[str, torch.Tensor]:
    """Zero ``ckv`` (batch, max_len, kv_lora) and ``k_rope`` (batch,
    max_len, rope) in ``dtype``: the latent cache, no per-head storage."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }
