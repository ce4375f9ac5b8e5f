"""The decoder, the port of ``repro.models.model``.

Parameters keep the reference's tree: ``embed``, ``final_norm``, ``head``
and ``decoder/seg<i>/b<j>/…``, each decoder leaf stacked over the
segment's layers on a leading axis (what the reference's ``vmap`` init
builds). A Python loop over that axis takes the place of ``lax.scan``;
``remat=True`` wraps each layer in ``torch.utils.checkpoint`` (non-
reentrant), as the reference wraps the scan body in ``jax.checkpoint``.

:class:`Model` holds the tree as ``nn.Parameter``s: the module name
``decoder.seg0.b0.attn.wq`` is the checkpoint key
``decoder/seg0/b0/attn/wq``. The functions take either that module or a
plain nested dict of tensors.

Decode caches keep the reference's tree too: ``seg<i>/b<j>/{k,v,pos}``,
each leaf stacked over the segment's layers (:func:`init_caches`).
``forward(caches=, cache_pos=)`` and :func:`decode_step` write each
layer's new keys and values into those tensors in place and return the
same tree (the reference returns new arrays).

Every block kind of the reference is ported: ``"attn"`` (GQA, with the
configuration's sliding window where it has one, or MLA), ``"attn_moe"``
(the same attention and the MoE block in place of the FFN), ``"rec"``
(the RG-LRU block), ``"ssd"`` (the Mamba-2 block, ``{norm1, ssd}`` with
no FFN), ``"enc"`` (bidirectional self-attention and the FFN) and
``"xattn"`` (causal self-attention, cross attention on the encoder's
output, the FFN; ``norm1``-``norm3``). So are all families: dense, MoE
(deepseek-v2's dense first layer and MoE layers are two segments; MLA
keeps the latent cache ``seg<i>/b<j>/{ckv, k_rope}``), the recurrentgemma
hybrid (several segments), the qwen2-vl language model with M-RoPE and
the ``vis_embeds`` stub, mamba2 (the SSD state ``seg<i>/b<j>/{h, conv}``)
and whisper's encoder-decoder. The recurrent states are updated in
place as the attention caches are. Whisper's parameters add
``encoder/seg<i>/b<j>/…`` and ``enc_norm``; ``forward`` runs
:func:`encode` when the batch has ``"frames"`` (the audio frontend's
stub: frame embeddings (B, S_enc, D)), and each ``xattn`` cache is
``{self: {k, v, pos}, cross: {k, v}}`` (:func:`init_caches` with
``enc_len``), the cross cache written by the first step that has frames.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (gqa_apply, gqa_cache_init,
                                          gqa_init, mla_apply, mla_cache_init,
                                          mla_init)
from repro_torch.models.config import ModelConfig, Segment
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    ffn_apply,
    ffn_init,
    rmsnorm,
    rmsnorm_init,
    softmax_xent,
    unembed_apply,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.rglru import rec_apply, rec_init, rec_state_init
from repro_torch.models.ssd import ssd_apply, ssd_init, ssd_state_init
from repro_torch.persistence.state import flatten_state

__all__ = ["Model", "ParamTree", "apply_block", "apply_segment",
           "block_cache_init", "decode_step", "encode", "forward",
           "init_block", "init_caches", "init_params", "init_segment",
           "lm_loss", "segment_cache_init"]

Params = Dict[str, Any]


# ========================================================================
# blocks and segments
# ========================================================================


def init_block(gen, kind: str, cfg: ModelConfig, dtype, *, device,
               lead=()) -> Params:
    """One block's parameters, each leaf with the leading shape ``lead``."""
    D = cfg.d_model
    kw = dict(device=device, lead=lead)
    attn_init = mla_init if cfg.attn_kind == "mla" else gqa_init
    if kind == "ssd":
        return {"norm1": rmsnorm_init(D, dtype, **kw),
                "ssd": ssd_init(gen, cfg, dtype=dtype, **kw)}
    if kind in ("attn", "attn_moe", "enc"):
        mixer = {"attn": attn_init(gen, cfg, dtype=dtype, **kw)}
    elif kind == "rec":
        mixer = {"rec": rec_init(gen, cfg, dtype=dtype, **kw)}
    elif kind == "xattn":
        mixer = {"attn": gqa_init(gen, cfg, dtype=dtype, **kw),
                 "norm2": rmsnorm_init(D, dtype, **kw),
                 "xatt": gqa_init(gen, cfg, dtype=dtype, **kw)}
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind == "attn_moe":
        ffn = {"moe": moe_init(gen, cfg, dtype=dtype, **kw)}
    else:
        ffn = {"ffn": ffn_init(gen, D, cfg.d_ff, dtype, cfg.ffn_kind, **kw)}
    last = "norm3" if kind == "xattn" else "norm2"
    return {"norm1": rmsnorm_init(D, dtype, **kw), **mixer,
            last: rmsnorm_init(D, dtype, **kw), **ffn}


def block_cache_init(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, enc_len: int = 0, *, device):
    """One block's decode cache: ``{k, v, pos}`` of GQA (a ring of
    ``min(max_len, window)`` slots with a window) or ``{ckv, k_rope}`` of
    MLA, ``{h, conv}`` of a recurrence (RG-LRU or SSD), or an ``xattn``
    block's ``{self: {k, v, pos}, cross: {k, v}}``, the cross cache
    ``(batch, enc_len, KV, hd)``. An encoder block has none (None)."""
    if kind in ("attn", "attn_moe"):
        if cfg.attn_kind == "mla":
            return mla_cache_init(cfg, batch, max_len, dtype, device=device)
        return gqa_cache_init(cfg, batch, max_len, dtype, device=device)
    if kind == "rec":
        return rec_state_init(cfg, batch, dtype, device=device)
    if kind == "ssd":
        return ssd_state_init(cfg, batch, dtype, device=device)
    if kind == "xattn":
        shape = (batch, enc_len, cfg.padded_kv_heads, cfg.raw_head_dim)
        return {"self": gqa_cache_init(cfg, batch, max_len, dtype,
                                       device=device),
                "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype,
                                           device=device)}}
    if kind == "enc":
        return None
    raise ValueError(f"unknown block kind {kind!r}")


def _add(x: torch.Tensor, a: torch.Tensor):
    """``x + a`` rounded to ``a``'s dtype, and the float32 sum a norm
    reads."""
    s = x.float() + a.float()
    return s.to(a.dtype), s


def _block(kind: str, p, x: torch.Tensor, x32: Optional[torch.Tensor], *,
           cfg: ModelConfig, positions: torch.Tensor, enc_out=None,
           cache=None, cache_pos=None, want32: bool = False):
    """:func:`apply_block`, given beside ``x`` the float32 sum it was
    rounded from (``x32``; None where there is none) and returning the
    block's own float32 output sum when ``want32`` (else None)."""
    eps = cfg.norm_eps
    h = rmsnorm(x if x32 is None else x32, p["norm1"], eps).to(x.dtype)
    tail = "norm2"
    if kind == "ssd":
        a, new_cache = ssd_apply(p["ssd"], h, cfg=cfg, state=cache)
        x, s = _add(x, a)
        return x, (s if want32 else None), new_cache
    if kind in ("attn", "attn_moe") and cfg.attn_kind == "mla":
        a, new_cache = mla_apply(p["attn"], h, cfg=cfg, positions=positions,
                                 cache=cache, cache_pos=cache_pos)
    elif kind in ("attn", "attn_moe", "enc"):
        enc = kind == "enc"
        a, new_cache = gqa_apply(p["attn"], h, cfg=cfg, positions=positions,
                                 causal=not enc, window=0 if enc else cfg.window,
                                 cache=cache, cache_pos=cache_pos)
    elif kind == "rec":
        a, new_cache = rec_apply(p["rec"], h, cfg=cfg, state=cache)
    elif kind == "xattn":
        sc, cc = (None, None) if cache is None else (cache["self"],
                                                     cache["cross"])
        a, new_self = gqa_apply(p["attn"], h, cfg=cfg, positions=positions,
                                causal=True, cache=sc, cache_pos=cache_pos)
        x, s = _add(x, a)
        h = rmsnorm(s, p["norm2"], eps).to(a.dtype)
        a, new_cross = gqa_apply(p["xatt"], h, cfg=cfg, positions=positions,
                                 cross=True, kv_input=enc_out, cache=cc)
        new_cache = {"self": new_self, "cross": new_cross}
        tail = "norm3"
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x, s = _add(x, a)
    h = rmsnorm(s, p[tail], eps).to(a.dtype)
    f = (moe_apply(p["moe"], h, cfg) if kind == "attn_moe"
         else ffn_apply(p["ffn"], h))
    if not want32:
        return x + f, None, new_cache
    out = x.float() + f.float()
    return out.to(a.dtype), out, new_cache


def apply_block(kind: str, p, x: torch.Tensor, *, cfg: ModelConfig,
                positions: torch.Tensor, enc_out=None, cache=None,
                cache_pos=None):
    """``(x after the block, its cache)``: without ``cache``, the full
    sequence's ``{"k", "v"}`` (GQA), ``{"ckv", "k_rope"}`` (MLA), final
    ``{"h", "conv"}`` (recurrence) or ``{"self", "cross"}`` (``xattn``,
    which attends to ``enc_out``), else ``cache`` updated in place.

    Each residual sum is rounded to the model's dtype, but a norm that
    reads one reads the float32 sum, as XLA's compiled reference does (its
    default excess precision drops the round trip through bf16): the
    block's second norm reads ``x + mixer``, and in a unit of several
    blocks (one layer of a segment) each later block's first norm reads
    the float32 output of the block before (:func:`_unit`). The first
    block of a unit reads the rounded carry."""
    x, _, new_cache = _block(kind, p, x, None, cfg=cfg, positions=positions,
                             enc_out=enc_out, cache=cache,
                             cache_pos=cache_pos)
    return x, new_cache


def init_segment(gen, seg: Segment, cfg: ModelConfig, dtype, *,
                 device) -> Params:
    """The segment's blocks, every leaf stacked over ``seg.repeat``."""
    return {f"b{i}": init_block(gen, kind, cfg, dtype, device=device,
                                lead=(seg.repeat,))
            for i, kind in enumerate(seg.pattern)}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree, as a nested dict of views."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(tree[k], i) for k in tree.keys()}


def _stack(tree, n: int):
    """Every leaf of ``tree`` repeated ``n`` times on a new leading axis."""
    if isinstance(tree, torch.Tensor):
        return tree[None].repeat((n,) + (1,) * tree.dim())
    return {k: _stack(v, n) for k, v in tree.items()}


def segment_cache_init(seg: Segment, cfg: ModelConfig, batch: int,
                       max_len: int, dtype, enc_len: int = 0, *, device):
    """The segment's block caches, every leaf stacked over ``seg.repeat``
    on a leading axis."""
    return {f"b{i}": _stack(block_cache_init(kind, cfg, batch, max_len,
                                             dtype, enc_len, device=device),
                            seg.repeat)
            for i, kind in enumerate(seg.pattern)}


def _unit(seg: Segment, lp, x, *, cfg, positions, enc_out=None, lc=None,
          cache_pos=None):
    x32 = None
    for i, kind in enumerate(seg.pattern):
        c = None if lc is None else lc[f"b{i}"]
        x, x32, _ = _block(kind, lp[f"b{i}"], x, x32, cfg=cfg,
                           positions=positions, enc_out=enc_out, cache=c,
                           cache_pos=cache_pos,
                           want32=i < len(seg.pattern) - 1)
    return x


def apply_segment(seg: Segment, p, x: torch.Tensor, *, cfg, positions,
                  enc_out=None, caches=None, cache_pos=None,
                  remat: bool = False):
    """``(x after the segment, caches)``: ``caches`` (the segment's, updated
    in place through per-layer views) or None. ``remat`` recomputes each
    layer in the backward pass; decode takes no gradients, so it applies
    without caches only. ``enc_out`` is what ``xattn`` blocks attend to."""
    for layer in range(seg.repeat):
        lc = None if caches is None else _layer(caches, layer)
        body = functools.partial(_unit, seg, _layer(p, layer), cfg=cfg,
                                 positions=positions, enc_out=enc_out, lc=lc,
                                 cache_pos=cache_pos)
        if remat and caches is None:
            x = checkpoint(body, x, use_reentrant=False)
        else:
            x = body(x)
    return x, caches


# ========================================================================
# model
# ========================================================================


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Params:
    """The reference's parameter tree (same keys, shapes and dtypes), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``. The
    values are not the reference's: ``jax.random`` cannot be replayed.
    On the ``meta`` device nothing is drawn. An encoder-decoder adds
    ``encoder/seg<i>/…`` and ``enc_norm``."""
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(int(seed)))
    dtype = getattr(torch, cfg.dtype)
    params: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            device=device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                    device=device)
    params["decoder"] = {
        f"seg{i}": init_segment(gen, seg, cfg, dtype, device=device)
        for i, seg in enumerate(cfg.segments)
    }
    if cfg.encoder_segments:
        params["encoder"] = {
            f"seg{i}": init_segment(gen, seg, cfg, dtype, device=device)
            for i, seg in enumerate(cfg.encoder_segments)
        }
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, device=device)
    return params


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """The whisper-style encoder over the stub's frame embeddings (B,
    S_enc, D), in the model's dtype: the ``enc`` segments (bidirectional,
    RoPE at ``arange(S_enc)``), then ``enc_norm``."""
    x = frames
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    for i, seg in enumerate(cfg.encoder_segments):
        x, _ = apply_segment(seg, params["encoder"][f"seg{i}"], x, cfg=cfg,
                             positions=pos, remat=remat)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], *,
            caches=None, cache_pos=None,
            remat: bool = False) -> Tuple[torch.Tensor, Optional[Params]]:
    """``(logits (B, S, padded vocab), caches)``. Without caches, over the
    full sequence, and ``caches`` is None. With ``caches`` (from
    :func:`init_caches`) and ``cache_pos`` (an int, read once on the host),
    every token takes the rotary position ``cache_pos`` (on all three
    M-RoPE rows), each layer writes its keys and values or its recurrent
    state into ``caches`` in place and attends to the valid slots, and the
    updated ``caches`` are returned.

    ``batch["vis_embeds"]`` (B, S_vis, D), where given, takes the place of
    the first ``S_vis`` token embeddings (the vision frontend's stub);
    ``batch["positions"]``, (B, S) or (3, B, S) under M-RoPE, replaces
    ``arange(S)`` when there is no ``cache_pos``. ``batch["frames"]`` (B,
    S_enc, D), where given, runs :func:`encode`, and the ``xattn`` blocks
    attend to its output (and write it into their cross caches); without
    it they attend to the cross caches."""
    if (caches is None) != (cache_pos is None):
        raise NotImplementedError("forward with only one of caches and "
                                  "cache_pos is not ported")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_apply(params["embed"], tokens)
    if "vis_embeds" in batch:
        ve = batch["vis_embeds"].to(x.dtype)
        if ve.shape[1] > S:
            raise ValueError(f"{ve.shape[1]} patch embeddings do not fit "
                             f"{S} positions")
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    enc_out = None
    if "frames" in batch:
        enc_out = encode(params, cfg, batch["frames"].to(x.dtype),
                         remat=remat)
    lead = (3, B, S) if cfg.mrope_sections else (B, S)
    if cache_pos is not None:
        cache_pos = int(cache_pos)
        positions = torch.full(lead, cache_pos, dtype=torch.int32,
                               device=tokens.device)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(lead)
    for i, seg in enumerate(cfg.segments):
        c = None if caches is None else caches[f"seg{i}"]
        x, _ = apply_segment(seg, params["decoder"][f"seg{i}"], x, cfg=cfg,
                             positions=positions, enc_out=enc_out, caches=c,
                             cache_pos=cache_pos, remat=remat)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed_apply(head, x), caches


def lm_loss(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], *,
            remat: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the labels that are >= 0."""
    logits, _ = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    loss = softmax_xent(logits, torch.clamp(labels, min=0), labels >= 0)
    return loss, {"loss": loss}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
                *, device) -> Params:
    """Empty decode caches for ``batch`` sequences of up to ``max_len``
    tokens, in the model's dtype on ``device``: ``seg<i>/b<j>/{k, v, pos}``
    and the other kinds' caches as the reference builds them; an
    ``xattn`` block's cross cache holds ``enc_len`` encoder positions."""
    dtype = getattr(torch, cfg.dtype)
    return {f"seg{i}": segment_cache_init(seg, cfg, batch, max_len, dtype,
                                          enc_len, device=device)
            for i, seg in enumerate(cfg.segments)}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches,
                cache_pos, extras: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One serving step: tokens (B, 1) and ``caches`` at ``cache_pos`` →
    ``(logits (B, 1, padded vocab), caches)``, the caches updated in
    place."""
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    return forward(params, cfg, batch, caches=caches, cache_pos=cache_pos)


# ========================================================================
# the parameter tree as a module
# ========================================================================


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: each dict key is an
    attribute (a submodule for a dict, an ``nn.Parameter`` for a tensor),
    so the module name ``a.b.c`` is the key path ``a/b/c``. Indexes like
    the dict it was made from. The parameters share the tensors' storage."""

    def __init__(self, tree: Mapping[str, Any]) -> None:
        super().__init__()
        self._names = sorted(tree.keys())
        for k in self._names:
            v = tree[k]
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v.detach(),
                                    requires_grad=v.is_floating_point()))
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, k: str):
        if k not in self._names:
            raise KeyError(k)
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._names

    def keys(self):
        return list(self._names)

    def flat(self) -> Dict[str, nn.Parameter]:
        """``{"a/b/c": parameter}`` in the JAX package's leaf order."""
        return flatten_state(self)


class Model(ParamTree):
    """The model's parameters as ``nn.Parameter``s; ``model(batch)``
    returns the logits."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]) -> None:
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                remat: bool = False) -> torch.Tensor:
        return forward(self, self.cfg, batch, remat=remat)[0]
