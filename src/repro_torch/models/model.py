"""The dense decoder, the port of ``repro.models.model``.

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

Only ``"attn"`` blocks with GQA are ported (the dense family); other
block kinds, MLA, windows, M-RoPE, encoders and frontends raise
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import gqa_apply, gqa_cache_init, gqa_init
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
from repro_torch.persistence.state import flatten_state

__all__ = ["Model", "ParamTree", "apply_block", "apply_segment",
           "block_cache_init", "decode_step", "forward", "init_block",
           "init_caches", "init_params", "init_segment", "lm_loss",
           "segment_cache_init"]

Params = Dict[str, Any]


def _check_supported(cfg: ModelConfig) -> None:
    why = None
    if cfg.family != "dense":
        why = f"the {cfg.family} family"
    elif cfg.attn_kind != "gqa":
        why = f"{cfg.attn_kind} attention"
    elif cfg.window:
        why = "sliding-window attention"
    elif cfg.mrope_sections:
        why = "M-RoPE"
    elif cfg.encoder_layers or cfg.frontend != "none":
        why = "encoders and frontends"
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why} is not ported to "
                                  f"repro_torch yet")


# ========================================================================
# blocks and segments
# ========================================================================


def init_block(gen, kind: str, cfg: ModelConfig, dtype, *, device,
               lead=()) -> Params:
    """One block's parameters, each leaf with the leading shape ``lead``."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    D = cfg.d_model
    kw = dict(device=device, lead=lead)
    return {"norm1": rmsnorm_init(D, dtype, **kw),
            "attn": gqa_init(gen, cfg, dtype=dtype, **kw),
            "norm2": rmsnorm_init(D, dtype, **kw),
            "ffn": ffn_init(gen, D, cfg.d_ff, dtype, cfg.ffn_kind, **kw)}


def block_cache_init(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, enc_len: int = 0, *, device):
    """One block's decode cache (``enc_len`` is for cross attention, which
    is not ported)."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return gqa_cache_init(cfg, batch, max_len, dtype, device=device)


def apply_block(kind: str, p, x: torch.Tensor, *, cfg: ModelConfig,
                positions: torch.Tensor, cache=None, cache_pos=None):
    """``(x after the block, its cache)``: the full sequence's
    ``{"k", "v"}`` without ``cache``, else ``cache`` updated in place."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    eps = cfg.norm_eps
    a, new_cache = gqa_apply(p["attn"], rmsnorm(x, p["norm1"], eps), cfg=cfg,
                             positions=positions, causal=True, cache=cache,
                             cache_pos=cache_pos)
    # XLA keeps the sum in float32 for the second norm (its default excess
    # precision drops the round trip through bf16) and rounds it for the
    # residual; the port does the same
    s = x.float() + a.float()
    x = s.to(a.dtype)
    h = rmsnorm(s, p["norm2"], eps).to(a.dtype)
    return x + ffn_apply(p["ffn"], h), new_cache


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


def segment_cache_init(seg: Segment, cfg: ModelConfig, batch: int,
                       max_len: int, dtype, enc_len: int = 0, *, device):
    """The segment's block caches, every leaf stacked over ``seg.repeat``
    on a leading axis."""
    return {f"b{i}": {k: v[None].repeat((seg.repeat,) + (1,) * v.dim())
                      for k, v in block_cache_init(
                          kind, cfg, batch, max_len, dtype, enc_len,
                          device=device).items()}
            for i, kind in enumerate(seg.pattern)}


def _unit(seg: Segment, lp, x, *, cfg, positions, lc=None, cache_pos=None):
    for i, kind in enumerate(seg.pattern):
        c = None if lc is None else lc[f"b{i}"]
        x, _ = apply_block(kind, lp[f"b{i}"], x, cfg=cfg, positions=positions,
                           cache=c, cache_pos=cache_pos)
    return x


def apply_segment(seg: Segment, p, x: torch.Tensor, *, cfg, positions,
                  caches=None, cache_pos=None, remat: bool = False):
    """``(x after the segment, caches)``: ``caches`` (the segment's, updated
    in place through per-layer views) or None. ``remat`` recomputes each
    layer in the backward pass; decode takes no gradients, so it applies
    without caches only."""
    for layer in range(seg.repeat):
        lc = None if caches is None else _layer(caches, layer)
        body = functools.partial(_unit, seg, _layer(p, layer), cfg=cfg,
                                 positions=positions, lc=lc,
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
    On the ``meta`` device nothing is drawn."""
    _check_supported(cfg)
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
    return params


def forward(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], *,
            caches=None, cache_pos=None,
            remat: bool = False) -> Tuple[torch.Tensor, Optional[Params]]:
    """``(logits (B, S, padded vocab), caches)``. Without caches, over the
    full sequence, and ``caches`` is None. With ``caches`` (from
    :func:`init_caches`) and ``cache_pos`` (an int, read once on the host),
    every token takes the rotary position ``cache_pos``, each layer writes
    its keys and values into ``caches`` in place and attends to the slots
    up to ``cache_pos``, and the updated ``caches`` are returned."""
    _check_supported(cfg)
    if (caches is None) != (cache_pos is None):
        raise NotImplementedError("forward with only one of caches and "
                                  "cache_pos is not ported")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_apply(params["embed"], tokens)
    if cache_pos is not None:
        cache_pos = int(cache_pos)
        positions = torch.full((B, S), cache_pos, dtype=torch.int32,
                               device=tokens.device)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device)[None].expand(B, S)
    for i, seg in enumerate(cfg.segments):
        c = None if caches is None else caches[f"seg{i}"]
        x, _ = apply_segment(seg, params["decoder"][f"seg{i}"], x, cfg=cfg,
                             positions=positions, caches=c,
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
    as the reference builds them."""
    _check_supported(cfg)
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
    """The decoder's parameters as ``nn.Parameter``s; ``model(batch)``
    returns the logits."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]) -> None:
        _check_supported(cfg)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                remat: bool = False) -> torch.Tensor:
        return forward(self, self.cfg, batch, remat=remat)[0]
