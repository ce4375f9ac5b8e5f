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

Only ``"attn"`` blocks with GQA are ported (the dense family); other
block kinds, MLA, windows, M-RoPE, encoders and frontends raise
``NotImplementedError``, and so do decode caches.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import gqa_apply, gqa_init
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

__all__ = ["Model", "ParamTree", "apply_block", "forward", "init_block",
           "init_params", "init_segment", "lm_loss"]

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


def apply_block(kind: str, p, x: torch.Tensor, *, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    eps = cfg.norm_eps
    a, _ = gqa_apply(p["attn"], rmsnorm(x, p["norm1"], eps), cfg=cfg,
                     positions=positions, causal=True)
    x = x + a
    return x + ffn_apply(p["ffn"], rmsnorm(x, p["norm2"], eps))


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


def _unit(seg: Segment, lp, x, *, cfg, positions):
    for i, kind in enumerate(seg.pattern):
        x = apply_block(kind, lp[f"b{i}"], x, cfg=cfg, positions=positions)
    return x


def apply_segment(seg: Segment, p, x: torch.Tensor, *, cfg, positions,
                  remat: bool = False) -> torch.Tensor:
    for layer in range(seg.repeat):
        body = functools.partial(_unit, seg, _layer(p, layer), cfg=cfg,
                                 positions=positions)
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return x


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
            remat: bool = False) -> Tuple[torch.Tensor, None]:
    """``(logits (B, S, padded vocab), None)`` over the full sequence."""
    _check_supported(cfg)
    if caches is not None or cache_pos is not None:
        raise NotImplementedError("decode caches are not ported yet")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_apply(params["embed"], tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    for i, seg in enumerate(cfg.segments):
        x = apply_segment(seg, params["decoder"][f"seg{i}"], x, cfg=cfg,
                          positions=positions, remat=remat)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed_apply(head, x), None


def lm_loss(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], *,
            remat: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the labels that are >= 0."""
    logits, _ = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    loss = softmax_xent(logits, torch.clamp(labels, min=0), labels >= 0)
    return loss, {"loss": loss}


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
