"""The train, prefill and serve steps, the port of
``repro.launch.steps``.

The steps are eager PyTorch. In the train step autograd gives the
gradients of ``lm_loss``, and AdamW updates the parameters and the
optimizer state in place. The prefill and serve steps run under
``torch.inference_mode()``, so no decode step builds a graph; the serve
step writes into the caches it is given. The sharded wrappers of the
reference (``shard_*``) belong to the distributed slice and are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.models import decode_step, forward, lm_loss
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.persistence.state import flatten_state, unflatten_state

__all__ = ["build_prefill_step", "build_serve_step", "build_train_step"]


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                     *, remat: bool = True, total_steps: int = 10_000):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients at the current parameters,
    then an AdamW step at ``warmup_cosine(count)`` that overwrites
    ``params`` (a :class:`~repro_torch.models.Model` or a nested dict of
    tensors) and ``opt_state`` in place. ``metrics`` holds ``loss``,
    ``grad_norm``, ``clip_scale`` and ``lr_scale`` as 0-d tensors."""

    def train_step(params, opt_state: Dict[str, Any],
                   batch: Mapping[str, torch.Tensor]
                   ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
        # differentiate through detached aliases of the leaves, so a plain
        # dict of tensors trains as a Model's parameters do
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in flatten_state(params).items()}
        with torch.enable_grad():
            loss, metrics = lm_loss(unflatten_state(leaves), cfg, batch,
                                    remat=remat)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = unflatten_state(dict(zip(leaves, grads)))
        lr_scale = warmup_cosine(opt_state["count"], total=total_steps)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, opt_cfg, lr_scale)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics, lr_scale=lr_scale)
        return params, opt_state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> logits (B, padded vocab)`` of the
    last position of a full-sequence forward."""

    @torch.inference_mode()
    def prefill_step(params, batch: Mapping[str, torch.Tensor]
                     ) -> torch.Tensor:
        logits, _ = forward(params, cfg, batch)
        return logits[:, -1]

    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """``serve_step(params, tokens (B, 1), caches, cache_pos) -> (logits
    (B, padded vocab), caches)``: one decode step, the caches updated in
    place and returned."""

    @torch.inference_mode()
    def serve_step(params, tokens: torch.Tensor, caches, cache_pos
                   ) -> Tuple[torch.Tensor, Any]:
        logits, caches = decode_step(params, cfg, tokens, caches, cache_pos)
        return logits[:, 0], caches

    return serve_step
