"""AdamW with global-norm clipping, the port of ``repro.optim.adamw``.

Written out by hand because ``torch.optim.AdamW`` does its arithmetic in
the parameters' dtype: here, as in the reference, the moments are
float32, the update is computed in float32 and cast back to the
parameters' dtype (bf16) once, the bias correction ``b ** count`` is a
float32 power, and weight decay applies to every leaf.

Where the reference returns new arrays, :func:`adamw_update` writes the
new parameters, moments and count into the tensors it was given (saving
a copy of the state per step) and returns those same objects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.persistence.state import flatten_state, unflatten_state

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> Dict[str, Any]:
    """Zero float32 moments shaped like ``params`` and a 0-d int32
    ``count``, on the parameters' device."""
    flat = flatten_state(params)
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in flat.items()}
    device = next(iter(flat.values())).device
    return {
        "m": unflatten_state(zeros),
        "v": unflatten_state({k: torch.zeros_like(z)
                              for k, z in zeros.items()}),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = [torch.sum(torch.square(g.float()))
              for g in flatten_state(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads, opt_state: Dict[str, Any], params, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, in place: ``params``' leaves, the moments and
    ``count`` are overwritten and returned, with the metrics
    ``grad_norm`` and ``clip_scale``."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.clip_norm / (gnorm + 1e-9))
    b1, b2 = (torch.tensor(b, dtype=torch.float32, device=count.device)
              for b in (cfg.b1, cfg.b2))
    c = count.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
    flat_g = flatten_state(grads)
    flat_m = flatten_state(opt_state["m"])
    flat_v = flatten_state(opt_state["v"])
    flat_p = flatten_state(params)
    if not set(flat_g) == set(flat_m) == set(flat_v) == set(flat_p):
        raise ValueError("grads, moments and params have different leaves")
    for k, g in flat_g.items():
        m, v, p = flat_m[k], flat_v[k], flat_p[k]
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p2 = p.float() - cfg.lr * lr_scale * step
        p.copy_(p2.to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    opt_state["count"].copy_(count)
    return params, opt_state, {"grad_norm": gnorm, "clip_scale": scale}
