"""The Griffin/RecurrentGemma recurrent block (temporal conv + RG-LRU),
the port of ``repro.models.rglru``.

The RG-LRU is a gated diagonal linear recurrence
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ u_t),
    a_t = exp(−c · softplus(Λ) ⊙ r_t),      r_t, i_t = σ(gates(u_t)).
Over a sequence it runs :func:`associative_scan`, the recursive odd/even
combine tree of ``jax.lax.associative_scan`` (log-depth, each level a few
vectorised ops, the combines in the reference's float32 order); a decode
step (one token against a state) is one state update.

The roundings are the reference's optimized HLO's, read on the CPU in
bf16: the gate's tanh GELU op by op (``layers.gelu_tanh``); the conv's
four taps each rounded, product and sum, while the bias add stays in
float32 where the recurrence reads ``u`` (the gate products read it
rounded); ``a ** 2`` as ``exp(2 log a)`` (XLA folds ``exp(x) * exp(x)``
into ``exp(x + x)``); softplus as ``logaddexp(x, 0)`` and the sigmoids
as ``1 / (1 + exp(-x))``.

Given a state, :func:`rec_apply` writes the new ``h`` and ``conv`` into
it in place and returns that dict, as the attention caches are written.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import dense_init, gelu_tanh, softplus

__all__ = ["associative_scan", "rec_apply", "rec_init", "rec_state_init"]

_C = 8.0  # Griffin's recurrence-sharpness constant


def rec_init(gen, cfg, *, dtype, device, lead=()) -> Dict[str, torch.Tensor]:
    """The block's leaves; ``lam`` is float32 in any model dtype."""
    D = cfg.d_model
    W = cfg.lru_width or D
    kw = dict(device=device, lead=lead)
    lam = torch.empty((*lead, W), dtype=torch.float32, device=device)
    if gen is not None:
        lam.uniform_(0.9, 0.999, generator=gen)
    # Λ parameterized so softplus(Λ_raw) gives the target decay band
    lam_raw = torch.log(torch.expm1(-torch.log(lam) / _C))
    conv_w = torch.randn((*lead, cfg.conv_kernel, W), generator=gen,
                         dtype=torch.float32, device=device) * 0.1
    return {
        "wx": dense_init(gen, D, W, dtype, **kw),
        "wg": dense_init(gen, D, W, dtype, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, W), dtype=dtype, device=device),
        "wa": dense_init(gen, W, W, dtype, **kw),
        "wi": dense_init(gen, W, W, dtype, **kw),
        "lam": lam_raw,
        "wo": dense_init(gen, W, D, dtype, scale=1.0 / math.sqrt(W), **kw),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. u (B,S,W); w (k,W). Returns (the
    conv before its bias, rounded tap by tap in ``u``'s dtype; the new
    conv state (B,k-1,W))."""
    B, S, W = u.shape
    k = w.shape[0]
    pad = (torch.zeros((B, k - 1, W), dtype=u.dtype, device=u.device)
           if conv_state is None else conv_state)
    full = torch.cat([pad, u], dim=1)                 # (B, S+k-1, W)
    out = torch.zeros_like(u)
    for j in range(k):
        out = out + full[:, j:j + S, :] * w[j]
    new_state = full[:, S:, :]                        # the last k-1 steps
    return out, new_state


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, torch.addcmul(br, bl, ar)     # one fused multiply-add


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even`` at positions 0, 2, … and ``odd`` at 1, 3, … of dim 1."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n_odd:]], dim=1)


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of ``(a, b)`` along dim 1 under ``(al, bl) ∘
    (ar, br) = (al * ar, bl * ar + br)``, by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan those, then
    combine each odd result with the next even element."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], even[0]], dim=1)
    eb = torch.cat([b[:, :1], even[1]], dim=1)
    return _interleave(ea, odd[0]), _interleave(eb, odd[1])


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


def rec_apply(p, x: torch.Tensor, *, cfg,
              state: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(y (B,S,D), state)``. ``state = {"h": (B,W) f32, "conv":
    (B,k-1,W)}``; without one the recurrence starts from zeros and a new
    state dict is returned, with one it is updated in place and
    returned."""
    B, S, D = x.shape
    u = x @ p["wx"]
    g = gelu_tanh(x @ p["wg"])
    conv_state = state["conv"] if state is not None else None
    conv, new_conv = _causal_conv(u, p["conv_w"], conv_state)
    u32 = conv.float() + p["conv_b"].float()
    u = u32.to(x.dtype)

    r = _sigmoid((u @ p["wa"]).float())
    i = _sigmoid((u @ p["wi"]).float())
    lam = p["lam"]
    log_a = -_C * softplus(lam) * r                         # (B,S,W) f32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(log_a + log_a), 1e-12))
    b = mult * i * u32

    h0 = state["h"] if state is not None else None
    if S == 1 and h0 is not None:
        h = torch.addcmul(b[:, 0], a[:, 0], h0)        # decode step
        hs = h[:, None]
    else:
        if h0 is not None:
            b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]],
                          dim=1)
        _, hs = associative_scan(a, b)
        h = hs[:, -1]

    y = (hs.to(x.dtype) * g) @ p["wo"]
    if state is None:
        return y, {"h": h, "conv": new_conv}
    state["h"].copy_(h)
    state["conv"].copy_(new_conv)
    return y, state


def rec_state_init(cfg, batch: int, dtype, *,
                   device) -> Dict[str, torch.Tensor]:
    """A zero state: ``h`` (batch, W) float32, ``conv`` (batch, k-1, W) in
    ``dtype``."""
    W = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, W), dtype=dtype,
                            device=device),
    }
