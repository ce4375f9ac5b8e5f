"""The Mamba-2 block by SSD (state-space duality, arXiv:2405.21060), the
port of ``repro.models.ssd``.

The selective SSM  h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t,  y_t = C_t·h_t
runs as the reference runs it. Over a sequence, the chunked SSD scan:
within chunks of ``Q = min(chunk, S)`` tokens the recurrence is a masked
quadratic form, and between chunks the (H, P, N) chunk states pass
through :func:`~repro_torch.models.rglru.associative_scan`, the odd/even
tree of ``jax.lax.associative_scan``, with each chunk's decay broadcast
as (B, c, H, 1, 1). A decode step (one token against a state) is one
state update. The SSM math is float32 whatever the model dtype; the
products are plain ``torch.matmul``/``einsum``, as the reference leaves
them to XLA.

One deliberate difference: the intra-chunk decay ``exp(cum_q - cum_t)``
is masked to the causal triangle before the exponent, not after it. The
reference's order overflows above the diagonal once a chunk's summed
decay passes 88.7 (at mamba2-130m's full size, for some draws of the
weights) and its ``inf * 0`` makes the output NaN;
where the reference is finite the two are the same values.

The float32 prefix sums within a chunk (``torch.cumsum``, and
``torch.cumprod`` over the chunks) sum in another order than the
reference's ``jnp.cumsum`` and ``jnp.cumprod``, so the scan agrees with
JAX within a relative tolerance, not bit for bit. The roundings of the
bf16 ends are the reference's optimized HLO's: the conv's taps each
rounded (product and sum), the bias add and the SiLU op by op in the
model dtype; ``ys`` rounded before the gate ``ys * silu(z)``, whose
product the gated RMSNorm reads in float32 unrounded; softplus
as ``logaddexp(x, 0)`` (``F.softplus`` returns ``x`` above 20).

Given a state, :func:`ssd_apply` writes the new ``h`` and ``conv`` into
it in place and returns that dict, as the attention caches are written.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (dense_init, rmsnorm, rmsnorm_init,
                                       silu, softplus)
from repro_torch.models.rglru import associative_scan

__all__ = ["ssd_apply", "ssd_init", "ssd_state_init"]


def _dims(cfg):
    H = cfg.padded_ssm_heads
    P = cfg.ssm_head_dim
    return H, P, H * P, cfg.ssm_state


def ssd_init(gen, cfg, *, dtype, device, lead=()) -> Dict[str, torch.Tensor]:
    """The block's leaves; ``A_log``, ``D_skip`` and ``dt_bias`` are float32
    in any model dtype."""
    H, P, di, N = _dims(cfg)
    D = cfg.d_model
    kw = dict(device=device, lead=lead)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((*lead, cfg.conv_kernel, di + 2 * N), generator=gen,
                         **f32) * 0.1
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": dense_init(gen, D, 2 * di + 2 * N + H, dtype, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, di + 2 * N), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(
            *lead, H).clone(),
        "D_skip": torch.ones((*lead, H), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((*lead, H), 0.01,
                                                    **f32))),
        "norm": rmsnorm_init(di, dtype, **kw),
        "w_out": dense_init(gen, di, D, dtype, scale=1.0 / math.sqrt(di),
                            **kw),
    }


def _conv_causal(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time, then ``silu(out + b)``. u (B,S,C);
    w (k,C); state (B,k-1,C) or None (zeros). Returns (the activation, the
    new state: the last k-1 steps of ``[state, u]``)."""
    B, S, C = u.shape
    k = w.shape[0]
    pad = (torch.zeros((B, k - 1, C), dtype=u.dtype, device=u.device)
           if state is None else state)
    full = torch.cat([pad, u], dim=1)
    out = torch.zeros_like(u)
    for j in range(k):
        out = out + full[:, j:j + S, :] * w[j]
    return silu(out + b), full[:, S:, :]


def _chunked_scan(dt, dA, xf, Bx, Cx, h0, chunk: int):
    """The chunked SSD scan over ``S`` tokens (``S`` a multiple of ``Q =
    min(chunk, S)``): y (B,S,H,P) without the skip term, and the state
    after the last token (B,H,P,N)."""
    B, S, H = dt.shape
    P, N = xf.shape[-1], Bx.shape[-1]
    Q = min(chunk, S)
    if S % Q != 0:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    dAc = dA.reshape(B, nc, Q, H)
    cum = torch.cumsum(dAc, dim=2)                                # (B,c,Q,H)
    total = cum[:, :, -1]                                         # (B,c,H)
    xc = xf.reshape(B, nc, Q, H, P)
    Bc = Bx.reshape(B, nc, Q, N)
    Cc = Cx.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)

    # intra-chunk quadratic form; the decay is masked before its exponent
    # (the reference multiplies exp(cum_q - cum_t) by the mask after it,
    # and above the diagonal, where that difference is positive, the exp
    # overflows once a chunk's decay passes 88.7: inf * 0 is NaN)
    scores = torch.einsum("bcqn,bctn->bcqt", Cc, Bc)              # (B,c,Q,Q)
    causal = (torch.arange(Q, device=dt.device)[:, None]
              >= torch.arange(Q, device=dt.device)[None, :])
    decay_qt = torch.exp((cum[:, :, :, None] - cum[:, :, None, :])
                         .masked_fill(~causal[..., None], -math.inf))
    w_qt = scores[..., None] * decay_qt                           # (B,c,Q,Q,H)
    del decay_qt
    w_qt = w_qt * dtc[:, :, None]
    y = torch.einsum("bcqth,bcthp->bcqhp", w_qt, xc)
    del w_qt

    # chunk end-states
    endw = torch.exp(total[:, :, None] - cum) * dtc               # (B,c,Q,H)
    chunk_state = torch.einsum("bcqh,bcqhp,bcqn->bchpn", endw, xc, Bc)

    # inter-chunk recurrence over nc chunks, from zeros
    decay_chunk = torch.exp(total)                                # (B,c,H)
    _, states = associative_scan(decay_chunk[..., None, None], chunk_state)
    if h0 is not None:
        cumdecay = torch.cumprod(decay_chunk, dim=1)              # (B,c,H)
        states = states + cumdecay[..., None, None] * h0[:, None]
    first = (h0[:, None] if h0 is not None
             else torch.zeros((B, 1, H, P, N), dtype=xf.dtype,
                              device=xf.device))
    prev = torch.cat([first, states[:, :-1]], dim=1)             # (B,c,H,P,N)
    y = y + torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum), prev)
    return y.reshape(B, S, H, P), states[:, -1]


def ssd_apply(p, x_in: torch.Tensor, *, cfg,
              state: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(y (B,S,D), state)``. ``state = {"h": (B,H,P,N) f32, "conv":
    (B,k-1,di+2N)}``. With a state and ``S == 1``, one decode step; else
    the chunked scan (from the state's ``h`` where one is given). Without
    a state a new dict is returned; with one it is updated in place and
    returned."""
    B, S, D = x_in.shape
    H, P, di, N = _dims(cfg)
    proj = x_in @ p["w_in"]
    z, xBC, dt_raw = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = _conv_causal(xBC, p["conv_w"], p["conv_b"], conv_state)
    x, B_, C_ = torch.split(xBC, [di, N, N], dim=-1)
    dt = softplus(dt_raw.float() + p["dt_bias"])                  # (B,S,H)
    A = -torch.exp(p["A_log"])                                    # (H,)
    dA = dt * A                                                   # ≤ 0
    Bx = B_.float()
    Cx = C_.float()
    xf = x.reshape(B, S, H, P).float()

    h0 = state["h"] if state is not None else None
    if S == 1 and h0 is not None:
        # decode step
        decay = torch.exp(dA[:, 0])                               # (B,H)
        h = decay[..., None, None] * h0 + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, 0], xf[:, 0], Bx[:, 0])
        y = torch.einsum("bn,bhpn->bhp", Cx[:, 0], h)[:, None]    # (B,1,H,P)
    else:
        y, h = _chunked_scan(dt, dA, xf, Bx, Cx, h0, cfg.chunk)
    y = y + p["D_skip"][:, None] * xf
    ys = y.reshape(B, S, di)

    # the gated norm reads the product of the rounded factors unrounded
    gated = ys.to(x_in.dtype).float() * silu(z).float()
    out = rmsnorm(gated, p["norm"], cfg.norm_eps).to(x_in.dtype) @ p["w_out"]
    if state is None:
        return out, {"h": h, "conv": new_conv}
    state["h"].copy_(h)
    state["conv"].copy_(new_conv)
    return out, state


def ssd_state_init(cfg, batch: int, dtype, *,
                   device) -> Dict[str, torch.Tensor]:
    """A zero state: ``h`` (batch, H, P, N) float32, ``conv`` (batch, k-1,
    di+2N) in ``dtype``."""
    H, P, di, N = _dims(cfg)
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * N),
                            dtype=dtype, device=device),
    }
