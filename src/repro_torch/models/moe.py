"""Mixture-of-Experts block, the port of ``repro.models.moe``: top-k
routing with sort-based token dispatch.

Each token is replicated k times, the N·k assignments are stably sorted
by expert id, each takes its position inside its expert's group, those
past the capacity ``C = max(8, round(N·k/E · capacity_factor))`` are
dropped (Python's ``round``, half to even, as the reference rounds), and
the kept ones are copied into an ``(E·C + 1, D)`` buffer whose last row
takes every dropped assignment. The experts run as three batched products
over the expert axis; the results come back through the inverse of the
sort and are summed per token with the renormalised router gates (zero
for a dropped assignment): a gather and a reduction, no scatter-add. The
reference's sharding constraints (``constrain``) are the identity
without a mesh, and are left out.

The roundings are the reference's optimized HLO's, read on the CPU in
bf16: the router product takes the float32 router rounded to the model
dtype but keeps its float32 result (XLA drops the bf16 round trip before
the softmax); the expert SiLU is op by op, as ``layers.ffn_apply``'s; the
gates are rounded to the model dtype and the k-way combine is summed in
float32 and rounded once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_randn, dense_init, ffn_apply,
                                       ffn_init, silu)

__all__ = ["capacity", "dispatch", "moe_apply", "moe_aux_loss", "moe_init",
           "route", "router_logits", "top_k"]


def moe_init(gen, cfg, *, dtype, device, lead=()) -> Dict[str, torch.Tensor]:
    """The router (float32 in any model dtype), the ``(E, D, F)`` gate and
    up and ``(E, F, D)`` down experts, and the shared FFN of width
    ``num_shared_experts * moe_d_ff`` where there is one."""
    D, Fe, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, D, E, torch.float32, device=device,
                             lead=lead),
        "gate": _randn(gen, (*lead, E, D, Fe), device).to(dtype) / D ** 0.5,
        "up": _randn(gen, (*lead, E, D, Fe), device).to(dtype) / D ** 0.5,
        "down": _randn(gen, (*lead, E, Fe, D), device).to(dtype) / Fe ** 0.5,
    }
    if cfg.num_shared_experts:
        p["shared"] = ffn_init(gen, D, cfg.num_shared_experts * Fe, dtype,
                               device=device, lead=lead)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, equal values in ascending index order (``torch.topk`` leaves
    that order unspecified). A stable ascending sort of ``-probs`` keeps
    equal values in index order; negation is exact."""
    idx = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return torch.gather(probs, -1, idx), idx


def router_logits(p, xf: torch.Tensor) -> torch.Tensor:
    """The router logits (N, E) of tokens ``xf`` (N, D): the product of
    ``xf`` and the router rounded to ``xf``'s dtype, summed and kept in
    float32."""
    return xf.float() @ p["router"].to(xf.dtype).float()


def route(p, xf: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """``(probs (N, E) float32, top-k probs, top-k experts)`` of tokens
    ``xf`` (N, D): the float32 softmax of :func:`router_logits`."""
    probs = torch.softmax(router_logits(p, xf), dim=-1)
    return (probs, *top_k(probs, k))


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert: ``max(8, round(N·k/E · capacity_factor))``, with
    Python's ``round`` (half to even), as the reference computes it."""
    return max(8, int(round(n_tokens * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor)))


def dispatch(experts: torch.Tensor, num_experts: int,
             cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(order, slot, keep)`` of the top-k assignments ``experts`` (N,
    k): ``order`` sorts the N·k assignments stably by expert; in that
    order, ``slot`` is each one's row of the ``(E·cap + 1)``-row expert
    buffer (``expert·cap + its place in the group``, or the last row,
    ``E·cap``, once the group is full) and ``keep`` says it fitted."""
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        num_experts, device=experts.device))
    pos = torch.arange(flat_e.numel(), device=experts.device) \
        - starts[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, num_experts * cap)
    return order, slot, keep


def moe_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, D) → (B, S, D): the routed experts' gated sum, plus the
    shared FFN where there is one."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, D)

    _, gates, experts = route(p, xf, k)                 # (N, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    cap = capacity(N, cfg)
    order, slot, keep = dispatch(experts, E, cap)

    # gather into sorted order (order // k: each slot's token), then copy
    # into the expert buffer; every dropped assignment lands in the last
    # row, which nothing reads
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, slot, xf[order // k])
    h = buf[:E * cap].reshape(E, cap, D)

    act = silu(torch.bmm(h, p["gate"])) * torch.bmm(h, p["up"])
    y_e = torch.bmm(act, p["down"])

    y_flat = torch.cat([y_e.reshape(E * cap, D),
                        torch.zeros((1, D), dtype=y_e.dtype,
                                    device=x.device)])
    per_slot = y_flat[slot]                              # (N·k, D), sorted
    # slot j of token n back at n·k + j, then the k-way sum per token
    inv = torch.argsort(order)
    per_tok = per_slot[inv].reshape(N, k, D)
    keep_tok = keep[inv].reshape(N, k)
    w = (gates * keep_tok).to(x.dtype)
    y = torch.einsum("nkd,nk->nd", per_tok.float(), w.float()).to(x.dtype)

    if "shared" in p:
        y = y + ffn_apply(p["shared"], xf)
    return y.reshape(B, S, D)


def moe_aux_loss(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style): ``E · Σ_e f_e · p_e``,
    ``f_e`` the share of top-k assignments routed to expert e and ``p_e``
    its mean router probability. The language-model loss does not add it,
    as the reference's does not."""
    xf = x.reshape(-1, x.shape[-1])
    probs, _, experts = route(p, xf, cfg.top_k)
    counts = F.one_hot(experts, cfg.num_experts).float().sum(dim=(0, 1))
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    imp = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(frac * imp)
