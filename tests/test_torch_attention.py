"""The port's attention routes (``repro_torch.models.attention``) against
the JAX package's: the chunked online softmax (flash), the sliding
window's chunked band and masked paths, the ring-buffer decode cache and
M-RoPE.

Inputs are drawn with numpy from a seed and reach both packages as the
same bytes; parameters come from the JAX ``gqa_init`` and cross as bytes
(``from_numpy``). In float32 the port is held to JAX within 1e-5; in bf16
within 4 bf16 ulps of the largest value, the bound of
``tests/test_torch_model.py``. Each route is also held against the
port's own masked dense path on the same inputs, the comparison the
smoke makes on the card.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.launch.train import flatten_state as jax_flatten
from repro.models import attention as jatt
from repro.models.layers import mrope_angles as jax_mrope_angles
from repro_torch.models import attention as att
from repro_torch.models.layers import mrope_angles, rope_angles
from repro_torch.persistence.state import from_numpy

F32 = dict(rtol=1e-5, atol=1e-5)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def assert_within_ulps(got: torch.Tensor, want, what: str,
                       ulps: int = 4) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= ulps * bf16_ulp(np.max(np.abs(want))), (what, err)


def cfg_for(arch: str, dtype: str, **kw):
    return dataclasses.replace(jax_get_reduced(arch), dtype=dtype, **kw)


def params(cfg, seed: int = 0):
    """``gqa_init``'s leaves in JAX and the same bytes as tensors."""
    jp = jatt.gqa_init(jax.random.key(seed), cfg, dtype=jnp.dtype(cfg.dtype))
    flat = {k: np.asarray(v) for k, v in jax_flatten(jp).items()}
    return jp, from_numpy(flat, device="cpu")


def inputs(cfg, B: int, S: int, seed: int = 1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(cfg.dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, cfg.dtype))
    return jx, tx


def positions(B: int, S: int):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return jnp.asarray(pos), torch.from_numpy(np.array(pos))


def mrope_grid(B: int, S: int, seed: int) -> np.ndarray:
    """Distinct temporal, height and width ids (3, B, S): with equal rows
    M-RoPE is 1-D RoPE, and a comparison would prove nothing."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 4 * S, size=(3, B, S)).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return pos


def masked(qg, k, v, S: int, window: int, causal: bool = True):
    """The port's masked dense path on the same inputs, the route's
    alternative."""
    ar = torch.arange(S)
    m = ar[None, :] <= ar[:, None] if causal else torch.ones(S, S,
                                                             dtype=torch.bool)
    if window:
        m &= (ar[:, None] - ar[None, :]) < window
    return att._attend(qg, k, v, m, 1.0 / math.sqrt(qg.shape[-1]))


# ------------------------------------------------------------------- flash

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [64, 40])
def test_flash_matches_jax_and_the_masked_path(causal, T):
    """``_attend_flash`` over 16-key chunks (T = 64: four chunks; T = 40:
    16 does not divide it, so one chunk of T, as the reference falls
    back) against JAX's in float32, and against the masked path."""
    rng = np.random.default_rng(3)
    B, KV, G, hd = 2, 2, 3, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, KV, G, hd), (B, T, KV, hd), (B, T, KV, hd)))
    want = jatt._attend_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, scale=0.25, k_chunk=16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = att._attend_flash(tq, tk, tv, causal=causal, scale=0.25,
                            k_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    ar = torch.arange(T)
    m = (ar[None, :] <= ar[:, None]) if causal else torch.ones(
        T, T, dtype=torch.bool)
    np.testing.assert_allclose(got.numpy(),
                               att._attend(tq, tk, tv, m, 0.25).numpy(),
                               **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_takes_the_flash_route_above_the_threshold(monkeypatch, dtype):
    """With ``FLASH_THRESHOLD`` lowered in both packages, a 64-token
    sequence takes the flash route (1024-key chunks: one chunk of 64)
    in both; the port's result is JAX's and its masked path's."""
    cfg = cfg_for("tinyllama-1.1b", dtype)
    jp, tp = params(cfg)
    jx, tx = inputs(cfg, 2, 64)
    jpos, tpos = positions(2, 64)
    called = []
    orig = att._attend_flash

    def spy(*a, **kw):
        called.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(jatt, "FLASH_THRESHOLD", 32)
    monkeypatch.setattr(att, "FLASH_THRESHOLD", 32)
    monkeypatch.setattr(att, "_attend_flash", spy)
    want, _ = jatt.gqa_apply(jp, jx, cfg=cfg, positions=jpos)
    got, kv = att.gqa_apply(tp, tx, cfg=cfg, positions=tpos)
    assert called and set(kv) == {"k", "v"}
    monkeypatch.setattr(att, "FLASH_THRESHOLD", 4096)
    dense, _ = att.gqa_apply(tp, tx, cfg=cfg, positions=tpos)
    assert len(called) == 1            # the dense call took the mask
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32)
    else:
        assert_within_ulps(got, want, "flash vs JAX")
        assert_within_ulps(got, dense.float().numpy(), "flash vs masked")


# ------------------------------------------------------------------ window

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 20, 32, 48])
def test_windowed_routes_match_jax(dtype, S):
    """Window 16: S = 16 (``S <= window``) and 20 (``S % window != 0``)
    take the masked path, 32 (``2·window``) and 48 the chunked band, in
    both packages."""
    cfg = cfg_for("recurrentgemma-9b", dtype, window=16)
    jp, tp = params(cfg)
    jx, tx = inputs(cfg, 2, S)
    jpos, tpos = positions(2, S)
    want, _ = jatt.gqa_apply(jp, jx, cfg=cfg, positions=jpos, window=16)
    got, _ = att.gqa_apply(tp, tx, cfg=cfg, positions=tpos, window=16)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    else:
        assert_within_ulps(got, want, f"S={S}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_matches_the_masked_path(dtype):
    """At S = 2·window the band (each chunk against itself and the one
    before) equals the windowed mask over the whole sequence, forward
    and gradients."""
    w, S = 8, 16
    cfg = cfg_for("recurrentgemma-9b", dtype, window=w)
    rng = np.random.default_rng(7)
    G = cfg.padded_heads // cfg.padded_kv_heads
    hd = cfg.raw_head_dim
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dt).requires_grad_(True)
               for s in ((2, S, 1, G, hd), (2, S, 1, hd), (2, S, 1, hd)))
    band = att._attend_band(q, k, v, w, 1.0 / math.sqrt(hd))
    dense = masked(q, k, v, S, w)
    if dtype == "float32":
        torch.testing.assert_close(band, dense, **F32)
    else:
        assert_within_ulps(band, dense.detach().float().numpy(), "band")
    up = torch.from_numpy(rng.standard_normal(band.shape).astype(np.float32))
    gb = torch.autograd.grad(band, (q, k, v), up.to(dt))
    gd = torch.autograd.grad(dense, (q, k, v), up.to(dt))
    for a, b, name in zip(gb, gd, "qkv"):
        if dtype == "float32":
            torch.testing.assert_close(a, b, **F32)
        else:
            assert_within_ulps(a, b.float().numpy(), f"d{name}")


def test_band_route_is_taken_by_the_reference_condition(monkeypatch):
    cfg = cfg_for("recurrentgemma-9b", "float32", window=8)
    _, tp = params(cfg)
    calls = []
    orig = att._attend_band
    monkeypatch.setattr(att, "_attend_band",
                        lambda *a: calls.append(a[0].shape[1]) or orig(*a))
    for S in (8, 12, 16, 24):
        _, tx = inputs(cfg, 1, S)
        att.gqa_apply(tp, tx, cfg=cfg, positions=positions(1, S)[1],
                      window=8)
    assert calls == [16, 24]


# ------------------------------------------------------------- ring decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_decode_matches_jax_past_the_window(dtype):
    """Window 8, a ring of 8 slots, 24 decode steps (the ring wraps
    twice): each step's output and the ring's k, v and pos against JAX's
    ``gqa_apply`` with the same cache; the ``pos`` leaf is written in
    place through the view it was given."""
    cfg = cfg_for("recurrentgemma-9b", dtype, window=8)
    jp, tp = params(cfg)
    n, B = 24, 2
    jx, tx = inputs(cfg, B, n, seed=4)
    jc = jatt.gqa_cache_init(cfg, B, n, jnp.dtype(dtype))
    stacked = {k: v[None] for k, v in att.gqa_cache_init(
        cfg, B, n, getattr(torch, dtype), device="cpu").items()}
    tc = {k: v[0] for k, v in stacked.items()}      # per-layer views
    assert tc["k"].shape[1] == 8
    for t in range(n):
        want, jc = jatt.gqa_apply(jp, jx[:, t:t + 1], cfg=cfg,
                                  positions=jnp.full((B, 1), t, jnp.int32),
                                  window=8, cache=jc, cache_pos=jnp.int32(t))
        got, tc2 = att.gqa_apply(tp, tx[:, t:t + 1], cfg=cfg,
                                 positions=torch.full((B, 1), t),
                                 window=8, cache=tc, cache_pos=t)
        assert tc2 is tc
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        else:
            assert_within_ulps(got, want, f"step {t}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(stacked["pos"][0].numpy(),
                                  np.arange(16, 24)[None])
    for leaf in ("k", "v"):
        if dtype == "float32":
            np.testing.assert_allclose(tc[leaf].numpy(),
                                       np.asarray(jc[leaf]), **F32)
        else:
            assert_within_ulps(tc[leaf], jc[leaf], leaf)


def test_ring_decode_equals_windowed_full_attention():
    """Stepping 20 tokens through a ring of 6 slots gives the windowed
    full-sequence attention at every position (S % window != 0: the
    masked path)."""
    cfg = cfg_for("recurrentgemma-9b", "float32", window=6)
    _, tp = params(cfg)
    n = 20
    _, tx = inputs(cfg, 2, n, seed=5)
    full, _ = att.gqa_apply(tp, tx, cfg=cfg, positions=positions(2, n)[1],
                            window=6)
    cache = att.gqa_cache_init(cfg, 2, n, torch.float32, device="cpu")
    steps = [att.gqa_apply(tp, tx[:, t:t + 1], cfg=cfg,
                           positions=torch.full((2, 1), t), window=6,
                           cache=cache, cache_pos=t)[0] for t in range(n)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------------------------ M-RoPE

def test_mrope_angles_match_jax_on_distinct_grids():
    cfg = jax_get_reduced("qwen2-vl-7b")
    hd = cfg.raw_head_dim
    pos = mrope_grid(2, 12, seed=0)
    jc, js = jax_mrope_angles(jnp.asarray(pos), hd, cfg.rope_theta,
                              cfg.mrope_sections)
    tc, ts = mrope_angles(torch.from_numpy(pos), hd, cfg.rope_theta,
                          cfg.mrope_sections)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (2, 12, hd // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
    # each section takes its own row of ids
    c1, _ = rope_angles(torch.from_numpy(pos[1]), hd, cfg.rope_theta)
    lo, hi = cfg.mrope_sections[0], sum(cfg.mrope_sections[:2])
    torch.testing.assert_close(tc[..., lo:hi], c1[..., lo:hi])


def test_mrope_with_equal_rows_is_1d_rope():
    cfg = jax_get_reduced("qwen2-vl-7b")
    pos = torch.arange(10)[None].expand(2, 10)
    got = mrope_angles(pos.expand(3, 2, 10), 32, cfg.rope_theta,
                       cfg.mrope_sections)
    want = rope_angles(pos, 32, cfg.rope_theta)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_with_mrope_matches_jax(dtype):
    cfg = cfg_for("qwen2-vl-7b", dtype)
    jp, tp = params(cfg)
    jx, tx = inputs(cfg, 2, 12)
    pos = mrope_grid(2, 12, seed=1)
    want, _ = jatt.gqa_apply(jp, jx, cfg=cfg, positions=jnp.asarray(pos))
    got, _ = att.gqa_apply(tp, tx, cfg=cfg, positions=torch.from_numpy(pos))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    else:
        assert_within_ulps(got, want, "M-RoPE attention")
