"""MLA (DeepSeek-V2 multi-head latent attention) and deepseek-v2-236b in
the port against the JAX package: the materialised full sequence, the
absorbed decode and its cache writes, the flash route with the query
and value widths apart, both query branches; deepseek-v2's forward, loss
and gradients, its repeat-0 MoE segment, decode against the full forward
for both MoE architectures, and greedy serving.

Parameters come from the JAX ``mla_init`` / ``init_params`` and cross to
the port as bytes (``from_numpy``, ``trainer_state``); inputs are drawn
with numpy from a seed. Tolerances: float32 within 1e-5; decode against
the full forward within the reference's own 2e-4
(``tests/test_models_smoke.py``); bf16 within 4 bf16 ulps of the largest
value, greedy tokens equal; gradients per leaf under 3e-2 relative L2.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.launch.train import flatten_state as jax_flatten
from repro.models import attention as jatt
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.launch.serve import serve_batch
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, lm_loss)
from repro_torch.models import attention as att
from repro_torch.persistence.state import (flatten_state, from_numpy,
                                           trainer_state, unflatten_state)

PHI, DSV2 = "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"
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


def check(got: torch.Tensor, want, dtype: str, what: str) -> None:
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **F32, err_msg=what)
    else:
        assert_within_ulps(got, want, what)


def reduced(arch: str, dtype: str = "float32", **kw):
    return dataclasses.replace(jax_get_reduced(arch), dtype=dtype, **kw)


def mla(cfg, seed: int = 0):
    """The JAX MLA block's parameters and the same bytes as the port's."""
    jp = jatt.mla_init(jax.random.key(seed), cfg, dtype=jnp.dtype(cfg.dtype))
    tp = unflatten_state(from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jp).items()}, "cpu"))
    return jp, tp


def both(cfg, seed: int = 0):
    jp = jax.jit(lambda k: jax_init_params(cfg, k))(jax.random.key(seed))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    return jp, tp


def inputs(cfg, B: int, S: int, seed: int = 0):
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
         * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jx = jnp.asarray(x).astype(jnp.dtype(cfg.dtype))
    tx = torch.from_numpy(x).to(getattr(torch, cfg.dtype))
    return jx, tx, jnp.asarray(pos), torch.from_numpy(pos)


def tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


#: the q-LoRA branch (the configuration's) and the plain ``wq`` branch
Q_BRANCHES = {"q_lora": {}, "wq": {"q_lora_rank": 0}}


# -------------------------------------------------------------- the block

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", sorted(Q_BRANCHES))
def test_mla_full_sequence_matches_jax(dtype, branch):
    cfg = reduced(DSV2, dtype, **Q_BRANCHES[branch])
    jp, tp = mla(cfg)
    assert ("wq_a" in tp) == (branch == "q_lora") and ("wq" in tp) != (
        branch == "q_lora")
    jx, tx, jpos, tpos = inputs(cfg, 2, 12)
    want, wc = jax.jit(lambda p, x, pos: jatt.mla_apply(
        p, x, cfg=cfg, positions=pos))(jp, jx, jpos)
    got, gc = att.mla_apply(tp, tx, cfg=cfg, positions=tpos)
    check(got, want, dtype, "out")
    assert set(gc) == {"ckv", "k_rope"}
    for k in gc:
        check(gc[k], wc[k], dtype, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", sorted(Q_BRANCHES))
def test_mla_absorbed_decode_matches_jax(dtype, branch):
    """Eight decode steps from an empty latent cache of 8 slots: every
    step's output, and the cache, written in place."""
    cfg = reduced(DSV2, dtype, **Q_BRANCHES[branch])
    jp, tp = mla(cfg)
    jx, tx, _, _ = inputs(cfg, 2, 8, seed=1)
    step = jax.jit(lambda p, x, pos, c, cp: jatt.mla_apply(
        p, x, cfg=cfg, positions=pos, cache=c, cache_pos=cp))
    jc = jatt.mla_cache_init(cfg, 2, 8, jnp.dtype(dtype))
    tc = att.mla_cache_init(cfg, 2, 8, getattr(torch, dtype), device="cpu")
    for t in range(8):
        pos = np.full((2, 1), t, dtype=np.int32)
        want, jc = step(jp, jx[:, t:t + 1], jnp.asarray(pos), jc,
                        jnp.int32(t))
        got, tc2 = att.mla_apply(tp, tx[:, t:t + 1], cfg=cfg,
                                 positions=torch.from_numpy(pos), cache=tc,
                                 cache_pos=t)
        assert tc2 is tc
        check(got, want, dtype, f"step {t}")
    for k in ("ckv", "k_rope"):
        check(tc[k], jc[k], dtype, k)


@pytest.mark.parametrize("cache_pos,S", [(7, 2), (8, 1), (9, 1), (6, 2)])
def test_mla_cache_write_clamps_at_the_end(cache_pos, S):
    """A write of S tokens at ``cache_pos`` into 8 slots starts at
    ``min(cache_pos, 8 - S)``, as ``dynamic_update_slice`` clamps it;
    the mask still reads the unclamped ``cache_pos``."""
    cfg = reduced(DSV2)
    jp, tp = mla(cfg)
    jx, tx, _, _ = inputs(cfg, 2, S, seed=2)
    rng = np.random.default_rng(3)
    ckv = rng.standard_normal((2, 8, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, 8, cfg.qk_rope_dim)).astype(np.float32)
    pos = np.full((2, S), cache_pos, dtype=np.int32)
    want, jc = jax.jit(lambda p, x, pos, c, cp: jatt.mla_apply(
        p, x, cfg=cfg, positions=pos, cache=c, cache_pos=cp))(
            jp, jx, jnp.asarray(pos),
            {"ckv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)},
            jnp.int32(cache_pos))
    tc = {"ckv": torch.from_numpy(ckv.copy()),
          "k_rope": torch.from_numpy(kr.copy())}
    got, _ = att.mla_apply(tp, tx, cfg=cfg, positions=torch.from_numpy(pos),
                           cache=tc, cache_pos=cache_pos)
    check(got, want, "float32", "out")
    start = min(cache_pos, 8 - S)
    for k, before in (("ckv", ckv), ("k_rope", kr)):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F32)
        np.testing.assert_array_equal(tc[k][:, :start].numpy(),
                                      before[:, :start])
        assert not np.array_equal(tc[k][:, start:].numpy(),
                                  before[:, start:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_takes_the_flash_route_above_the_threshold(monkeypatch, dtype):
    """With ``FLASH_THRESHOLD`` lowered in both packages, 64 tokens take
    ``_attend_flash`` with KV = H and G = 1, queries and keys of width
    nope + rope (48) and values of width v_head_dim (32); the port's
    result is JAX's and its masked path's."""
    cfg = reduced(DSV2, dtype)
    jp, tp = mla(cfg)
    jx, tx, jpos, tpos = inputs(cfg, 2, 64, seed=4)
    shapes = []
    orig = att._attend_flash

    def spy(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(jatt, "FLASH_THRESHOLD", 32)
    monkeypatch.setattr(att, "FLASH_THRESHOLD", 32)
    monkeypatch.setattr(att, "_attend_flash", spy)
    want, _ = jax.jit(lambda p, x, pos: jatt.mla_apply(
        p, x, cfg=cfg, positions=pos))(jp, jx, jpos)
    got, _ = att.mla_apply(tp, tx, cfg=cfg, positions=tpos)
    H, hd = cfg.padded_heads, cfg.qk_nope_dim + cfg.qk_rope_dim
    assert shapes == [((2, 64, H, 1, hd), (2, 64, H, hd),
                       (2, 64, H, cfg.v_head_dim))]
    assert hd != cfg.v_head_dim
    monkeypatch.setattr(att, "FLASH_THRESHOLD", 4096)
    dense, _ = att.mla_apply(tp, tx, cfg=cfg, positions=tpos)
    assert len(shapes) == 1
    check(got, want, dtype, "flash vs JAX")
    check(got, dense.float().numpy(), dtype, "flash vs masked")


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def dsv2(request):
    cfg = reduced(DSV2, request.param)
    jp, tp = both(cfg)
    return cfg, jp, tp, jax_synthetic_batch(cfg, 2, 32, cursor=2)


def test_deepseek_forward_and_loss_match_jax(dsv2):
    cfg, jp, tp, b = dsv2
    assert [(s.pattern, s.repeat) for s in cfg.segments] == [
        (("attn",), 1), (("attn_moe",), 2)]
    want, _ = jax.jit(lambda p, t: jax_forward(p, cfg, {"tokens": t}))(
        jp, jnp.asarray(b["tokens"]))
    got, _ = forward(tp, cfg, {"tokens": torch.from_numpy(b["tokens"])})
    check(got, want, cfg.dtype, "logits")
    jloss, _ = jax.jit(lambda p, b: jax_lm_loss(p, cfg, b))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, _ = lm_loss(tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if cfg.dtype == "float32" else 2e-2)


def test_deepseek_gradients_match_jax(dsv2):
    """Per leaf, with remat: MLA's norms and projections, the dense first
    layer's FFN, the float32 router, the experts and the shared FFN."""
    cfg, jp, tp, b = dsv2
    jgrads = jax_flatten(jax.jit(jax.grad(lambda p, b: jax_lm_loss(
        p, cfg, b, remat=True)[0]))(jp, {k: jnp.asarray(v)
                                         for k, v in b.items()}))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_state(tp).items()}
    loss, _ = lm_loss(unflatten_state(leaves), cfg,
                      {k: torch.from_numpy(v) for k, v in b.items()},
                      remat=True)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert set(grads) == set(jgrads)
    for k in ("decoder/seg0/b0/attn/kv_norm", "decoder/seg0/b0/attn/q_norm",
              "decoder/seg0/b0/ffn/gate", "decoder/seg1/b0/moe/router",
              "decoder/seg1/b0/moe/shared/down"):
        assert k in grads
    for k, g in grads.items():
        want = np.asarray(jgrads[k], dtype=np.float32)
        err = (np.linalg.norm(g.float().numpy() - want)
               / max(np.linalg.norm(want), 1e-30))
        assert err < 3e-2, (k, err)


def test_one_layer_deepseek_has_the_reference_repeat_zero_moe_segment():
    """At depth 1 the MoE segment repeats 0 times, as the reference's does:
    its leaves have a leading 0, and the forward is JAX's."""
    cfg = reduced(DSV2, num_layers=1)
    assert [(s.pattern, s.repeat) for s in cfg.segments] == [
        (("attn",), 1), (("attn_moe",), 0)]
    jp, tp = both(cfg)
    abstract = jax.eval_shape(lambda k: jax_init_params(cfg, k),
                              jax.random.key(0))
    want = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = flatten_state(init_params(cfg, device="meta"))
    assert {k: tuple(t.shape) for k, t in got.items()} == want
    assert got["decoder/seg1/b0/moe/gate"].shape[0] == 0
    toks = tokens(cfg, 5, (2, 16))
    jl, _ = jax.jit(lambda p, t: jax_forward(p, cfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    tl, _ = forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    check(tl, jl, "float32", "logits")


@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_decode_equals_the_full_forward(arch):
    """The reference's check (``tests/test_models_smoke.py``): with the
    capacity factor raised to 8.0 nothing is dropped, so 12 decode steps
    from fresh caches give the full causal forward's logits."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              capacity_factor=8.0)
    params = init_params(cfg, 2, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 3, (2, 12)))
    with torch.inference_mode():
        full, _ = forward(params, cfg, {"tokens": toks})
        caches = init_caches(cfg, 2, 12, device="cpu")
        outs = [decode_step(params, cfg, toks[:, t:t + 1], caches, t)[0]
                for t in range(12)]
    if arch == DSV2:
        assert set(flatten_state(caches)) == {
            f"seg{i}/b0/{k}" for i in (0, 1) for k in ("ckv", "k_rope")}
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("arch,dtype", [(PHI, "float32"), (PHI, "bfloat16"),
                                        (DSV2, "float32"),
                                        (DSV2, "bfloat16")])
def test_serve_batch_greedy_tokens_are_jax_tokens(arch, dtype):
    cfg = reduced(arch, dtype)
    jp, tp = both(cfg)
    prompts = jax_synthetic_batch(cfg, 2, 8, cursor=0)["tokens"]
    want, _ = jax_serve_batch(cfg, jp, jnp.asarray(prompts), 6)
    got, tps = serve_batch(cfg, tp, torch.from_numpy(prompts), 6)
    assert got.shape == (2, 6) and tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
