"""The RG-LRU hybrid (recurrentgemma-9b) and the M-RoPE model (qwen2-vl-7b)
in the port against the JAX package: the recurrent block, forward,
decode with the ring buffer wrapped and serving (the gradients, AdamW and
the trainer are in ``tests/test_torch_hybrid_train.py``).

Parameters come from the JAX ``init_params`` of the reduced
configurations and cross to the port as bytes (``trainer_state``);
inputs are drawn with numpy from a seed. Tolerances: float32 within 1e-5;
decode against the full forward within the reference's own 2e-4
(``tests/test_models_smoke.py``); bf16 logits, caches and states within
4 bf16 ulps of their largest value, and greedy tokens equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.launch.steps import build_prefill_step as jax_build_prefill_step
from repro.launch.train import flatten_state as jax_flatten
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models import rglru as jrec
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import synthetic_batch
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, lm_loss)
from repro_torch.models import rglru
from repro_torch.models.layers import gelu_tanh
from repro_torch.persistence.state import (flatten_state, from_numpy,
                                           trainer_state, unflatten_state)

HYBRID, VLM = "recurrentgemma-9b", "qwen2-vl-7b"
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


def reduced(arch: str, dtype: str = "bfloat16", **kw):
    return dataclasses.replace(jax_get_reduced(arch), dtype=dtype, **kw)


def both(cfg, seed: int = 0):
    """The JAX parameters and the same bytes as the port's tree."""
    jp = jax_init_params(cfg, jax.random.key(seed))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    return jp, tp


def tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def vlm_batch(cfg, B: int, S: int, seed: int):
    """Tokens, four patch embeddings and distinct (t, h, w) ids."""
    rng = np.random.default_rng(seed)
    return {"tokens": tokens(cfg, seed, (B, S)),
            "vis_embeds": rng.standard_normal(
                (B, 4, cfg.d_model)).astype(np.float32),
            "positions": rng.integers(0, 3 * S, size=(3, B, S)).astype(
                np.int32)}


def check(got: torch.Tensor, want, cfg, what: str) -> None:
    if cfg.dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32,
                                   err_msg=what)
    else:
        assert_within_ulps(got, want, what)


def fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def abstract_tree(cfg):
    abstract = jax.eval_shape(lambda k: jax_init_params(cfg, k),
                              jax.random.key(0))
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}


# ----------------------------------------------------------- configurations

@pytest.mark.parametrize("arch,count", [(HYBRID, 9_396_084_736),
                                        (VLM, 7_615_483_904)])
def test_full_size_trees_on_meta_are_the_reference(arch, count):
    assert fields(get_config(arch)) == fields(jax_get_config(arch))
    assert fields(get_reduced(arch)) == fields(jax_get_reduced(arch))
    want = abstract_tree(jax_get_config(arch))
    got = flatten_state(init_params(get_config(arch), device="meta"))
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype) == f"torch.{want[k].dtype}", k
    assert sum(t.numel() for t in got.values()) == sum(
        math.prod(v.shape) for v in want.values())
    # the configuration's analytic count (no padded heads, no conv bias)
    assert get_config(arch).param_count() == \
        jax_get_config(arch).param_count() == count
    if arch == HYBRID:
        assert got["decoder/seg0/b0/rec/lam"].dtype == torch.float32
        assert [(s.pattern, s.repeat) for s in get_config(arch).segments] \
            == [(("rec", "rec", "attn"), 12), (("rec", "rec"), 1)]


def test_two_layer_hybrid_has_the_reference_repeat_zero_segment():
    cfg = dataclasses.replace(jax_get_reduced(HYBRID), num_layers=2)
    assert [(s.pattern, s.repeat) for s in cfg.segments] == [
        (("rec", "rec", "attn"), 0), (("rec", "rec"), 1)]
    want = abstract_tree(cfg)
    got = flatten_state(init_params(
        dataclasses.replace(get_reduced(HYBRID), num_layers=2),
        device="meta"))
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert got["decoder/seg0/b2/attn/wq"].shape[0] == 0


def test_synthetic_batches_carry_the_reference_extras():
    cfg = jax_get_reduced(VLM)
    want = jax_synthetic_batch(cfg, 2, 16, cursor=3)
    got = synthetic_batch(get_reduced(VLM), 2, 16, cursor=3)
    assert list(got) == list(want) == ["tokens", "labels", "vis_embeds",
                                       "positions"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["positions"].shape == (3, 2, 16)


# ------------------------------------------------------------------ RG-LRU

def test_gelu_is_the_reference_op_by_op():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 3
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.gelu)(xb).astype(jnp.float32))
    got = gelu_tanh(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), want)   # bit for bit
    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), **F32)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_is_the_reference_tree(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 8)).astype(np.float32)
    b = rng.standard_normal((2, n, 8)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    wa, wb = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    ga, gb = rglru.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6,
                               atol=1e-6)
    # the recurrence itself bit for bit: the same combine tree, and XLA
    # fuses bl * ar + br into one multiply-add as torch.addcmul does
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


@pytest.mark.parametrize("S,stateful", [(1, True), (16, False), (17, True)])
def test_rec_apply_matches_jax_in_float32(S, stateful):
    cfg = reduced(HYBRID, "float32")
    jp = jrec.rec_init(jax.random.key(0), cfg, dtype=jnp.float32)
    tp = unflatten_state(from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jp).items()}, "cpu"))
    assert tp["lam"].dtype == torch.float32
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jst = tst = None
    if stateful:
        h = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
        conv = rng.standard_normal((2, 3, cfg.lru_width)).astype(np.float32)
        jst = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        tst = {"h": torch.from_numpy(h.copy()),
               "conv": torch.from_numpy(conv.copy())}
    wy, wst = jax.jit(lambda p, x, st: jrec.rec_apply(
        p, x, cfg=cfg, state=st))(jp, jnp.asarray(x), jst)
    gy, gst = rglru.rec_apply(tp, torch.from_numpy(x), cfg=cfg, state=tst)
    if stateful:
        assert gst is tst                  # updated in place
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **F32)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]), **F32)


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_forward_and_loss_match_jax(dtype):
    """64 tokens over the reduced window 32: the chunked band in every
    attention layer."""
    cfg = reduced(HYBRID, dtype)
    jp, tp = both(cfg)
    b = jax_synthetic_batch(cfg, 2, 64, cursor=1)
    jlogits, _ = jax.jit(lambda p, t: jax_forward(p, cfg, {"tokens": t}))(
        jp, jnp.asarray(b["tokens"]))
    tlogits, none = forward(tp, cfg, {"tokens": torch.from_numpy(b["tokens"])})
    assert none is None and tlogits.dtype == getattr(torch, dtype)
    check(tlogits, jlogits, cfg, "logits")
    jloss, _ = jax.jit(lambda p, b: jax_lm_loss(p, cfg, b))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, _ = lm_loss(tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    # relative 1e-5 in float32, 2e-2 in bf16 (tests/test_torch_model.py)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_forward_with_patches_and_mrope_grids_matches_jax(dtype):
    cfg = reduced(VLM, dtype)
    jp, tp = both(cfg)
    b = vlm_batch(cfg, 2, 16, seed=2)
    want, _ = jax.jit(lambda p, b: jax_forward(p, cfg, b))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    got, _ = forward(tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    check(got, want, cfg, "logits")
    # the patches and the grids both reach the result
    plain, _ = forward(tp, cfg, {"tokens": torch.from_numpy(b["tokens"])})
    assert not torch.equal(plain[:, :4], got[:, :4])


def test_hybrid_prefill_step_matches_jax():
    cfg = reduced(HYBRID)
    jp, tp = both(cfg)
    toks = tokens(cfg, 6, (2, 40))
    want = jax_build_prefill_step(cfg)(jp, {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, cfg.padded_vocab)
    assert_within_ulps(got, want, "prefill logits")


# ------------------------------------------------------------------ decode

def decode_both(cfg, jp, tp, toks):
    """Both packages step ``toks`` through decode from fresh caches: the
    logits of every step and the flat caches after the last."""
    B, n = toks.shape
    step = jax.jit(lambda p, t, c, pos: jax_decode_step(p, cfg, t, c, pos))
    jc = jax_init_caches(cfg, B, n)
    tc = init_caches(cfg, B, n, device="cpu")
    jl, tl = [], []
    for t in range(n):
        out, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        jl.append(np.asarray(out, dtype=np.float32))
        with torch.inference_mode():
            got, tc2 = decode_step(tp, cfg, torch.from_numpy(
                toks[:, t:t + 1]), tc, t)
        assert tc2 is tc
        tl.append(got)
    return jl, tl, jax_flatten(jc), flatten_state(tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_decode_past_the_window_matches_jax(dtype):
    """Window 8, rings of 8 slots, 24 steps: the rings wrap twice. Every
    step's logits and, after the last, every cache and state leaf; the
    ring's ``pos`` equal."""
    cfg = reduced(HYBRID, dtype, window=8)
    jp, tp = both(cfg)
    jl, tl, jc, tc = decode_both(cfg, jp, tp, tokens(cfg, 0, (2, 24)))
    for t, (want, got) in enumerate(zip(jl, tl)):
        check(got, want, cfg, f"step {t}")
    assert list(tc) == list(jc)
    assert tc["seg0/b2/k"].shape[2] == 8
    for k in jc:
        if k.endswith("/pos"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            check(tc[k], jc[k], cfg, k)


def test_hybrid_decode_equals_the_full_forward_with_the_ring_wrapped():
    """The reference's check (``tests/test_models_smoke.py``), with more
    decode steps than the window: 24 steps through rings of 8 against
    the full causal forward (its band route: 24 % 8 == 0), and 20 steps
    against the masked route (20 % 8 != 0). Both segments at 5 layers."""
    cfg = dataclasses.replace(get_reduced(HYBRID), dtype="float32",
                              window=8, num_layers=5)
    assert len(cfg.segments) == 2
    params = init_params(cfg, 2, device="cpu")
    for n in (24, 20):
        toks = torch.from_numpy(tokens(cfg, 3, (2, n)))
        with torch.inference_mode():
            full, _ = forward(params, cfg, {"tokens": toks})
            caches = init_caches(cfg, 2, n, device="cpu")
            outs = [decode_step(params, cfg, toks[:, t:t + 1], caches, t)[0]
                    for t in range(n)]
        torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-4,
                                   atol=2e-4)


def test_vlm_decode_matches_jax():
    """M-RoPE at decode: ``cache_pos`` on all three rows."""
    cfg = reduced(VLM)
    jp, tp = both(cfg)
    jl, tl, jc, tc = decode_both(cfg, jp, tp, tokens(cfg, 1, (2, 8)))
    for t, (want, got) in enumerate(zip(jl, tl)):
        assert_within_ulps(got, want, f"step {t}")
    for k in jc:
        check(tc[k], jc[k], cfg, k)


@pytest.mark.parametrize("arch,dtype,window,prompt,gen", [
    (HYBRID, "float32", 8, 8, 10),
    (HYBRID, "bfloat16", 32, 32, 8),
    (VLM, "bfloat16", 0, 8, 6),
])
def test_serve_batch_greedy_tokens_are_jax_tokens(arch, dtype, window,
                                                  prompt, gen):
    """The hybrid's rings wrap in both cases: window 8 under 18
    positions, and the reduced window 32 under 40."""
    cfg = reduced(arch, dtype, **({"window": window} if window else {}))
    jp, tp = both(cfg)
    prompts = jax_synthetic_batch(cfg, 2, prompt, cursor=0)["tokens"]
    want, _ = jax_serve_batch(cfg, jp, jnp.asarray(prompts), gen)
    got, tps = serve_batch(cfg, tp, torch.from_numpy(prompts), gen)
    assert got.shape == (2, gen) and tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
