"""The encoder-decoder (whisper-large-v3) in the port against the JAX
package: cross attention (from the encoder's output, from the cross
cache, and through the flash route), the encoder, forward and loss with
frames, the first serving step writing the cross caches in place, decode
against the full forward, greedy serving with frames and the full-size
tree (the gradients and checkpoints are in
``tests/test_torch_ssm_audio_train.py``).

Parameters come from the JAX ``init_params`` of the reduced configuration
and cross to the port as bytes; inputs are drawn with numpy from a seed.
Tolerances: float32 within 1e-5; decode against the full forward within
the reference's own 2e-4 (``tests/test_models_smoke.py``); bf16 outputs,
logits and caches within 4 bf16 ulps of their largest value, and greedy
tokens equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.launch.train import flatten_state as jax_flatten
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models.model import encode as jax_encode
import repro_torch.models.attention as attn
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import serve_batch
from repro_torch.models import (decode_step, encode, forward, init_caches,
                                init_params, lm_loss)
from repro_torch.persistence.state import (flatten_state, from_numpy,
                                           trainer_state, unflatten_state)

ARCH = "whisper-large-v3"
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


def as_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def reduced(dtype: str = "bfloat16", **kw):
    return dataclasses.replace(jax_get_reduced(ARCH), dtype=dtype, **kw)


def both(cfg, seed: int = 0):
    """The JAX parameters and the same bytes as the port's tree."""
    jp = jax_init_params(cfg, jax.random.key(seed))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    return jp, tp


def frames(cfg, B: int, T: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


# ---------------------------------------------------------- cross attention

def xattn_both(cfg, S: int, T: int, seed: int = 0):
    """One cross-attention layer's leaves on both sides, queries (B, S, D)
    and an encoder output (B, T, D), in the model's dtype."""
    jp = jattn.gqa_init(jax.random.key(seed), cfg, dtype=jnp.dtype(cfg.dtype))
    tp = unflatten_state(from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jp).items()}, "cpu"))
    rng = np.random.default_rng(seed + 1)
    x, kv = (rng.standard_normal((1, n, cfg.d_model)).astype(np.float32)
             for n in (S, T))
    jx, jkv = (jnp.asarray(a).astype(jnp.dtype(cfg.dtype)) for a in (x, kv))
    tx, tkv = (torch.from_numpy(a).to(getattr(torch, cfg.dtype))
               for a in (x, kv))
    return jp, tp, (jx, jkv), (tx, tkv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_from_the_encoder_and_from_the_cache(dtype):
    """From ``kv_input`` (no RoPE, no mask: the positions are ignored),
    then from the ``{"k", "v"}`` it returned, which must give the same
    output; the dense route (``max(S, T) <= FLASH_THRESHOLD``)."""
    cfg = reduced(dtype)
    jp, tp, (jx, jkv), (tx, tkv) = xattn_both(cfg, 6, 40)
    jpos = jnp.zeros((1, 6), jnp.int32)
    want, wkv = jax.jit(lambda p, x, kv: jattn.gqa_apply(
        p, x, cfg=cfg, positions=jpos, cross=True, kv_input=kv))(jp, jx, jkv)
    got, gkv = attn.gqa_apply(tp, tx, cfg=cfg, positions=torch.zeros(
        1, 6, dtype=torch.int32), cross=True, kv_input=tkv)
    check(got.float(), as_f32(want), dtype, "out from kv_input")
    for k in ("k", "v"):
        check(gkv[k].float(), as_f32(wkv[k]), dtype, k)
    assert tuple(gkv["k"].shape) == (1, 40, cfg.padded_kv_heads,
                                     cfg.raw_head_dim)
    # from the cache: no kv_input, no cache_pos
    cache = {k: v.clone() for k, v in gkv.items()}
    want2, _ = jax.jit(lambda p, x, c: jattn.gqa_apply(
        p, x, cfg=cfg, positions=jpos, cross=True, cache=c))(jp, jx, wkv)
    got2, same = attn.gqa_apply(tp, tx, cfg=cfg, positions=torch.zeros(
        1, 6, dtype=torch.int32), cross=True, cache=cache)
    assert same is cache
    check(got2.float(), as_f32(want2), dtype, "out from the cache")
    torch.testing.assert_close(got2, got, rtol=0, atol=0)


def test_cross_attention_takes_flash_beyond_the_threshold():
    """1 x 4 queries over 2,304 keys at head dim 16: ``T >
    FLASH_THRESHOLD`` takes the online softmax over 1,024-key chunks (one
    chunk of 2,304, as 1,024 does not divide it) in both packages,
    against JAX and against the port's dense route forced."""
    cfg = reduced("float32", d_model=64, num_heads=4, num_kv_heads=4,
                  head_dim=16)
    jp, tp, (jx, jkv), (tx, tkv) = xattn_both(cfg, 4, 2304)
    assert 2304 > attn.FLASH_THRESHOLD == jattn.FLASH_THRESHOLD
    want, _ = jax.jit(lambda p, x, kv: jattn.gqa_apply(
        p, x, cfg=cfg, positions=jnp.zeros((1, 4), jnp.int32), cross=True,
        kv_input=kv))(jp, jx, jkv)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    calls = []
    flash = attn._attend_flash

    def spy(*a, **kw):
        calls.append(kw)
        return flash(*a, **kw)

    attn._attend_flash = spy
    try:
        got, _ = attn.gqa_apply(tp, tx, cfg=cfg, positions=pos, cross=True,
                                kv_input=tkv)
    finally:
        attn._attend_flash = flash
    assert [c["causal"] for c in calls] == [False]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    threshold = attn.FLASH_THRESHOLD
    attn.FLASH_THRESHOLD = 4096
    try:
        dense, _ = attn.gqa_apply(tp, tx, cfg=cfg, positions=pos, cross=True,
                                  kv_input=tkv)
    finally:
        attn.FLASH_THRESHOLD = threshold
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32)


# ----------------------------------------------------------------- encoder

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    """The two bidirectional encoder layers (RoPE at arange(S_enc)) and
    ``enc_norm`` over 40 frames."""
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    fr = frames(cfg, 2, 40, seed=4)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda p, f: jax_encode(p, cfg, f.astype(jd)))(
        jp, jnp.asarray(fr))
    got = encode(tp, cfg, torch.from_numpy(fr).to(td))
    assert got.dtype == td
    check(got.float(), as_f32(want), dtype, "encoder output")


# ------------------------------------------------------------------- model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_forward_and_loss_with_frames_match_jax(dtype):
    """The synthetic batch's frames (as many as the sequence's tokens, as
    in the reference) through the encoder and every ``xattn`` block."""
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    b = jax_synthetic_batch(cfg, 2, 48, cursor=1)
    assert b["frames"].shape == (2, 48, cfg.d_model)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want, _ = jax.jit(lambda p, b: jax_forward(p, cfg, b))(jp, jb)
    got, none = forward(tp, cfg, tb)
    assert none is None and got.dtype == getattr(torch, dtype)
    check(got.float(), as_f32(want), dtype, "logits")
    jloss, _ = jax.jit(lambda p, b: jax_lm_loss(p, cfg, b))(jp, jb)
    tloss, _ = lm_loss(tp, cfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    # the frames reach the result
    other = dict(tb, frames=tb["frames"] * 2)
    assert not torch.equal(forward(tp, cfg, other)[0], got)


def first_step_both(cfg, jp, tp, toks, fr):
    """Serving's first step on both sides: ``forward`` of the first token
    with the frames at position 0 into fresh caches."""
    B = toks.shape[0]
    jc = jax_init_caches(cfg, B, toks.shape[1], enc_len=fr.shape[1])
    tc = init_caches(cfg, B, toks.shape[1], fr.shape[1], device="cpu")
    jl, jc = jax.jit(lambda p, t, f, c: jax_forward(
        p, cfg, {"tokens": t, "frames": f}, caches=c,
        cache_pos=jnp.int32(0)))(jp, jnp.asarray(toks[:, :1]),
                                 jnp.asarray(fr), jc)
    with torch.inference_mode():
        tl, tc2 = forward(tp, cfg, {"tokens": torch.from_numpy(toks[:, :1]),
                                    "frames": torch.from_numpy(fr)},
                          caches=tc, cache_pos=0)
    return jl, jc, tl, tc, tc2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_step_writes_the_cross_caches_in_place(dtype):
    """Every layer's cross ``{k, v}`` (the encoder's output through the
    layer's ``wk``/``wv``) and self cache slot 0, written into the tensors
    ``init_caches`` made; the same tree is returned."""
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    toks, fr = tokens(cfg, 1, (2, 8)), frames(cfg, 2, 20, seed=2)
    jl, jc, tl, tc, tc2 = first_step_both(cfg, jp, tp, toks, fr)
    assert tc2 is tc
    leaves = flatten_state(tc)
    assert sorted(leaves) == ["seg0/b0/cross/k", "seg0/b0/cross/v",
                              "seg0/b0/self/k", "seg0/b0/self/pos",
                              "seg0/b0/self/v"]
    assert tuple(leaves["seg0/b0/cross/k"].shape) == (
        cfg.num_layers, 2, 20, cfg.padded_kv_heads, cfg.raw_head_dim)
    assert leaves["seg0/b0/cross/k"].abs().amax(dim=(1, 2, 3, 4)).min() > 0
    check(tl.float(), as_f32(jl), dtype, "logits")
    want = jax_flatten(jc)
    for k, v in leaves.items():
        if k.endswith("/pos"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        else:
            check(v.float(), as_f32(want[k]), dtype, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_with_the_cross_caches_matches_jax(dtype):
    """After the first step, 11 decode steps without frames on both
    sides: every step's logits and, after the last, every cache leaf."""
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    toks, fr = tokens(cfg, 3, (2, 12)), frames(cfg, 2, 20, seed=5)
    _, jc, _, tc, _ = first_step_both(cfg, jp, tp, toks, fr)
    step = jax.jit(lambda p, t, c, pos: jax_decode_step(p, cfg, t, c, pos))
    for t in range(1, 12):
        want, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        with torch.inference_mode():
            got, tc = decode_step(tp, cfg, torch.from_numpy(
                toks[:, t:t + 1]), tc, t)
        check(got.float(), as_f32(want), dtype, f"step {t}")
    want = jax_flatten(jc)
    for k, v in flatten_state(tc).items():
        if k.endswith("/pos"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        else:
            check(v.float(), as_f32(want[k]), dtype, k)


def test_decode_equals_the_full_forward_with_frames():
    """The reference's check (``tests/test_models_smoke.py``) for the
    encoder-decoder: the first step with the frames, then 15 decode steps
    from the cross caches, against one forward over the 16 tokens with
    the same frames, within 2e-4 in float32."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32")
    params = init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 4, (2, 16)))
    fr = torch.from_numpy(frames(cfg, 2, 24, seed=6))
    with torch.inference_mode():
        full, _ = forward(params, cfg, {"tokens": toks, "frames": fr})
        caches = init_caches(cfg, 2, 16, 24, device="cpu")
        outs = [forward(params, cfg, {"tokens": toks[:, :1], "frames": fr},
                        caches=caches, cache_pos=0)[0]]
        outs += [decode_step(params, cfg, toks[:, t:t + 1], caches, t)[0]
                 for t in range(1, 16)]
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype,prompt,gen", [("float32", 8, 10),
                                              ("bfloat16", 16, 8),
                                              ("bfloat16", 1, 4)])
def test_serve_batch_with_frames_gives_jax_tokens(dtype, prompt, gen):
    """The synthetic batch's frames, as the CLIs pass them; a one-token
    prompt is the first step alone."""
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    b = jax_synthetic_batch(cfg, 2, prompt, cursor=0)
    want, _ = jax_serve_batch(cfg, jp, jnp.asarray(b["tokens"]), gen,
                              {"frames": jnp.asarray(b["frames"])})
    got, tps = serve_batch(cfg, tp, torch.from_numpy(b["tokens"]), gen,
                           {"frames": torch.from_numpy(b["frames"])})
    assert got.shape == (2, gen) and tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- configuration

def fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def test_full_size_tree_on_meta_is_the_reference():
    """whisper-large-v3: 32 ``xattn`` and 32 ``enc`` layers, 20 heads
    padded to 32, head dim 64, d_ff 5,120, vocab padded to 51,968, untied:
    1,978,739,200 parameters in 25 leaves (3,957,478,400 B in bf16);
    ``encoder/seg0/b0/attn/wq`` and ``enc_norm`` as the reference names
    them."""
    assert fields(get_config(ARCH)) == fields(jax_get_config(ARCH))
    assert fields(get_reduced(ARCH)) == fields(jax_get_reduced(ARCH))
    cfg = get_config(ARCH)
    abstract = jax.eval_shape(lambda k: jax_init_params(jax_get_config(ARCH),
                                                        k),
                              jax.random.key(0))
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = flatten_state(init_params(cfg, device="meta"))
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype) == f"torch.{want[k].dtype}", k
    assert len(got) == 25
    assert sum(t.numel() for t in got.values()) == 1_978_739_200
    assert tuple(got["encoder/seg0/b0/attn/wq"].shape) == (32, 1280, 2048)
    assert tuple(got["enc_norm"].shape) == (1280,)
    assert [(s.pattern, s.repeat) for s in cfg.segments] == [(("xattn",), 32)]
    assert [(s.pattern, s.repeat) for s in cfg.encoder_segments] == [
        (("enc",), 32)]
    c = flatten_state(init_caches(cfg, 8, 256, 1500, device="meta"))
    assert tuple(c["seg0/b0/cross/k"].shape) == (32, 8, 1500, 32, 64)
    assert tuple(c["seg0/b0/self/k"].shape) == (32, 8, 256, 32, 64)

