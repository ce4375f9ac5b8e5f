"""The Mamba2 SSD block and mamba2-130m in the port against the JAX
package: the chunked scan (one chunk and several, with and without an
incoming state), the decode step, the inter-chunk tree, softplus, the
refused lengths, forward and loss, serving and the full-size tree (the
gradients and the trainer are in ``tests/test_torch_ssm_audio_train.py``).

Parameters come from the JAX ``init_params``/``ssd_init`` of the reduced
configuration and cross to the port as bytes; inputs are drawn with numpy
from a seed. Tolerances: float32 within 1e-5 (relative, and absolute at
the largest value's scale: the scan's float32 prefix sums, in
``torch.cumsum`` and ``jnp.cumsum``, add in different orders);
decode against the chunked forward within the reference's own 2e-4
(``tests/test_models_smoke.py``); bf16 outputs and logits within 4 bf16
ulps of their largest value, and greedy tokens equal.
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
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models import ssd as jssd
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, lm_loss)
from repro_torch.models import rglru, ssd
from repro_torch.models.layers import softplus
from repro_torch.persistence.state import (flatten_state, from_numpy,
                                           trainer_state, unflatten_state)

ARCH = "mamba2-130m"
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
        want = np.asarray(want)
        # relative to the largest value: the scan's float32 sums
        np.testing.assert_allclose(got.numpy(), want, rtol=F32["rtol"],
                                   atol=F32["atol"] * max(
                                       1.0, float(np.abs(want).max())),
                                   err_msg=what)
    else:
        assert_within_ulps(got, want, what)


def reduced(dtype: str = "bfloat16", **kw):
    return dataclasses.replace(jax_get_reduced(ARCH), dtype=dtype, **kw)


def both(cfg, seed: int = 0):
    """The JAX parameters and the same bytes as the port's tree."""
    jp = jax_init_params(cfg, jax.random.key(seed))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    return jp, tp


def block(cfg, seed: int = 0):
    jp = jssd.ssd_init(jax.random.key(seed), cfg,
                       dtype=jnp.dtype(cfg.dtype))
    tp = unflatten_state(from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jp).items()}, "cpu"))
    return jp, tp


def states(cfg, rng, B: int):
    """A random incoming state, as numpy (h float32, conv in the model's
    dtype, rounded)."""
    H, P, di, N = cfg.padded_ssm_heads, cfg.ssm_head_dim, \
        cfg.padded_ssm_heads * cfg.ssm_head_dim, cfg.ssm_state
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.conv_kernel - 1,
                                di + 2 * N)).astype(np.float32)
    conv = np.asarray(jnp.asarray(conv).astype(jnp.dtype(cfg.dtype))
                      .astype(jnp.float32))
    return h, conv


def apply_both(cfg, S: int, stateful: bool, seed: int = 0):
    """One ssd_apply on each side: (JAX y and state, port y, port state,
    the port's state dict given)."""
    jp, tp = block(cfg)
    dt = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed + S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jst = tst = None
    if stateful:
        h, conv = states(cfg, rng, 2)
        jst = {"h": jnp.asarray(h),
               "conv": jnp.asarray(conv).astype(jnp.dtype(cfg.dtype))}
        tst = {"h": torch.from_numpy(h.copy()),
               "conv": torch.from_numpy(conv.copy()).to(dt)}
    wy, wst = jax.jit(lambda p, x, st: jssd.ssd_apply(
        p, x, cfg=cfg, state=st))(jp, jnp.asarray(x).astype(
            jnp.dtype(cfg.dtype)), jst)
    gy, gst = ssd.ssd_apply(tp, torch.from_numpy(x).to(dt), cfg=cfg,
                            state=tst)
    return (np.asarray(wy.astype(jnp.float32)),
            {k: np.asarray(v.astype(jnp.float32)) for k, v in wst.items()},
            gy, gst, tst)


# ----------------------------------------------------------- the SSD block

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 48])
def test_chunked_scan_without_a_state_matches_jax(S, dtype):
    """One chunk (16, the reduced chunk) and three."""
    cfg = reduced(dtype)
    assert cfg.chunk == 16
    wy, wst, gy, gst, _ = apply_both(cfg, S, stateful=False)
    check(gy.float(), wy, dtype, "y")
    check(gst["h"], wst["h"], "float32", "h")
    assert gst["h"].dtype == torch.float32
    check(gst["conv"].float(), wst["conv"], dtype, "conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_scan_from_an_incoming_state_matches_jax(dtype):
    """``h0`` enters through ``cumprod(decay_chunk) * h0`` and the first
    chunk's ``prev``; the conv continues from the given taps. The state
    dict given is updated in place and returned."""
    cfg = reduced(dtype)
    wy, wst, gy, gst, tst = apply_both(cfg, 48, stateful=True)
    assert gst is tst
    check(gy.float(), wy, dtype, "y")
    check(gst["h"], wst["h"], "float32", "h")
    check(gst["conv"].float(), wst["conv"], dtype, "conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_updates_the_state_in_place_as_jax_does(dtype):
    """One token against a random state: the dict given comes back with
    its own ``h`` and ``conv`` tensors overwritten."""
    cfg = reduced(dtype)
    rng = np.random.default_rng(1)           # apply_both's draws at S = 1
    rng.standard_normal((2, 1, cfg.d_model))
    h_in = states(cfg, rng, 2)[0]
    wy, wst, gy, gst, tst = apply_both(cfg, 1, stateful=True)
    assert gst is tst
    h, conv = tst["h"], tst["conv"]
    assert gst["h"] is h and gst["conv"] is conv
    assert not np.array_equal(h.numpy(), h_in)
    check(gy.float(), wy, dtype, "y")
    check(gst["h"], wst["h"], "float32", "h")
    check(gst["conv"].float(), wst["conv"], dtype, "conv")


def test_decode_steps_equal_the_chunked_scan_over_three_chunks():
    """48 tokens (three chunks of 16) one at a time from a zero state
    against one chunked call: outputs and final state within 2e-4."""
    cfg = reduced("float32")
    _, tp = block(cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32))
    full, fst = ssd.ssd_apply(tp, x, cfg=cfg)
    st = ssd.ssd_state_init(cfg, 2, torch.float32, device="cpu")
    outs = [ssd.ssd_apply(tp, x[:, t:t + 1], cfg=cfg, state=st)[0]
            for t in range(48)]
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-4,
                               atol=2e-4)
    for k in ("h", "conv"):
        torch.testing.assert_close(st[k], fst[k], rtol=2e-4, atol=2e-4)


def test_a_steep_chunk_decay_stays_finite_where_the_reference_is_nan():
    """A fault of the reference, repaired in the port: ``dt_bias`` raised
    to 4 makes ``dt ~ 4`` and a chunk's summed decay ``|cum|`` reach
    hundreds; the reference's ``exp(cum_q - cum_t) * causal`` overflows
    above the diagonal and ``inf * 0`` gives NaN, while the port masks
    before the exponent. Its chunked output equals the token-by-token
    recurrence (the decode step, which has no such product) within
    2e-4, and it is the reference's wherever the reference is finite
    (the tests above)."""
    cfg = reduced("float32")
    jp, tp = block(cfg)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 4.0))
    tp = dict(tp, dt_bias=torch.full_like(tp["dt_bias"], 4.0))
    x = np.random.default_rng(7).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jssd.ssd_apply(p, x, cfg=cfg))(
        jp, jnp.asarray(x))
    assert np.isnan(np.asarray(want)).any()
    got, _ = ssd.ssd_apply(tp, torch.from_numpy(x), cfg=cfg)
    assert torch.isfinite(got).all()
    st = ssd.ssd_state_init(cfg, 2, torch.float32, device="cpu")
    steps = [ssd.ssd_apply(tp, torch.from_numpy(x[:, t:t + 1]), cfg=cfg,
                           state=st)[0] for t in range(32)]
    torch.testing.assert_close(got, torch.cat(steps, dim=1), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("n", [1, 3, 4, 16])
def test_inter_chunk_scan_is_the_reference_tree(n):
    """The port's odd/even tree with the decay broadcast as (B, c, H, 1,
    1) against ``jax.lax.associative_scan`` of the reference's
    ``combine``: bit for bit (XLA fuses ``sl * ar + sr`` into one
    multiply-add, as ``torch.addcmul`` computes it)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 4)).astype(np.float32)
    s = rng.standard_normal((2, n, 4, 3, 5)).astype(np.float32)

    def combine(l, r):
        al, sl = l
        ar, sr = r
        return al * ar, sl * ar[..., None, None] + sr

    wa, ws = jax.jit(lambda a, s: jax.lax.associative_scan(
        combine, (a, s), axis=1))(jnp.asarray(a), jnp.asarray(s))
    ga, gs = rglru.associative_scan(torch.from_numpy(a)[..., None, None],
                                    torch.from_numpy(s))
    np.testing.assert_array_equal(ga[..., 0, 0].numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_softplus_is_jax_softplus_in_both_tails():
    """``logaddexp(x, 0)`` as the reference computes it, above 20 (where
    ``F.softplus`` returns ``x``) bit for bit, and below -20 (where it is
    ``exp(x)``, down to 1e-26) within 1e-6 relative: XLA's ``exp`` and
    ``log1p`` differ from torch's in the last bit."""
    x = np.concatenate([np.linspace(-60, 60, 241),
                        [-20.5, -20.0, 20.0, 20.5, 25.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    hi, lo = x > 20, x < -20
    assert hi.any() and lo.any() and (got[lo] > 0).all()
    np.testing.assert_array_equal(got[hi], want[hi])


def test_a_length_not_a_multiple_of_the_chunk_is_refused():
    """24 tokens over chunks of 16: both packages refuse (the reference
    asserts), neither pads."""
    cfg = reduced("float32")
    jp, tp = block(cfg)
    x = np.zeros((1, 24, cfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        jssd.ssd_apply(jp, jnp.asarray(x), cfg=cfg)
    with pytest.raises(ValueError, match="not divisible"):
        ssd.ssd_apply(tp, torch.from_numpy(x), cfg=cfg)
    # shorter than a chunk is one chunk of its own length
    ssd.ssd_apply(tp, torch.from_numpy(x[:, :12]), cfg=cfg)


# ------------------------------------------------------------------- model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_loss_match_jax(dtype):
    """64 tokens: four chunks in each of the 4 layers; tied embeddings."""
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    assert "head" not in tp
    b = jax_synthetic_batch(cfg, 2, 64, cursor=1)
    jlogits, _ = jax.jit(lambda p, t: jax_forward(p, cfg, {"tokens": t}))(
        jp, jnp.asarray(b["tokens"]))
    tlogits, none = forward(tp, cfg, {"tokens": torch.from_numpy(b["tokens"])})
    assert none is None and tlogits.dtype == getattr(torch, dtype)
    check(tlogits, jlogits, dtype, "logits")
    jloss, _ = jax.jit(lambda p, b: jax_lm_loss(p, cfg, b))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, _ = lm_loss(tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    # relative 1e-5 in float32, 2e-2 in bf16 (tests/test_torch_model.py)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 2e-2)


def test_mamba2_prefill_step_matches_jax():
    cfg = reduced()
    jp, tp = both(cfg)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want = jax_build_prefill_step(cfg)(jp, {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, cfg.padded_vocab)
    assert_within_ulps(got, want, "prefill logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax_and_its_chunked_forward(dtype):
    """Both packages step 32 tokens through decode from zero states: every
    step's logits and the states after the last against JAX's; in
    float32 also against the port's chunked forward over the 32 tokens
    (two chunks), within 2e-4."""
    from repro.models import decode_step as jax_decode_step
    from repro.models import init_caches as jax_init_caches
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    step = jax.jit(lambda p, t, c, pos: jax_decode_step(p, cfg, t, c, pos))
    jc = jax_init_caches(cfg, 2, 32)
    tc = init_caches(cfg, 2, 32, device="cpu")
    assert sorted(flatten_state(tc)) == ["seg0/b0/conv", "seg0/b0/h"]
    assert tc["seg0"]["b0"]["h"].dtype == torch.float32
    outs = []
    with torch.inference_mode():
        for t in range(32):
            want, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                            jnp.int32(t))
            got, tc2 = decode_step(tp, cfg, torch.from_numpy(
                toks[:, t:t + 1]), tc, t)
            assert tc2 is tc
            check(got.float(), np.asarray(want.astype(jnp.float32)), dtype,
                  f"step {t}")
            outs.append(got)
        full, _ = forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    # the float32 h of a bf16 model carries its bf16 inputs' roundings:
    # it is held as the bf16 leaves are, to 4 bf16 ulps of its largest
    jflat = jax_flatten(jc)
    for k, v in flatten_state(tc).items():
        check(v.float(), np.asarray(jflat[k].astype(jnp.float32)), dtype, k)
    if dtype == "float32":
        torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("dtype,prompt,gen", [("float32", 16, 10),
                                              ("bfloat16", 32, 8)])
def test_serve_batch_greedy_tokens_are_jax_tokens(dtype, prompt, gen):
    cfg = reduced(dtype)
    jp, tp = both(cfg)
    prompts = jax_synthetic_batch(cfg, 2, prompt, cursor=0)["tokens"]
    want, _ = jax_serve_batch(cfg, jp, jnp.asarray(prompts), gen)
    got, tps = serve_batch(cfg, tp, torch.from_numpy(prompts), gen)
    assert got.shape == (2, gen) and tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- configuration

def fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def test_full_size_tree_on_meta_is_the_reference():
    """mamba2-130m: 24 ssd layers, 24 heads padded to 32, d_inner 2,048,
    state 128, vocab padded to 50,432, tied: 157,633,536 parameters in 11
    leaves, 315,271,680 B (A_log, D_skip and dt_bias float32)."""
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
    assert len(got) == 11
    assert sum(t.numel() for t in got.values()) == 157_633_536
    assert sum(t.numel() * t.element_size() for t in got.values()) \
        == 315_271_680
    assert {k.rsplit("/", 1)[1] for k, t in got.items()
            if t.dtype == torch.float32} == {"A_log", "D_skip", "dt_bias"}
    assert [(s.pattern, s.repeat) for s in cfg.segments] == [(("ssd",), 24)]
    assert (cfg.padded_ssm_heads, cfg.padded_vocab) == (32, 50_432)
    st = flatten_state(init_caches(cfg, 8, 16, device="meta"))
    assert tuple(st["seg0/b0/h"].shape) == (24, 8, 32, 64, 128)
    assert tuple(st["seg0/b0/conv"].shape) == (24, 8, 3, 2_304)
