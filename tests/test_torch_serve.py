"""The port's serving path (``repro_torch.launch.serve``, decode caches)
against the JAX package's.

Parameters come from the JAX ``init_params(get_reduced("tinyllama-1.1b"))``
and cross to the port as bytes (``trainer_state``); tokens are drawn
with numpy from a seed. Both sides decode in bf16, so logits are held
within 4 bf16 ulps of the largest logit, the bound of
``tests/test_torch_model.py``, and the caches within 4 ulps of their
largest value; in float32 the two decodes agree to 1e-5. The ``pos``
leaves and the greedy tokens must be equal. The four dense architectures' configurations are held
against the reference's, full and reduced.
"""

import dataclasses
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.launch.steps import build_prefill_step as jax_build_prefill_step
from repro.launch.steps import build_serve_step as jax_build_serve_step
from repro.launch.train import flatten_state as jax_flatten
from repro.models import decode_step as jax_decode_step
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import decode_step, forward, init_caches, init_params
from repro_torch.persistence.state import flatten_state, trainer_state

ARCH = "tinyllama-1.1b"
DENSE = ["tinyllama-1.1b", "stablelm-12b", "codeqwen1.5-7b",
         "deepseek-coder-33b"]
B, N = 2, 12


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def assert_within_ulps(got: torch.Tensor, want, what: str,
                       ulps: int = 4) -> None:
    """``got`` within ``ulps`` bf16 ulps of the largest ``|want|``."""
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= ulps * bf16_ulp(np.max(np.abs(want))), (what, err)


def tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_reduced(ARCH)
    jp = jax_init_params(cfg, jax.random.key(0))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    return cfg, jp, tp


def jax_step(cfg):
    return jax.jit(lambda p, t, c, pos: jax_decode_step(p, cfg, t, c, pos))


@pytest.fixture(scope="module")
def decoded(setup):
    """Both packages step the same 12 tokens through decode from fresh
    caches: the logits of every step and the caches after the last."""
    cfg, jp, tp = setup
    toks = tokens(cfg, 0, (B, N))
    step = jax_step(cfg)
    jc = jax_init_caches(cfg, B, N)
    tc = init_caches(cfg, B, N, device="cpu")
    jl, tl = [], []
    for t in range(N):
        out, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        jl.append(np.asarray(out, dtype=np.float32))
        with torch.inference_mode():
            got, tc2 = decode_step(tp, cfg, torch.from_numpy(toks[:, t:t + 1]),
                                   tc, t)
        assert tc2 is tc            # written in place, the same tree back
        tl.append(got)
    return jl, tl, jax_flatten(jc), flatten_state(tc)


def test_decode_logits_match_jax(decoded):
    jl, tl, _, _ = decoded
    for t, (want, got) in enumerate(zip(jl, tl)):
        assert got.dtype == torch.bfloat16
        assert_within_ulps(got, want, f"step {t}")


@pytest.mark.parametrize("leaf", ["k", "v", "pos"])
def test_decode_caches_match_jax(decoded, leaf):
    """The caches after 12 steps. Layers 0 and 1 are equal bit for bit,
    which pins the port's roundings to the compiled reference's (the
    SiLU op by op, the second norm on the float32 sum); later layers
    inherit float32 sums whose order differs between the packages
    (matrix products, norms), so they are held within 4 ulps of the
    leaf's largest value. The float32 decode (:func:`test_float32_decode_matches_jax`)
    holds the same math to 1e-5."""
    _, _, jc, tc = decoded
    keys = [k for k in jc if k.endswith("/" + leaf)]
    assert keys and [k for k in tc if k.endswith("/" + leaf)] == keys
    for k in keys:
        if leaf == "pos":
            assert tc[k].dtype == torch.int32
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            for layer in (0, 1):
                assert torch.equal(tc[k][layer].float(), torch.from_numpy(
                    np.asarray(jc[k][layer], np.float32))), (k, layer)
            assert_within_ulps(tc[k], jc[k], k)


def test_float32_decode_matches_jax():
    """In float32 the port's decode is the reference's to 1e-5: logits at
    every step and the caches after them."""
    cfg = dataclasses.replace(jax_get_reduced(ARCH), dtype="float32")
    jp = jax_init_params(cfg, jax.random.key(0))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    toks = tokens(cfg, 0, (B, N))
    step = jax_step(cfg)
    jc = jax_init_caches(cfg, B, N)
    tc = init_caches(cfg, B, N, device="cpu")
    for t in range(N):
        want, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        with torch.inference_mode():
            got, _ = decode_step(tp, cfg, torch.from_numpy(toks[:, t:t + 1]),
                                 tc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    jc, tc = jax_flatten(jc), flatten_state(tc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_init_caches_is_the_reference_tree(setup):
    cfg, _, _ = setup
    want = jax_flatten(jax_init_caches(cfg, 3, 7))
    got = flatten_state(init_caches(cfg, 3, 7, device="cpu"))
    assert list(got) == list(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype) == f"torch.{want[k].dtype}", k
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want[k], dtype=np.float32))


T = 4


@pytest.mark.parametrize("s,last_pos", [(1, T - 1), (1, T), (1, T + 3),
                                        (3, 2)])
def test_cache_write_clamps_as_jax_does(setup, s, last_pos):
    """A cache of T slots: T - 1 single steps, then ``s`` tokens at
    ``last_pos``. ``dynamic_update_slice`` clamps the write's start to
    ``[0, T - s]``, while RoPE and the mask take ``last_pos`` as given."""
    cfg, jp, tp = setup
    toks = tokens(cfg, 1, (B, T - 1 + s))
    jc = jax_init_caches(cfg, B, T)
    tc = init_caches(cfg, B, T, device="cpu")
    for t in range(T - 1):
        _, jc = jax_decode_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc,
                                jnp.int32(t))
        with torch.inference_mode():
            decode_step(tp, cfg, torch.from_numpy(toks[:, t:t + 1]), tc, t)
    last = toks[:, T - 1:]
    jout, jc = jax_decode_step(jp, cfg, jnp.asarray(last), jc,
                               jnp.int32(last_pos))
    with torch.inference_mode():
        tout, tc = decode_step(tp, cfg, torch.from_numpy(last), tc,
                               last_pos)
    assert_within_ulps(tout, jout, "logits")
    jc, tc = jax_flatten(jc), flatten_state(tc)
    for k in jc:
        if k.endswith("/pos"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            assert_within_ulps(tc[k], jc[k], k)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_full_forward_in_float32(arch):
    """Stepping tokens through the caches gives the full causal forward's
    logits (the reference's check, ``tests/test_models_smoke.py``)."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = init_params(cfg, 2, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 3, (B, N)))
    with torch.inference_mode():
        full, none = forward(params, cfg, {"tokens": toks})
        caches = init_caches(cfg, B, N, device="cpu")
        outs = []
        for t in range(N):
            logits, caches = decode_step(params, cfg, toks[:, t:t + 1],
                                         caches, t)
            outs.append(logits[:, 0])
    assert none is None and full.dtype == torch.float32
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-4,
                               atol=2e-4)


def test_prefill_step_matches_jax(setup):
    cfg, jp, tp = setup
    b = synthetic_batch(cfg, B, 16, cursor=5)
    want = jax_build_prefill_step(cfg)(jp, {"tokens": jnp.asarray(b["tokens"])})
    got = build_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(b["tokens"])})
    assert got.shape == (B, cfg.padded_vocab)
    assert_within_ulps(got, want, "prefill logits")


def test_serve_step_matches_jax(setup):
    cfg, jp, tp = setup
    toks = tokens(cfg, 4, (B, 3))
    jstep, tstep = jax_build_serve_step(cfg), build_serve_step(cfg)
    jc = jax_init_caches(cfg, B, 8)
    tc = init_caches(cfg, B, 8, device="cpu")
    for t in range(3):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc2 = tstep(tp, torch.from_numpy(toks[:, t:t + 1]), tc, t)
        assert tc2 is tc and tl.shape == (B, cfg.padded_vocab)
        assert tl.is_inference()
        assert_within_ulps(tl, jl, f"step {t}")
    jc, tc = jax_flatten(jc), flatten_state(tc)
    for k in jc:
        assert_within_ulps(tc[k], jc[k], k)


def test_serve_batch_greedy_tokens_are_jax_tokens_in_float32():
    """In float32, where the logits agree to 1e-5, the greedy tokens are
    the JAX package's, token for token."""
    cfg = dataclasses.replace(jax_get_reduced(ARCH), dtype="float32")
    jp = jax_init_params(cfg, jax.random.key(0))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    prompts = synthetic_batch(cfg, 2, 8, cursor=0)["tokens"]
    want, _ = jax_serve_batch(cfg, jp, jnp.asarray(prompts), 6)
    got, tps = serve_batch(cfg, tp, torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6) and tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_greedy_tokens_are_jax_tokens(setup):
    """In bf16, the model's dtype, the greedy tokens are the JAX
    package's, token for token."""
    cfg, jp, tp = setup
    prompts = synthetic_batch(cfg, 2, 8, cursor=0)["tokens"]
    want, _ = jax_serve_batch(cfg, jp, jnp.asarray(prompts), 6)
    got, tps = serve_batch(cfg, tp, torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6) and tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_samples_with_a_generator(setup):
    cfg, _, tp = setup
    prompts = torch.from_numpy(synthetic_batch(cfg, 2, 4, cursor=1)["tokens"])
    with pytest.raises(ValueError, match="Generator"):
        serve_batch(cfg, tp, prompts, 3, greedy=False)
    a, b = (serve_batch(cfg, tp, prompts, 3, greedy=False,
                        generator=torch.Generator().manual_seed(7))[0]
            for _ in range(2))
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch,frames", [("whisper-large-v3", True),
                                         ("mamba2-130m", False)])
def test_serve_main_passes_the_synthetic_frames(monkeypatch, capsys, arch,
                                                frames):
    """As the reference's ``main``: the synthetic batch's frames, where the
    configuration's frontend makes them, reach ``serve_batch``."""
    seen = []

    def spy(cfg, params, prompts, gen, extras=None):
        seen.append(None if extras is None else
                    {k: tuple(v.shape) for k, v in extras.items()})
        return serve_batch(cfg, params, prompts, gen, extras)

    monkeypatch.setattr(serve, "serve_batch", spy)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--reduced", "--arch", arch, "--batch",
        "2", "--prompt-len", "16", "--gen", "3"])
    serve.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["generated_shape"] == [2, 3]
    d = get_reduced(arch).d_model
    assert seen == [{"frames": (2, 16, d)} if frames else None]


def test_serve_main_prints_its_json_line(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--reduced", "--batch", "2",
        "--prompt-len", "8", "--gen", "4"])
    serve.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "tinyllama-smoke" and line["device"] == "cpu"
    assert line["generated_shape"] == [2, 4] and line["tokens_per_s"] > 0
    assert len(line["sample"]) == 4


def test_serve_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    monkeypatch.setattr(sys, "argv", ["serve", "--reduced"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main()


def fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_are_the_reference(arch):
    assert fields(get_config(arch)) == fields(jax_get_config(arch))
    assert fields(get_reduced(arch)) == fields(jax_get_reduced(arch))
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()


@pytest.mark.parametrize("arch", DENSE)
def test_full_size_init_on_meta_is_the_reference_tree(arch):
    abstract = jax.eval_shape(
        lambda k: jax_init_params(jax_get_config(arch), k), jax.random.key(0))
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = flatten_state(init_params(get_config(arch), device="meta"))
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype) == f"torch.{want[k].dtype}", k
