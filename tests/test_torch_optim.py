"""The port's AdamW, schedule and synthetic data against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim.adamw import global_norm as jax_global_norm
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticPipeline, synthetic_batch
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.optim.adamw import global_norm
from repro_torch.persistence.state import flatten_state, from_numpy

SHAPES = {"a": (64, 33), "b/c": (7,), "b/d": (3, 5, 4)}


def tree(fn):
    return {"a": fn(SHAPES["a"]), "b": {"c": fn(SHAPES["b/c"]),
                                        "d": fn(SHAPES["b/d"])}}


def to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def to_torch(t):
    return {k: (to_torch(v) if isinstance(v, dict) else
                from_numpy({"x": v}, "cpu")["x"]) for k, v in t.items()}


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at each element's magnitude."""
    mag = np.maximum(np.abs(a.astype(np.float32)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def inputs(grad_std: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = tree(lambda s: (rng.standard_normal(s) * 0.02).astype(ml_dtypes.bfloat16))
    g = tree(lambda s: (rng.standard_normal(s) * grad_std).astype(ml_dtypes.bfloat16))
    m = tree(lambda s: (rng.standard_normal(s) * 0.01).astype(np.float32))
    v = tree(lambda s: (np.abs(rng.standard_normal(s)) * 1e-4).astype(np.float32))
    return p, g, m, v


@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_jax(clipped, lr_scale):
    # grads of std 3 have a global norm ~140 (clipped to 1.0), of std 0.01
    # a norm ~0.46 (scale exactly 1)
    p, g, m, v = inputs(3.0 if clipped else 0.01)
    count = 7
    jp, jo, jmet = jax_adamw_update(
        to_jax(g), {"m": to_jax(m), "v": to_jax(v), "count": jnp.int32(count)},
        to_jax(p), JaxAdamWConfig(), jnp.float32(lr_scale))
    tp, to = to_torch(p), {"m": to_torch(m), "v": to_torch(v),
                           "count": torch.tensor(count, dtype=torch.int32)}
    given = flatten_state(tp)
    rp, ro, tmet = adamw_update(to_torch(g), to, tp, AdamWConfig(),
                                torch.tensor(lr_scale, dtype=torch.float32))
    # updated in place: the same tensors come back
    assert rp is tp and ro is to
    assert all(flatten_state(rp)[k] is t for k, t in given.items())
    assert ro["count"].dtype == torch.int32 and ro["count"].shape == ()
    assert int(ro["count"]) == int(jo["count"]) == count + 1
    # the global norm sums in another order: within 1e-6 relative
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["clip_scale"]),
                               float(jmet["clip_scale"]), rtol=1e-6)
    assert (float(tmet["clip_scale"]) < 1.0) == clipped
    for name in ("m", "v"):
        want = {k: np.asarray(x) for k, x in
                flatten_state(jo[name]).items()}
        for k, x in flatten_state(ro[name]).items():
            assert x.dtype == torch.float32, (name, k)
            # moments within rtol 1e-5 (unclipped: measured bit-equal);
            # a clipped step scales the grads by 1/gnorm, which differs in
            # its last bits, and m = b1*m + (1-b1)*g cancels, so those
            # also get an absolute floor of 1e-5 of the largest moment
            # (measured: 8.7e-8 of it)
            atol = 1e-5 * np.abs(want[k]).max() if clipped else 0.0
            np.testing.assert_allclose(x.numpy(), want[k], rtol=1e-5,
                                       atol=atol, err_msg=f"{name}/{k}")
    want_p = {k: np.asarray(x).astype(np.float32)
              for k, x in flatten_state(jp).items()}
    for k, x in flatten_state(rp).items():
        assert x.dtype == torch.bfloat16, k
        # new bf16 params within 1 ulp (measured: at most 1e-3 ulp)
        diff = np.abs(x.float().numpy() - want_p[k])
        assert np.all(diff <= bf16_ulp(want_p[k])), k


def test_adamw_init_shapes_and_types():
    p, *_ = inputs(1.0)
    tp = to_torch(p)
    opt = adamw_init(tp)
    assert list(opt) == ["m", "v", "count"]
    assert opt["count"].dtype == torch.int32 and opt["count"].shape == ()
    for name in ("m", "v"):
        flat = flatten_state(opt[name])
        assert list(flat) == list(flatten_state(tp))
        for k, t in flat.items():
            assert t.dtype == torch.float32 and tuple(t.shape) == SHAPES[k]
            assert not t.any()
    assert flatten_state(opt["m"])["a"].data_ptr() != \
        flatten_state(opt["v"])["a"].data_ptr()


def test_adamw_refuses_mismatched_trees():
    p, g, m, v = inputs(1.0)
    opt = {"m": to_torch(m), "v": to_torch(v),
           "count": torch.zeros((), dtype=torch.int32)}
    g = to_torch(g)
    del g["b"]["c"]
    with pytest.raises(ValueError, match="leaves"):
        adamw_update(g, opt, to_torch(p), AdamWConfig())


def test_global_norm_matches_jax():
    _, g, _, _ = inputs(3.0, seed=4)
    want = float(jax_global_norm(to_jax(g)))
    got = global_norm(to_torch(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)   # sum order


@pytest.mark.parametrize("count", [0, 1, 50, 100, 5000, 10000])
def test_warmup_cosine_matches_jax(count):
    want = jax_warmup_cosine(jnp.int32(count))
    got = warmup_cosine(torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(want)   # measured bit-equal in float32
    short = warmup_cosine(count, warmup=10, total=200)
    assert float(short) == float(jax_warmup_cosine(count, warmup=10,
                                                   total=200))
    if count == 0:
        assert float(got) == 0.0   # the first step moves no parameter


@pytest.mark.parametrize("cursor", [0, 1, 7, 123456])
def test_synthetic_batch_is_the_reference(cursor):
    want = jax_synthetic_batch(jax_get_reduced("tinyllama-1.1b"), 4, 64,
                               cursor)
    got = synthetic_batch(get_reduced("tinyllama-1.1b"), 4, 64, cursor)
    assert list(got) == list(want) == ["tokens", "labels"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    pipe = SyntheticPipeline(get_reduced("tinyllama-1.1b"), 4, 64)
    np.testing.assert_array_equal(pipe.batch_at(cursor)["tokens"],
                                  want["tokens"])
