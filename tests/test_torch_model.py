"""The port's dense model (``repro_torch.models``) against the JAX package's.

Parameters come from the JAX ``init_params(get_reduced("tinyllama-1.1b"))``
and cross to the port as bytes (``repro_torch.persistence.state.
trainer_state``); batches come from the synthetic pipeline, a numpy
function of a cursor. Both sides compute in bf16 with float32 norms,
softmax and loss, so they differ by where bf16 rounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch
from repro.launch.train import flatten_state as jax_flatten
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models import (Model, forward, init_caches, init_params,
                                lm_loss)
from repro_torch.models.attention import _attend, gqa_apply
from repro_torch.persistence.state import (TINYLLAMA_1_1B_PARAMS,
                                           flatten_state, trainer_state,
                                           unflatten_state)

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_reduced(ARCH)
    jp = jax_init_params(cfg, jax.random.key(0))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    b = synthetic_batch(cfg, 4, 64, 3)
    return (cfg, jp, tp, {k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def test_configs_are_the_reference():
    assert dataclass_fields(get_config(ARCH)) == dataclass_fields(
        jax_get_config(ARCH))
    assert dataclass_fields(get_reduced(ARCH)) == dataclass_fields(
        jax_get_reduced(ARCH))
    assert get_config(ARCH).param_count() == jax_get_config(ARCH).param_count()


def dataclass_fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def test_forward_and_loss_match_jax(setup):
    cfg, jp, tp, jb, tb = setup
    jlogits, _ = jax_forward(jp, cfg, jb)
    tlogits, _ = forward(tp, cfg, tb)
    want = np.asarray(jlogits, dtype=np.float32)
    got = tlogits.float().numpy()
    assert got.shape == want.shape == (4, 64, cfg.padded_vocab)
    assert tlogits.dtype == torch.bfloat16
    # bf16 tolerance: 4 bf16 ulps at the largest logit (measured: 0.0137
    # against a largest logit of 1.008, under 2 ulps)
    assert np.max(np.abs(got - want)) <= 4 * bf16_ulp(np.max(np.abs(want)))
    jloss, _ = jax_lm_loss(jp, cfg, jb)
    tloss, metrics = lm_loss(tp, cfg, tb)
    assert tloss.dtype == torch.float32 and metrics["loss"] is tloss
    # relative 2e-2 (measured: 1.7e-5)
    assert abs(float(tloss) - float(jloss)) <= 2e-2 * abs(float(jloss))


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax(setup, remat):
    cfg, jp, tp, jb, tb = setup
    jgrads = jax_flatten(jax.grad(
        lambda p: jax_lm_loss(p, cfg, jb, remat=remat)[0])(jp))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_state(tp).items()}
    loss, _ = lm_loss(unflatten_state(leaves), cfg, tb, remat=remat)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = np.asarray(jgrads[k], dtype=np.float32)
        assert g.dtype == torch.bfloat16 and g.shape == want.shape, k
        err = (np.linalg.norm(g.float().numpy() - want)
               / np.linalg.norm(want))
        # relative L2 error per leaf under 3e-2 (measured worst: 0.0199,
        # attn/wq, with and without remat)
        assert err < 3e-2, (k, err)


def test_remat_gives_the_same_gradients(setup):
    cfg, _, tp, _, tb = setup
    out = []
    for remat in (False, True):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten_state(tp).items()}
        loss, _ = lm_loss(unflatten_state(leaves), cfg, tb, remat=remat)
        out.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*out):
        assert torch.equal(a, b)   # recomputation is deterministic


def test_init_params_has_the_reference_tree():
    cfg = get_reduced(ARCH)
    abstract = jax.eval_shape(
        lambda k: jax_init_params(jax_get_reduced(ARCH), k),
        jax.random.key(0))
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = flatten_state(init_params(cfg, 0, device="cpu"))
    assert list(got) == list(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype) == f"torch.{want[k].dtype}", k
    again = flatten_state(init_params(cfg, 0, device="cpu"))
    other = flatten_state(init_params(cfg, 1, device="cpu"))
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["embed"], other["embed"])


def test_init_params_full_width_and_depth_on_meta():
    cfg = get_config(ARCH)
    got = flatten_state(init_params(cfg, device="meta"))
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1])
            for k, t in got.items()} == TINYLLAMA_1_1B_PARAMS
    assert all(t.device.type == "meta" for t in got.values())
    assert sum(t.numel() for t in got.values()) == 1_100_048_384


def test_model_module_names_are_the_checkpoint_keys(setup):
    cfg, _, tp, _, tb = setup
    model = Model(cfg, tp)
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(flatten_state(tp))
    assert list(model.flat()) == list(flatten_state(tp))
    # the parameters share the given tensors' storage
    assert model.flat()["embed"].data_ptr() == tp["embed"].data_ptr()
    with torch.no_grad():
        assert torch.equal(model(tb), forward(tp, cfg, tb)[0])


def test_heads_group_as_the_reference_groups_them():
    """q-head h = kv * G + g attends with k/v head kv: the same as
    ``repeat_interleave`` of k and v over the group."""
    g = torch.Generator().manual_seed(0)
    B, S, KV, G, hd = 2, 5, 3, 4, 8
    q = torch.randn(B, S, KV, G, hd, generator=g)
    k = torch.randn(B, S, KV, hd, generator=g)
    v = torch.randn(B, S, KV, hd, generator=g)
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool))
    got = _attend(q, k, v, mask, 0.5).reshape(B, S, KV * G, hd)
    qh = q.reshape(B, S, KV * G, hd).transpose(1, 2)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)) * 0.5
    scores = scores.masked_fill(~mask, -1e30)
    want = (torch.softmax(scores, -1) @ vh).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_every_architecture_of_the_registry_resolves(name):
    """Every architecture of the JAX package's registry builds in the port:
    its published and reduced configurations are the reference's."""
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    assert dataclass_fields(get_config(name)) == dataclass_fields(
        jax_get_config(name))
    assert dataclass_fields(get_reduced(name)) == dataclass_fields(
        jax_get_reduced(name))


def test_attention_with_only_one_of_cache_and_cache_pos_is_refused():
    """Self-attention and ``forward`` take a cache and its position
    together or neither; cross attention takes its cache alone."""
    cfg = get_reduced(ARCH)
    params = init_params(cfg, 0, device="cpu")
    p = flatten_state(params)
    attn = {k: p[f"decoder/seg0/b0/attn/{k}"][0]
            for k in ("wq", "wk", "wv", "wo")}
    x = torch.zeros(1, 1, cfg.d_model, dtype=torch.bfloat16)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    cache = {k: v[0] for k, v in init_caches(cfg, 1, 4, device="cpu")[
        "seg0"]["b0"].items()}
    with pytest.raises(NotImplementedError, match="only one of cache"):
        gqa_apply(attn, x, cfg=cfg, positions=pos, cache=cache)
    with pytest.raises(NotImplementedError, match="only one of cache"):
        gqa_apply(attn, x, cfg=cfg, positions=pos, cache_pos=0)
    tokens = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="only one of caches"):
        forward(params, cfg, {"tokens": tokens}, cache_pos=0)
