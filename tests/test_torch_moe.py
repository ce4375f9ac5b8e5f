"""The MoE block and phi3.5-moe-42b-a6.6b in the port against the JAX
package: routing (top-k ties, capacity and drops), dispatch, the expert
products, the combine, the shared experts, the load-balance loss, and
the model's forward, loss and gradients; the configurations and the
full-size trees (MLA and deepseek-v2 are in ``tests/test_torch_mla.py``,
the trainer in ``tests/test_torch_moe_train.py``).

Parameters come from the JAX ``moe_init`` / ``init_params`` and cross to
the port as bytes (``from_numpy``, ``trainer_state``); inputs are drawn
with numpy from a seed. Tolerances: float32 within 1e-6 (one block) or
1e-5 (the model); bf16 within 4 bf16 ulps of the largest value; the
loss relative 1e-5 (float32) or 2e-2 (bf16); gradients per leaf under
3e-2 relative L2, the bound of ``tests/test_torch_model.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.launch.train import flatten_state as jax_flatten
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models.layers import ffn_apply as jax_ffn_apply
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import forward, init_params, lm_loss
from repro_torch.models import moe
from repro_torch.models.layers import ffn_apply
from repro_torch.persistence.state import (flatten_state, from_numpy,
                                           trainer_state, unflatten_state)

PHI, DSV2 = "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"
F32 = dict(rtol=1e-6, atol=1e-6)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def assert_within_ulps(got: torch.Tensor, want, what: str,
                       ulps: int = 4) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= ulps * bf16_ulp(np.max(np.abs(want))), (what, err)


def reduced(arch: str, dtype: str = "float32", **kw):
    return dataclasses.replace(jax_get_reduced(arch), dtype=dtype, **kw)


def block(cfg, seed: int = 0):
    """The JAX MoE block's parameters and the same bytes as the port's."""
    jp = jmoe.moe_init(jax.random.key(seed), cfg, dtype=jnp.dtype(cfg.dtype))
    tp = unflatten_state(from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jp).items()}, "cpu"))
    return jp, tp


def inputs(cfg, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def jax_buffer(monkeypatch, jp, x, cfg):
    """The reference's output and its expert buffer ``h`` (E, cap, D), under
    jit: its ``constrain`` (the identity without a mesh) is wrapped while
    it traces to keep what it is given; the first array given the expert
    layout is the buffer, returned beside the output."""
    def run(p, x):
        seen = []

        def keep(a, spec):
            seen.append((tuple(spec), a))
            return a

        monkeypatch.setattr(jmoe, "constrain", keep)
        y = jmoe.moe_apply(p, x, cfg)
        return y, next(a for spec, a in seen
                       if spec == ("model", "fsdp", None))

    y, h = jax.jit(run)(jp, jnp.asarray(x))
    return np.asarray(y), np.asarray(h)


def port_buffer(tp, x: torch.Tensor, cfg):
    """The port's expert buffer, built with its own routing and
    dispatch: ``(h (E, cap, D), keep)``."""
    N, D = x.shape[0] * x.shape[1], cfg.d_model
    xf = x.reshape(N, D)
    _, _, experts = moe.route(tp, xf, cfg.top_k)
    cap = moe.capacity(N, cfg)
    order, slot, keep = moe.dispatch(experts, cfg.num_experts, cap)
    buf = torch.zeros((cfg.num_experts * cap + 1, D), dtype=x.dtype)
    buf = buf.index_copy(0, slot, xf[order // cfg.top_k])
    return buf[:-1].reshape(cfg.num_experts, cap, D), keep


# ------------------------------------------------------------------ block

@pytest.mark.parametrize("arch", [PHI, DSV2])
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_apply_matches_jax_in_float32_with_the_same_drops(
        monkeypatch, arch, cf):
    """At capacity factor 0.5 assignments are dropped, at 8.0 none: the
    expert buffers (which tokens sit in which slot) are equal bit for
    bit, so the same assignments are kept, and the outputs within 1e-6."""
    cfg = reduced(arch, capacity_factor=cf)
    jp, tp = block(cfg)
    x = inputs(cfg, (2, 16), seed=1)
    want, jh = jax_buffer(monkeypatch, jp, x, cfg)
    th, keep = port_buffer(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(th.numpy(), jh)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cf < 1), dropped
    assert int(np.count_nonzero(np.abs(jh).sum(-1))) == int(keep.sum())
    got = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("arch", [PHI, DSV2])
def test_moe_apply_matches_jax_in_bf16(arch):
    """bf16 at the configuration's capacity factor (1.25), under jit: the
    router keeps its float32 product, the expert SiLU rounds op by op."""
    cfg = reduced(arch, "bfloat16")
    jp, tp = block(cfg)
    x = inputs(cfg, (4, 16), seed=2)
    want = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg))(
        jp, jnp.asarray(x).astype(jnp.bfloat16))
    got = moe.moe_apply(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    assert_within_ulps(got, want, "moe_apply")


def test_top_k_takes_the_lower_index_first_on_ties():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.2, 0.2, 0.5, 0.1]], dtype=np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_bf16_router_ties_route_as_jax_does(monkeypatch):
    """Experts 4-7 copy the router columns of experts 0-3, so every token's
    two largest bf16 router logits tie: the port routes each to the lower
    expert first, and its expert buffer is the reference's bit for bit."""
    cfg = reduced(PHI, "bfloat16", num_experts=8, top_k=2)
    jp, tp = block(cfg)
    router = np.asarray(jp["router"]).copy()
    router[:, 4:] = router[:, :4]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = inputs(cfg, (1, 16), seed=3)
    xb = torch.from_numpy(x).bfloat16()
    _, jh = jax_buffer(monkeypatch, jp, jnp.asarray(x).astype(jnp.bfloat16),
                       cfg)
    th, _ = port_buffer(tp, xb, cfg)
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh, dtype=np.float32))
    _, _, got = moe.route(tp, xb.reshape(-1, cfg.d_model), 2)
    assert (got[:, 1] - got[:, 0] == 4).all()      # each tie, lower first


@pytest.mark.parametrize("n,cf,cap", [(20, 1.25, 12), (36, 1.5, 14),
                                      (4, 1.25, 8)])
def test_capacity_rounds_half_to_even_as_the_reference(monkeypatch, n, cf,
                                                       cap):
    """N·k/E·cf = 12.5 → 12 and 13.5 → 14 (Python's round), and never
    under 8; the reference's buffer has the same number of slots."""
    cfg = reduced(PHI, capacity_factor=cf, num_experts=4 if n != 36 else 8)
    assert moe.capacity(n, cfg) == cap
    jp, _ = block(cfg)
    _, jh = jax_buffer(monkeypatch, jp, inputs(cfg, (1, n), seed=4), cfg)
    assert jh.shape == (cfg.num_experts, cap, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_aux_loss_matches_jax(dtype):
    cfg = reduced(DSV2, dtype)
    jp, tp = block(cfg)
    x = inputs(cfg, (2, 16), seed=5)
    want = jax.jit(lambda p, x: jmoe.moe_aux_loss(p, x, cfg))(
        jp, jnp.asarray(x).astype(cfg.dtype))
    got = moe.moe_aux_loss(tp, torch.from_numpy(x).to(
        getattr(torch, dtype)), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_shared_experts_add_the_shared_ffn():
    """deepseek-v2's shared FFN (width num_shared_experts · moe_d_ff): the
    block with it minus the block without it is ``ffn_apply`` of the
    shared leaves, in both packages."""
    cfg = reduced(DSV2, num_shared_experts=2)
    jp, tp = block(cfg)
    assert tuple(tp["shared"]["gate"].shape) == (cfg.d_model,
                                                 2 * cfg.moe_d_ff)
    x = inputs(cfg, (2, 8), seed=6)
    xt = torch.from_numpy(x)
    routed = {k: v for k, v in tp.items() if k != "shared"}
    got = moe.moe_apply(tp, xt, cfg) - moe.moe_apply(routed, xt, cfg)
    np.testing.assert_allclose(
        got.numpy(), ffn_apply(tp["shared"], xt).numpy(), **F32)
    want, shared = jax.jit(lambda p, x: (jmoe.moe_apply(p, x, cfg),
                                         jax_ffn_apply(p["shared"], x)))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(moe.moe_apply(tp, xt, cfg).numpy(),
                               np.asarray(want), **F32)
    np.testing.assert_allclose(ffn_apply(tp["shared"], xt).numpy(),
                               np.asarray(shared), **F32)


def test_dropped_assignments_get_no_gradient():
    """The dump row takes every dropped assignment and nothing reads it:
    the gradient of each dropped copy of a token is zero, a token whose
    assignments were all dropped gets none, and the input gradient is
    JAX's."""
    cfg = reduced(PHI, capacity_factor=0.5)
    jp, tp = block(cfg)
    x = inputs(cfg, (2, 16), seed=7)
    up = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (gx,) = torch.autograd.grad((moe.moe_apply(tp, xt, cfg)
                                 * torch.from_numpy(up)).sum(), xt)
    want = jax.jit(jax.grad(lambda x: jnp.sum(
        jmoe.moe_apply(jp, x, cfg) * up)))(jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the dispatch copy alone: the copies that land in the dump row
    N, k = 32, cfg.top_k
    xf = torch.from_numpy(x).reshape(N, -1)
    _, _, experts = moe.route(tp, xf, k)
    cap = moe.capacity(N, cfg)
    order, slot, keep = moe.dispatch(experts, cfg.num_experts, cap)
    xs = xf[order // k].clone().requires_grad_(True)
    buf = torch.zeros((cfg.num_experts * cap + 1, cfg.d_model)).index_copy(
        0, slot, xs)
    (gs,) = torch.autograd.grad((buf[:-1] ** 2).sum() + 0 * buf[-1].sum(),
                                xs)
    assert int((~keep).sum()) > 0
    assert torch.all(gs[~keep] == 0) and torch.all(gs[keep] != 0)
    tok_dropped = (~keep[torch.argsort(order)].reshape(N, k)).all(dim=1)
    if tok_dropped.any():
        assert torch.all(gx.reshape(N, -1)[tok_dropped] == 0)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def phi(request):
    cfg = reduced(PHI, request.param)
    jp = jax.jit(lambda k: jax_init_params(cfg, k))(jax.random.key(0))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    b = jax_synthetic_batch(cfg, 2, 32, cursor=1)
    return cfg, jp, tp, b


def test_phi_forward_and_loss_match_jax(phi):
    cfg, jp, tp, b = phi
    want, _ = jax.jit(lambda p, t: jax_forward(p, cfg, {"tokens": t}))(
        jp, jnp.asarray(b["tokens"]))
    got, none = forward(tp, cfg, {"tokens": torch.from_numpy(b["tokens"])})
    assert none is None and got.dtype == getattr(torch, cfg.dtype)
    if cfg.dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert_within_ulps(got, want, "logits")
    jloss, _ = jax.jit(lambda p, b: jax_lm_loss(p, cfg, b))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, _ = lm_loss(tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if cfg.dtype == "float32" else 2e-2)


def test_phi_gradients_match_jax(phi):
    """Per leaf, the float32 router among them, with remat."""
    cfg, jp, tp, b = phi
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
    assert grads["decoder/seg0/b0/moe/router"].dtype == torch.float32
    for k, g in grads.items():
        want = np.asarray(jgrads[k], dtype=np.float32)
        err = (np.linalg.norm(g.float().numpy() - want)
               / max(np.linalg.norm(want), 1e-30))
        assert err < 3e-2, (k, err)


# --------------------------------------------------------- configurations

def fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def abstract_tree(cfg):
    abstract = jax.eval_shape(lambda k: jax_init_params(cfg, k),
                              jax.random.key(0))
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}


@pytest.mark.parametrize("arch,count,active", [
    (PHI, 41_872_523_264, 6_640_369_664),
    (DSV2, 235_741_306_880, 21_375_672_320)])
def test_configs_and_full_size_trees_are_the_reference(arch, count, active):
    assert fields(get_config(arch)) == fields(jax_get_config(arch))
    assert fields(get_reduced(arch)) == fields(jax_get_reduced(arch))
    for c, jc in ((get_config(arch), jax_get_config(arch)),
                  (get_reduced(arch), jax_get_reduced(arch))):
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()
    assert get_config(arch).param_count() == count
    assert get_config(arch).active_param_count() == active
    want = abstract_tree(jax_get_config(arch))
    got = flatten_state(init_params(get_config(arch), device="meta"))
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype) == f"torch.{want[k].dtype}", k
    seg = "seg1" if arch == DSV2 else "seg0"
    L = get_config(arch).segments[-1].repeat
    c = get_config(arch)
    assert tuple(got[f"decoder/{seg}/b0/moe/gate"].shape) == (
        L, c.num_experts, c.d_model, c.moe_d_ff)
    assert got[f"decoder/{seg}/b0/moe/router"].dtype == torch.float32
