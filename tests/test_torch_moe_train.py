"""The MoE family's training side in the port against the JAX package:
the leaves that cross as bytes (the float32 router, the ``(L, E, D, F)``
experts, MLA's projections and norms, the shared FFN), one AdamW update
of the float32 router among bf16 leaves, and the trainer on the reduced
deepseek-v2 (its dense first layer, two MoE layers, MLA and a shared
expert: 31 parameter leaves and 63 optimizer leaves checkpointed), with
a crash and resume and checkpoints that one package writes and the
other resumes.
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.train import flatten_state as jax_flatten
from repro.models import init_params as jax_init_params
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.core.costmodel import PMemCostModel
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.persistence import (CheckpointConfig, CheckpointManager,
                                     to_numpy)
from repro_torch.persistence.state import (flatten_state, from_numpy,
                                           trainer_state, unflatten_state)

DSV2 = "deepseek-v2-236b"
CM = PMemCostModel(hbm_read_bw_gbps=819.0)
ROUTER = "decoder/seg1/b0/moe/router"


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def same_bytes(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].reshape(-1).view(np.uint8),
                                      want[k].reshape(-1).view(np.uint8),
                                      err_msg=k)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_reduced(DSV2)
    jp = jax.jit(lambda k: jax_init_params(cfg, k))(jax.random.key(0))
    flat = {f"p/{k}": np.asarray(v) for k, v in jax_flatten(jp).items()}
    tp, _ = trainer_state(flat, device="cpu")
    return cfg, jp, tp, flat


def test_moe_and_mla_leaves_cross_as_bytes(setup):
    """``trainer_state`` (through ``from_numpy``) keeps every leaf's bytes,
    shape and dtype: the float32 router, the stacked experts, MLA's
    latent projections and its two norm vectors, and the shared FFN."""
    cfg, _, tp, flat = setup
    got = flatten_state(tp)
    assert [f"p/{k}" for k in got] == list(flat)
    same_bytes(to_numpy(got), {k[2:]: v for k, v in flat.items()})
    L = cfg.num_layers - cfg.first_dense_layers
    E, D, Fe = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert got[ROUTER].dtype == torch.float32
    assert tuple(got[ROUTER].shape) == (L, D, E)
    for k, shape in (("gate", (L, E, D, Fe)), ("up", (L, E, D, Fe)),
                     ("down", (L, E, Fe, D)),
                     ("shared/gate", (L, D, cfg.num_shared_experts * Fe))):
        assert tuple(got[f"decoder/seg1/b0/moe/{k}"].shape) == shape, k
        assert got[f"decoder/seg1/b0/moe/{k}"].dtype == torch.bfloat16
    for seg, n in (("seg0", 1), ("seg1", L)):
        attn = f"decoder/{seg}/b0/attn"
        assert tuple(got[f"{attn}/kv_norm"].shape) == (n, cfg.kv_lora_rank)
        assert tuple(got[f"{attn}/q_norm"].shape) == (n, cfg.q_lora_rank)
        assert tuple(got[f"{attn}/wkv_b"].shape) == (
            n, cfg.kv_lora_rank,
            cfg.padded_heads * (cfg.qk_nope_dim + cfg.v_head_dim))
    assert sum(1 for k in got) == 31


def test_adamw_moves_the_float32_router_as_jax_does(setup):
    """One update of the bf16 tree holding the float32 router: moments and
    parameters against JAX's (float32 leaves within 1e-6, bf16 leaves
    within one ulp)."""
    _, jp, tp, _ = setup
    rng = np.random.default_rng(9)
    g = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
         .astype(v.dtype) for k, v in jax_flatten(jp).items()}
    jg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                      [jnp.asarray(g[k]) for k in
                                       jax_flatten(jp)])
    jp2, jo2, _ = jax.jit(lambda g, o, p: jax_adamw_update(
        g, o, p, JaxAdamWConfig(), 0.5))(jg, jax_adamw_init(jp), jp)
    to = adamw_init(tp)
    tp2, to2, _ = adamw_update(unflatten_state(from_numpy(g, "cpu")), to, tp,
                               AdamWConfig(), 0.5)
    want_p, want_m = jax_flatten(jp2), jax_flatten(jo2["m"])
    got_p, got_m = flatten_state(tp2), flatten_state(to2["m"])
    assert got_p[ROUTER].dtype == got_m[ROUTER].dtype == torch.float32
    assert not np.array_equal(got_p[ROUTER].numpy(),
                              np.asarray(jax_flatten(jp)[ROUTER]))
    for k in want_p:
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        want = np.asarray(want_p[k], np.float32)
        got = got_p[k].float().numpy()
        if got_p[k].dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
        else:
            assert np.max(np.abs(got - want)) <= bf16_ulp(
                np.max(np.abs(want))), k


# ----------------------------------------------------------------- trainer

RUN = dict(arch=DSV2, reduced=True, steps=4, batch=2, seq=32, ckpt_every=2)


def port_trainer(out, **kw) -> Trainer:
    return Trainer(TrainerConfig(out=str(out), device="cpu",
                                 **dict(RUN, **kw)), cost_model=CM)


def test_moe_trainer_crashes_resumes_and_crosses_to_jax(tmp_path):
    """The port trains the reduced deepseek-v2, saves at step 2 and
    crashes at 3; a fresh port trainer restores step 2 and repeats its
    loss. The JAX trainer resumes the port's checkpoint byte for byte,
    trains to step 4 and saves; the port resumes that checkpoint byte for
    byte."""
    out = tmp_path / "run"
    t1 = port_trainer(out, async_flush=False)
    state = t1._ckpt_state()
    assert len(state) == 94
    assert sum(k.startswith("p/") for k in state) == 31
    assert state[f"p/{ROUTER}"].dtype == torch.float32
    assert state[f"o/m/{ROUTER}"].dtype == torch.float32
    r1 = t1.run(crash_at=3)
    assert r1["crashed_at"] == 3 and all(np.isfinite(r1["losses"]))
    step, saved = CheckpointManager(
        str(out / "ckpt.pmem"), CheckpointConfig(page_size=128 * 1024),
        device="cpu", cost_model=CM).restore()
    assert step == 2
    saved = to_numpy({k: saved[k] for k in state})
    t2 = port_trainer(out, async_flush=False)
    assert t2.start_step == 2
    same_bytes(to_numpy(t2._ckpt_state()), saved)
    assert t2.run(crash_at=3)["losses"] == r1["losses"][2:]
    # the JAX trainer resumes the port's checkpoint, then saves step 4
    jt = jax_train.Trainer(jax_train.TrainerConfig(
        out=str(out), **dict(RUN, async_flush=False)))
    assert jt.start_step == 2
    got = {k: np.asarray(v) for k, v in jt._ckpt_state().items()}
    same_bytes(got, saved)
    assert got["p/embed"].dtype == ml_dtypes.bfloat16
    jt.run()
    want = {k: np.asarray(v) for k, v in jt._ckpt_state().items()}
    # and the port resumes the JAX trainer's checkpoint
    t3 = port_trainer(out, steps=5, async_flush=False)
    assert t3.start_step == 4
    same_bytes(to_numpy(t3._ckpt_state()), want)
    loss = t3.run()["losses"]
    assert len(loss) == 1 and np.isfinite(loss[0])
