"""The RG-LRU hybrid's training side in the port against the JAX
package: gradients (the float32 ``lam`` leaf among bf16 ones), one AdamW
update, and the trainer on the 5-layer reduced hybrid (a (rec, rec,
attn) unit and the (rec, rec) tail segment): 63 parameter leaves and 127
optimizer leaves checkpointed, a crash and resume, and checkpoints that
one package writes and the other resumes.

Parameters come from the JAX ``init_params`` and cross to the port as
bytes (``trainer_state``); gradients are held per leaf within the
relative L2 bound of ``tests/test_torch_model.py`` (3e-2).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train
from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.launch.train import flatten_state as jax_flatten
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.core.costmodel import PMemCostModel
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.models import lm_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.persistence import (CheckpointConfig, CheckpointManager,
                                     to_numpy)
from repro_torch.persistence.state import (flatten_state, from_numpy,
                                           trainer_state, unflatten_state)

HYBRID = "recurrentgemma-9b"
CM = PMemCostModel(hbm_read_bw_gbps=819.0)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def assert_within_ulps(got: torch.Tensor, want, what: str,
                       ulps: int = 4) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= ulps * bf16_ulp(np.max(np.abs(want))), (what, err)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_reduced(HYBRID)
    jp = jax_init_params(cfg, jax.random.key(0))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    return cfg, jp, tp


# ------------------------------------------------------ gradients, AdamW

def test_hybrid_gradients_match_jax(setup):
    """Per leaf, the float32 ``lam`` among them, with and without remat:
    relative L2 under 3e-2, the bound of ``tests/test_torch_model.py``.
    64 tokens: the band route."""
    cfg, jp, tp = setup
    b = jax_synthetic_batch(cfg, 1, 64, cursor=4)
    jgrads = jax_flatten(jax.jit(jax.grad(lambda p, b: jax_lm_loss(
        p, cfg, b, remat=True)[0]))(jp, {k: jnp.asarray(v)
                                         for k, v in b.items()}))
    out = []
    for remat in (True, False):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten_state(tp).items()}
        loss, _ = lm_loss(unflatten_state(leaves), cfg,
                          {k: torch.from_numpy(v) for k, v in b.items()},
                          remat=remat)
        out.append(dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))))
    for grads in out:
        assert set(grads) == set(jgrads)
        assert grads["decoder/seg0/b0/rec/lam"].dtype == torch.float32
        for k, g in grads.items():
            want = np.asarray(jgrads[k], dtype=np.float32)
            err = (np.linalg.norm(g.float().numpy() - want)
                   / max(np.linalg.norm(want), 1e-30))
            assert err < 3e-2, (k, err)


def test_adamw_moves_the_float32_lam_leaf_as_jax_does(setup):
    """One update of a bf16 tree holding the float32 ``lam``: moments and
    parameters against JAX's (float32 leaves within 1e-6, bf16 leaves
    within one ulp)."""
    _, jp, tp = setup
    rng = np.random.default_rng(8)
    g = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
         .astype(v.dtype) for k, v in jax_flatten(jp).items()}
    jg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                      [jnp.asarray(g[k]) for k in
                                       jax_flatten(jp)])
    jp2, jo2, _ = jax.jit(lambda g, o, p: jax_adamw_update(
        g, o, p, JaxAdamWConfig(), 0.5))(jg, jax_adamw_init(jp), jp)
    to = adamw_init(tp)
    tg = unflatten_state(from_numpy(g, "cpu"))
    tp2, to2, _ = adamw_update(tg, to, tp, AdamWConfig(), 0.5)
    want_p, want_m = jax_flatten(jp2), jax_flatten(jo2["m"])
    got_p, got_m = flatten_state(tp2), flatten_state(to2["m"])
    lam = "decoder/seg0/b0/rec/lam"
    assert got_p[lam].dtype == torch.float32
    assert not np.array_equal(got_p[lam].numpy(),
                              np.asarray(jax_flatten(jp)[lam]))
    for k in want_p:
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        want = np.asarray(want_p[k], np.float32)
        if got_p[k].dtype == torch.float32:
            np.testing.assert_allclose(got_p[k].numpy(), want, rtol=1e-6,
                                       err_msg=k)
        else:
            assert_within_ulps(got_p[k], want, k, ulps=1)


# ----------------------------------------------------------------- trainer

#: the reduced hybrid at 5 layers: one (rec, rec, attn) unit and the
#: (rec, rec) tail segment
RUN = dict(arch=HYBRID, reduced=True, steps=4, batch=2, seq=64,
           ckpt_every=2)


@pytest.fixture
def five_layer_jax_trainer(monkeypatch):
    """The JAX trainer on the 5-layer reduced hybrid (its TrainerConfig has
    no depth, so its get_reduced is patched here)."""
    cut = dataclasses.replace(jax_get_reduced(HYBRID), num_layers=5)
    monkeypatch.setattr(jax_train, "get_reduced", lambda arch: cut)

    def make(out, **kw):
        return jax_train.Trainer(jax_train.TrainerConfig(
            out=str(out), **dict(RUN, **kw)))
    return make


def port_trainer(out, **kw) -> Trainer:
    return Trainer(TrainerConfig(out=str(out), device="cpu", layers=5,
                                 **dict(RUN, **kw)), cost_model=CM)


def same_bytes(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].reshape(-1).view(np.uint8),
                                      want[k].reshape(-1).view(np.uint8),
                                      err_msg=k)


def test_hybrid_trainer_crashes_resumes_and_crosses_to_jax(
        tmp_path, five_layer_jax_trainer):
    """The port trains the 5-layer hybrid, saves at step 2 and crashes at
    3; a fresh port trainer restores step 2 and repeats its loss. The JAX
    trainer resumes the port's checkpoint byte for byte, trains to step 4
    and saves; the port resumes that checkpoint byte for byte."""
    out = tmp_path / "run"
    t1 = port_trainer(out, async_flush=False)
    state = t1._ckpt_state()
    assert len(state) == 190
    assert sum(k.startswith("p/") for k in state) == 63
    assert state["p/decoder/seg1/b1/rec/lam"].dtype == torch.float32
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
    jt = five_layer_jax_trainer(out, steps=4, async_flush=False)
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
