"""The training side of mamba2 (SSD) and whisper (encoder-decoder) in the
port against the JAX package: gradients of ``lm_loss`` (the float32
``A_log``, ``D_skip`` and ``dt_bias`` among bf16 leaves; the encoder's
and the cross attention's), one AdamW update of the SSD's float32
leaves, and each reduced model's trainer with a crash and resume and
checkpoints that one package writes and the other resumes.

Parameters come from the JAX ``init_params`` and cross to the port as
bytes (``trainer_state``); gradients are held per leaf within the
relative L2 bound of ``tests/test_torch_model.py`` (3e-2).
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

SSM, AUDIO = "mamba2-130m", "whisper-large-v3"
CM = PMemCostModel(hbm_read_bw_gbps=819.0)
#: the SSD block's float32 leaves
F32_LEAVES = ("A_log", "D_skip", "dt_bias")


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def assert_within_ulps(got: torch.Tensor, want, what: str,
                       ulps: int = 4) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= ulps * bf16_ulp(np.max(np.abs(want))), (what, err)


def both(arch: str):
    cfg = jax_get_reduced(arch)
    jp = jax_init_params(cfg, jax.random.key(0))
    tp, _ = trainer_state({f"p/{k}": v for k, v in jax_flatten(jp).items()},
                          device="cpu")
    return cfg, jp, tp


# ------------------------------------------------------ gradients, AdamW

@pytest.mark.parametrize("arch", [SSM, AUDIO])
def test_gradients_match_jax(arch):
    """Per leaf, with and without remat, against ``jax.grad`` of the
    reference's ``lm_loss(remat=True)``: 64 tokens (four SSD chunks), and
    for whisper 64 frames through the encoder. The SSD's float32 leaves
    get float32 gradients; every encoder and ``xatt`` leaf gets one."""
    cfg, jp, tp = both(arch)
    b = jax_synthetic_batch(cfg, 2, 64, cursor=4)
    jgrads = jax_flatten(jax.jit(jax.grad(lambda p, b: jax_lm_loss(
        p, cfg, b, remat=True)[0]))(jp, {k: jnp.asarray(v)
                                         for k, v in b.items()}))
    for remat in (True, False):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten_state(tp).items()}
        loss, _ = lm_loss(unflatten_state(leaves), cfg,
                          {k: torch.from_numpy(v) for k, v in b.items()},
                          remat=remat)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        assert set(grads) == set(jgrads)
        if arch == SSM:
            for name in F32_LEAVES:
                assert grads[f"decoder/seg0/b0/ssd/{name}"].dtype \
                    == torch.float32
        else:
            assert any(k.startswith("encoder/") for k in grads)
            assert "decoder/seg0/b0/xatt/wk" in grads
        for k, g in grads.items():
            want = np.asarray(jgrads[k], dtype=np.float32)
            assert np.linalg.norm(want) > 0, k
            err = (np.linalg.norm(g.float().numpy() - want)
                   / np.linalg.norm(want))
            assert err < 3e-2, (arch, remat, k, err)


def test_adamw_moves_the_ssd_float32_leaves_as_jax_does():
    """One update of mamba2-smoke's tree: moments within 1e-5 relative
    (the gradients' global norm is over 1, so every moment carries the
    clip scale, a float32 sum over 93,680 values that the two packages add
    in other orders: measured 2e-6), parameters against JAX's (float32
    leaves within 1e-6, bf16 leaves within one ulp)."""
    _, jp, tp = both(SSM)
    rng = np.random.default_rng(8)
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
    for name in F32_LEAVES:
        k = f"decoder/seg0/b0/ssd/{name}"
        assert got_p[k].dtype == torch.float32
        assert not np.array_equal(got_p[k].numpy(),
                                  np.asarray(jax_flatten(jp)[k]))
    for k in want_p:
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
        want = np.asarray(want_p[k], np.float32)
        if got_p[k].dtype == torch.float32:
            np.testing.assert_allclose(got_p[k].numpy(), want, rtol=1e-6,
                                       err_msg=k)
        else:
            assert_within_ulps(got_p[k], want, k, ulps=1)


# ----------------------------------------------------------------- trainer

#: the checkpointed leaves of each reduced model: parameter leaves, and
#: with the optimizer's count, m and v
LEAVES = {SSM: (11, 34), AUDIO: (25, 76)}


def same_bytes(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].reshape(-1).view(np.uint8),
                                      want[k].reshape(-1).view(np.uint8),
                                      err_msg=k)


@pytest.mark.parametrize("arch", [SSM, AUDIO])
def test_trainer_crashes_resumes_and_crosses_to_jax(tmp_path, arch):
    """The port trains the reduced model, saves at step 2 and crashes at
    3; a fresh port trainer restores step 2 and repeats its loss. The JAX
    trainer resumes the port's checkpoint byte for byte, trains to step 4
    and saves; the port resumes that checkpoint byte for byte."""
    run = dict(arch=arch, reduced=True, steps=4, batch=2, seq=64,
               ckpt_every=2, out=str(tmp_path / "run"), async_flush=False)

    def port(**kw):
        return Trainer(TrainerConfig(device="cpu", **dict(run, **kw)),
                       cost_model=CM)

    t1 = port()
    state = t1._ckpt_state()
    assert (sum(k.startswith("p/") for k in state), len(state)) \
        == LEAVES[arch]
    if arch == SSM:
        assert state["p/decoder/seg0/b0/ssd/A_log"].dtype == torch.float32
    else:
        assert "p/encoder/seg0/b0/attn/wq" in state and "p/enc_norm" in state
    r1 = t1.run(crash_at=3)
    assert r1["crashed_at"] == 3 and all(np.isfinite(r1["losses"]))
    step, saved = CheckpointManager(
        run["out"] + "/ckpt.pmem", CheckpointConfig(page_size=128 * 1024),
        device="cpu", cost_model=CM).restore()
    assert step == 2
    saved = to_numpy({k: saved[k] for k in state})
    t2 = port()
    assert t2.start_step == 2
    same_bytes(to_numpy(t2._ckpt_state()), saved)
    assert t2.run(crash_at=3)["losses"] == r1["losses"][2:]
    # the JAX trainer resumes the port's checkpoint, then saves step 4
    jt = jax_train.Trainer(jax_train.TrainerConfig(**run))
    assert jt.start_step == 2
    got = {k: np.asarray(v) for k, v in jt._ckpt_state().items()}
    same_bytes(got, saved)
    assert got["p/embed"].dtype == ml_dtypes.bfloat16
    jt.run()
    want = {k: np.asarray(v) for k, v in jt._ckpt_state().items()}
    # and the port resumes the JAX trainer's checkpoint
    t3 = port(steps=5)
    assert t3.start_step == 4
    same_bytes(to_numpy(t3._ckpt_state()), want)
    loss = t3.run()["losses"]
    assert len(loss) == 1 and np.isfinite(loss[0])


def test_trainer_depth_cuts_the_encoder_with_the_decoder(tmp_path):
    """``TrainerConfig(layers=)`` cuts whisper's encoder to the decoder's
    depth (a width is never cut); a decoder-only model keeps no encoder."""
    for arch, enc in ((AUDIO, 1), (SSM, 0)):
        t = Trainer(TrainerConfig(arch=arch, reduced=True, layers=1,
                                  out=str(tmp_path / arch), device="cpu",
                                  async_flush=False), cost_model=CM)
        assert (t.cfg.num_layers, t.cfg.encoder_layers) == (1, enc)
        assert t.cfg.d_model == jax_get_reduced(arch).d_model
        leaves = t._ckpt_state()
        assert {v.shape[0] for k, v in leaves.items()
                if k.startswith(("p/decoder/", "p/encoder/"))} == {1}
        assert any(k.startswith("p/encoder/") for k in leaves) == bool(enc)
