"""The port's trainer (``repro_torch.launch``) against the JAX package's.

Train steps from the same parameters and batches, crash/resume exactly
once, and checkpoints that one package writes and the other resumes.
Everything runs on the CPU at the reduced tinyllama-1.1b size.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro.launch.train import flatten_state as jax_flatten
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.core.costmodel import PMemCostModel
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.persistence import (AsyncFlusher, CheckpointConfig,
                                     CheckpointManager, to_numpy)
from repro_torch.persistence.state import flatten_state, trainer_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CM = PMemCostModel(hbm_read_bw_gbps=819.0)
#: a small run: checkpoints at step 2, crashes (when asked) at step 3
RUN = dict(arch="tinyllama-1.1b", reduced=True, steps=4, batch=2, seq=32,
           ckpt_every=2)


def port_trainer(out, **kw) -> Trainer:
    return Trainer(TrainerConfig(out=str(out), device="cpu",
                                 **dict(RUN, **kw)), cost_model=CM)


def jax_trainer(out, **kw) -> JaxTrainer:
    return JaxTrainer(JaxTrainerConfig(out=str(out), **dict(RUN, **kw)))


def assert_same_bytes(got: dict, want: dict) -> None:
    """Two flat numpy states hold the same keys, in the same order, with
    the same dtypes, shapes and bytes."""
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].reshape(-1).view(np.uint8),
                                      want[k].reshape(-1).view(np.uint8),
                                      err_msg=k)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's run to its checkpoint at step 2: its directory and
    its state there."""
    out = tmp_path_factory.mktemp("jax_run")
    t = jax_trainer(out, steps=2, async_flush=False)
    t.run()
    assert t.wal.last.step == 2
    return out, dict(t._ckpt_state())


def test_three_train_steps_match_jax():
    cfg = jax_get_reduced("tinyllama-1.1b")
    jp = jax_init_params(cfg, jax.random.key(0))
    jo = jax_adamw_init(jp)
    flat = {f"p/{k}": v for k, v in jax_flatten(jp).items()}
    flat.update({f"o/{k}": v for k, v in jax_flatten(jo).items()})
    tp, to = trainer_state(flat, device="cpu")
    jstep = jax.jit(jax_build_train_step(cfg))
    tstep = build_train_step(cfg)
    for cursor in range(3):
        b = synthetic_batch(cfg, 2, 32, cursor)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert float(tm["lr_scale"]) == float(jm["lr_scale"])
        # the loss within 1e-3 relative (measured: at most 9.1e-5), the
        # gradient norm within 2e-2 (bf16 gradients; measured: at most
        # 2.0e-3)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2)
    assert int(to["count"]) == int(jo["count"]) == 3
    jflat = {f"p/{k}": np.asarray(v) for k, v in jax_flatten(jp).items()}
    jflat.update({f"o/{k}": np.asarray(v) for k, v in jax_flatten(jo).items()})
    tflat = {f"p/{k}": v for k, v in flatten_state(tp).items()}
    tflat.update({f"o/{k}": v for k, v in flatten_state(to).items()})
    assert list(tflat) == list(jflat)
    for k, t in tflat.items():
        want = jflat[k].astype(np.float32)
        got = t.float().numpy()
        if k.startswith("p/"):
            # step 0 runs at lr 0 and steps 1-2 at 1 and 2 % of the peak
            # rate, so the bf16 parameters move by a few ulps at most: they
            # agree to a relative L2 error of 1e-3 (measured: 4.4e-6)
            tol = 1e-3
        else:
            # the moments are sums of bf16 gradients: within the gradient
            # tolerance of tests/test_torch_model.py (measured: 0.021)
            tol = 3e-2
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < tol, (k, err)


def test_trainer_crashes_and_resumes_exactly_once(tmp_path):
    t1 = port_trainer(tmp_path, async_flush=False)
    r1 = t1.run(crash_at=3)
    assert r1["crashed_at"] == 3 and len(r1["losses"]) == 3
    assert t1.wal.last.step == 3
    assert all(np.isfinite(r1["losses"]))

    t2 = port_trainer(tmp_path, async_flush=True)
    assert t2.start_step == 2
    r2 = t2.run()
    # the same parameters and batch on the same CPU: the same loss
    assert r2["losses"][0] == r1["losses"][2]
    assert r2["steps"] == 2 and t2.wal.last.step == 4
    (rep,) = r2["ckpt_reports"]
    assert rep["step"] == 4 and rep["pages_cow"] > 0
    # a fresh manager restores the async save's bytes
    step, got = CheckpointManager(
        str(tmp_path / "ckpt.pmem"), CheckpointConfig(page_size=128 * 1024),
        device="cpu", cost_model=CM).restore()
    assert step == 4
    live = t2._ckpt_state()
    assert set(got) == set(live)
    assert all(torch.equal(got[k], live[k]) for k in live)


def test_resume_from_a_jax_checkpoint(jax_run, tmp_path):
    src, want = jax_run
    for d in ("port", "jax"):
        shutil.copytree(src, tmp_path / d)
    t = port_trainer(tmp_path / "port", steps=3, async_flush=False)
    assert t.start_step == 2
    assert t.wal.last.step == 2          # the JAX trainer's WAL
    assert_same_bytes(to_numpy(t._ckpt_state()), want)
    # the port's step 2 from the JAX state against the JAX trainer's own
    # step 2 after the same resume (loss within 1e-3 relative; measured:
    # 6.0e-5)
    jt = jax_trainer(tmp_path / "jax", steps=3, async_flush=False)
    assert jt.start_step == 2
    jl = jt.run()["losses"]
    tl = t.run()["losses"]
    assert len(tl) == len(jl) == 1
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-3)


def test_jax_resumes_from_a_port_checkpoint(tmp_path):
    t = port_trainer(tmp_path, steps=2, async_flush=False)
    t.run()
    want = to_numpy(t._ckpt_state())
    jt = jax_trainer(tmp_path, steps=3, async_flush=False)
    assert jt.start_step == 2
    assert jt.wal.last.step == 2          # the port's WAL
    got = {k: np.asarray(v) for k, v in jt._ckpt_state().items()}
    assert_same_bytes(got, want)
    assert got["p/embed"].dtype == ml_dtypes.bfloat16
    assert got["o/count"].dtype == np.int32 and got["o/count"].shape == ()


def test_ckpt_state_key_order_is_the_reference(jax_run, tmp_path):
    _, want = jax_run
    state = port_trainer(tmp_path)._ckpt_state()
    assert list(state) == list(want)
    assert len(state) == 37
    assert list(state)[:1] == ["p/decoder/seg0/b0/attn/wk"]
    assert [k for k in state if k.startswith("o/")][0] == "o/count"
    for k, t in to_numpy(state).items():
        assert t.shape == want[k].shape and t.dtype == want[k].dtype, k


def test_wal_generations_resume(tmp_path):
    t1 = port_trainer(tmp_path, async_flush=False, wal_gen_sets=2,
                      wal_capacity_steps=8)
    assert t1.wal.generational
    t1.run(crash_at=3)
    t2 = port_trainer(tmp_path, async_flush=False, wal_gen_sets=2,
                      wal_capacity_steps=8)
    assert t2.start_step == 2 and t2.wal.last.step == 3
    t2.run()
    assert t2.wal.last.step == 4


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainerConfig(out=str(tmp_path)), cost_model=CM)
    assert not os.listdir(tmp_path)


def test_train_module_runs_as_a_program(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--reduced", "--steps", "2", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--out", str(tmp_path)]
    for _ in range(2):    # the second run resumes at the last step
        out = subprocess.run(args, capture_output=True, text=True,
                             timeout=240, env=env)
        assert out.returncode == 0, out.stderr
    assert "restored checkpoint @ step 2" in out.stdout
    assert '"steps": 0' in out.stdout


# ------------------------------------------------------------- AsyncFlusher

def small_state(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"p/w": torch.randn(300, 70, generator=g).to(torch.bfloat16),
            "o/count": torch.tensor(seed, dtype=torch.int32)}


def cpu_manager(path) -> CheckpointManager:
    return CheckpointManager(str(path), CheckpointConfig(page_size=16384),
                             device="cpu", cost_model=CM)


def test_flusher_reports_come_in_submission_order(tmp_path):
    f = AsyncFlusher(cpu_manager(tmp_path / "c.pmem"))
    for step in (1, 2, 3):
        f.submit(step, small_state(step))
    assert [r.step for r in f.wait()] == [1, 2, 3]
    assert [r.step for r in f.close()] == [1, 2, 3]


def test_flusher_stages_a_copy(tmp_path):
    m = cpu_manager(tmp_path / "c.pmem")
    f = AsyncFlusher(m)
    state = small_state(5)
    want = {k: v.clone() for k, v in state.items()}
    staged = f.stage(state)
    assert all(staged[k].data_ptr() != state[k].data_ptr() for k in state)
    f.submit(5, state)
    for t in state.values():     # the loop moves on right after submit
        t.add_(1)
    f.wait()
    step, got = m.restore()
    assert step == 5
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_flusher_reraises_a_worker_error(tmp_path):
    f = AsyncFlusher(cpu_manager(tmp_path / "c.pmem"))
    f.submit(1, small_state(1))
    f.submit(2, {"p/other": torch.zeros(4)})   # another key set: refused
    with pytest.raises(ValueError, match="state keys changed"):
        f.wait()
    assert [r.step for r in f.reports] == [1]
    with pytest.raises(ValueError, match="state keys changed"):
        f.close()


def test_flusher_close_drains_and_stops_its_worker(tmp_path):
    m = cpu_manager(tmp_path / "c.pmem")
    f = AsyncFlusher(m)
    for step in (1, 2, 3, 4):    # more than MAX_PENDING: submit blocks
        f.submit(step, small_state(step))
    assert [r.step for r in f.close()] == [1, 2, 3, 4]
    assert not f._worker.is_alive()
    step, got = m.restore()
    assert step == 4 and int(got["o/count"]) == 4
