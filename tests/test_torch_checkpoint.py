"""The port's checkpoint path (``device="cpu"``) against the JAX package's.

The same numpy state, made from a seed, is saved by both managers: the
durable pool images, the manifests and the reports must be identical
(both cost models at 819.0 GB/s, the JAX package's constant, so the
reports compare), and each package must restore the other's checkpoint.
"""

import dataclasses
import json
import math

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.ssd import SSD as JaxSSD
from repro.models import init_params
from repro.persistence.checkpoint import CheckpointConfig as JaxConfig
from repro.persistence.checkpoint import CheckpointManager as JaxManager
from repro_torch.core.costmodel import COST_MODEL, PMemCostModel
from repro_torch.core.recovery import KVConfig, PersistentKV
from repro_torch.core.pmem import PMemStats
from repro_torch.core.ssd import SSD
from repro_torch.persistence import (
    CheckpointConfig,
    CheckpointManager,
    StepRecord,
    from_numpy,
    to_numpy,
)
from repro_torch.persistence.checkpoint import SaveReport
from repro_torch.persistence.state import TINYLLAMA_1_1B_PARAMS, init_state
from repro_torch.pool import Pool

PAGE = 128 * 1024
CM = PMemCostModel(hbm_read_bw_gbps=819.0)


def make_state(seed=0):
    """bf16 and f32 leaves, an int64 counter, and leaves whose byte sizes
    are not multiples of 4 (nor of the 4 KiB block)."""
    rng = np.random.default_rng(seed)
    return {
        "p/w_embed": rng.standard_normal((512, 64)).astype(ml_dtypes.bfloat16),
        "p/w_out": rng.standard_normal((64, 512)).astype(np.float32),
        "p/norm": rng.standard_normal((3,)).astype(ml_dtypes.bfloat16),
        "o/count": np.array([7], dtype=np.int64),
        "o/odd": rng.integers(0, 255, size=4099, dtype=np.uint8),
    }


def step_states(seed=0):
    """A full save, a sparse change, another sparse change (µLog)."""
    s0 = make_state(seed)
    s1 = {k: v.copy() for k, v in s0.items()}
    s1["p/w_out"][3, :] += 1.0
    s1["o/odd"][4000] ^= 0xFF
    s2 = {k: v.copy() for k, v in s1.items()}
    s2["p/w_out"][3, :] += 1.0
    s2["p/w_embed"][500, 0] = 2.5
    return [s0, s1, s2]


def port_manager(path, cfg, **kw):
    return CheckpointManager(path, cfg, device="cpu", cost_model=CM, **kw)


def manifests(m):
    return [json.loads(e.decode()) for e in m.manifest.recover().entries]


def assert_state_equal(got_np, want_np):
    assert set(got_np) == set(want_np)
    for k in want_np:
        assert got_np[k].dtype == want_np[k].dtype, k
        np.testing.assert_array_equal(got_np[k].view(np.uint8),
                                      want_np[k].view(np.uint8), err_msg=k)


@pytest.mark.parametrize("impl", ["auto", "staged"])
def test_pool_images_manifests_and_reports_match_jax(tmp_path, impl):
    cfg = dict(page_size=PAGE, manifest_capacity=1 << 16, kernel_impl=impl)
    jm = JaxManager(str(tmp_path / "jax.pmem"), JaxConfig(**cfg))
    pm = port_manager(str(tmp_path / "port.pmem"), CheckpointConfig(**cfg))
    kinds = []
    for step, st in enumerate(step_states()):
        jr = jm.save(step, st)
        pr = pm.save(step, from_numpy(st, "cpu"))
        assert dataclasses.asdict(pr) == dataclasses.asdict(jr)
        kinds.append((pr.pages_cow, pr.pages_mulog, pr.pages_clean))
        np.testing.assert_array_equal(pm.pmem.durable_view(),
                                      jm.pmem.durable_view())
    assert manifests(pm) == manifests(jm)
    assert manifests(pm)[0]["leaves"]["p/w_embed"]["dtype"] == "bfloat16"
    # the sequence exercised every page technique: CoW, µLog and clean
    assert kinds[0][0] > 0 and kinds[2][1] > 0 and kinds[1][2] > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_restore(tmp_path, writer):
    cfg = dict(page_size=PAGE, manifest_capacity=1 << 16)
    path = str(tmp_path / "ckpt.pmem")
    states = step_states(3)
    w = (JaxManager(path, JaxConfig(**cfg)) if writer == "jax"
         else port_manager(path, CheckpointConfig(**cfg)))
    for step, st in enumerate(states):
        w.save(step, st if writer == "jax" else from_numpy(st, "cpu"))
    if writer == "jax":
        rm = port_manager(path, CheckpointConfig(**cfg))
        step, got = rm.restore()
        assert all(t.device.type == "cpu" for t in got.values())
        got = to_numpy(got)
    else:
        rm = JaxManager(path, JaxConfig(**cfg))
        step, got = rm.restore()
    assert step == 2
    assert_state_equal(got, states[-1])


def test_restore_reports_match_jax(tmp_path):
    cfg = dict(page_size=PAGE, manifest_capacity=1 << 16)
    path = str(tmp_path / "ckpt.pmem")
    w = JaxManager(path, JaxConfig(**cfg))
    for step, st in enumerate(step_states(5)):
        w.save(step, st)
    jr = JaxManager(path, JaxConfig(**cfg))
    jr.restore()
    pr = port_manager(path, CheckpointConfig(**cfg))
    pr.restore()
    assert dataclasses.asdict(pr.last_restore) == \
        dataclasses.asdict(jr.last_restore)


def test_fused_and_staged_agree_on_the_port(tmp_path):
    reports, restored = {}, {}
    for impl in ("fused", "staged"):
        cfg = CheckpointConfig(page_size=PAGE, manifest_capacity=1 << 16,
                               kernel_impl=impl)
        m = port_manager(str(tmp_path / f"{impl}.pmem"), cfg)
        reports[impl] = [m.save(s, from_numpy(st, "cpu"))
                         for s, st in enumerate(step_states(7))]
        step, got = port_manager(str(tmp_path / f"{impl}.pmem"), cfg).restore()
        assert step == 2
        restored[impl] = to_numpy(got)
    for rf, rs in zip(reports["fused"], reports["staged"]):
        assert (rf.pages_cow, rf.pages_mulog, rf.pages_clean,
                rf.blocks_written) == (rs.pages_cow, rs.pages_mulog,
                                       rs.pages_clean, rs.blocks_written)
    assert reports["staged"][2].scan_read_bytes >= \
        2 * reports["fused"][2].scan_read_bytes > 0
    assert_state_equal(restored["fused"], restored["staged"])


def test_crash_before_manifest_commit_restores_previous(tmp_path):
    """Pages of save N+1 flushed, manifest not committed → restore N."""
    cfg = CheckpointConfig(page_size=PAGE, manifest_capacity=1 << 16)
    path = str(tmp_path / "s0.pmem")
    m = port_manager(path, cfg)
    s0, s1 = (from_numpy(make_state(s), "cpu") for s in (10, 11))
    m.save(0, s0)
    for name in sorted(s1):
        per_page, buf, _counts = m._dirty_lines_per_page(name, s1[name])
        rep = SaveReport(step=1)
        for i, pid in enumerate(m._leaf_pages[name]):
            page = np.zeros(cfg.page_size, dtype=np.uint8)
            chunk = buf[i * cfg.page_size:(i + 1) * cfg.page_size]
            page[:chunk.size] = chunk
            dirty = (set(range(cfg.blocks_per_page)) if per_page is None
                     else per_page.get(i, set()))
            if dirty or per_page is None:
                m._flush_page(pid, page, sorted(dirty), per_page is None, rep)
    m.pmem.fsync()
    m.pmem.crash(evict=lambda li: False)
    step, got = port_manager(path, cfg).restore()
    assert step == 0
    assert_state_equal(to_numpy(got), to_numpy(s0))


def test_slot_budget_spill_save_restore_matches_jax():
    rng = np.random.default_rng(0)
    state = {f"w{i}": rng.standard_normal((32, 32)).astype(np.float32)
             for i in range(6)}
    cfg = dict(page_size=16 * 1024, threads=2, pmem_slot_budget=3)
    jm = JaxManager(None, JaxConfig(**cfg), ssd=JaxSSD(1 << 26))
    pm = port_manager(None, CheckpointConfig(**cfg), ssd=SSD(1 << 26))
    for step in range(3):
        state["w0"] = state["w0"] + 1.0
        jr = jm.save(step, state)
        pr = pm.save(step, from_numpy(state, "cpu"))
        assert dataclasses.asdict(pr) == dataclasses.asdict(jr)
        assert pr.pages_spilled > 0 or step > 0
    step, restored = pm.restore()
    assert step == 2 and pm.last_restore.pages_spilled > 0
    assert_state_equal(to_numpy(restored), state)


def test_train_wal_recovers_last_step_on_the_port_pool(tmp_path):
    from repro_torch.persistence import TrainWAL
    path = str(tmp_path / "wal.pmem")
    pool = Pool.create(path, TrainWAL.capacity_for(64))
    wal = pool.wal("train_wal", capacity_steps=64)
    for s in range(1, 4):
        wal.commit_step(StepRecord(s, s * 8, (1, 2), 1.0 / s, 0.5, 1.0))
    pool.pmem.crash(evict=lambda li: False)
    rec = Pool.open(path).wal("train_wal")
    assert rec.last.step == 3 and rec.last.data_cursor == 24
    assert [r.step for r in rec.records] == [1, 2, 3]


def test_state_round_trip_keeps_bytes():
    flat = make_state(9)
    back = to_numpy(from_numpy(flat, "cpu"))
    assert_state_equal(back, flat)
    assert from_numpy(flat, "cpu")["p/w_embed"].dtype == torch.bfloat16


def test_tinyllama_leaf_table_matches_jax():
    cfg = get_config("tinyllama-1.1b")
    tree = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.key(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        want[key] = (tuple(leaf.shape), str(leaf.dtype))
    assert TINYLLAMA_1_1B_PARAMS == want
    assert sum(math.prod(s) * 2 for s, _ in want.values()) == 2_200_096_768


def test_init_state_cuts_depth_not_width():
    st = init_state({k: TINYLLAMA_1_1B_PARAMS[k]
                     for k in ("decoder/seg0/b0/norm1", "final_norm")},
                    seed=0, device="cpu", layers=2)
    assert st["p/decoder/seg0/b0/norm1"].shape == (2, 2048)
    assert st["p/final_norm"].shape == (2048,)
    again = init_state({k: TINYLLAMA_1_1B_PARAMS[k]
                        for k in ("decoder/seg0/b0/norm1", "final_norm")},
                       seed=0, device="cpu", layers=2)
    assert all(torch.equal(again[k], st[k]) for k in st)   # seeded


def test_manager_device_rules(tmp_path):
    cfg = CheckpointConfig(page_size=PAGE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CheckpointManager(None, cfg, cost_model=CM)
    with pytest.raises(TypeError):   # the card's read rate has no default
        CheckpointManager(None, cfg, device="cpu")
    with pytest.raises(TypeError):
        PMemCostModel()
    assert COST_MODEL.scan_read_ns(0) == 0.0
    with pytest.raises(ValueError, match="no device read rate"):
        COST_MODEL.scan_read_ns(1)        # a forgotten rate fails loudly
    with pytest.raises(ValueError, match="no device read rate"):
        COST_MODEL.engine_time_ns(PMemStats(), scan_read_bytes=4096)
    m = port_manager(None, cfg)
    with pytest.raises(TypeError):
        m.save(0, make_state(0))          # numpy leaves are refused
    kv = Pool.create(None, PersistentKV.region_bytes(KVConfig())).kv("kv")
    assert isinstance(kv, PersistentKV)   # Pool.kv opens the port's engine
    kv.put(0, bytes(64))
    with pytest.raises(ValueError, match="no device read rate"):
        Pool.open(pmem=kv.pmem).kv("kv")  # its WAL replay needs the rate

