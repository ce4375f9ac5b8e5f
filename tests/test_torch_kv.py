"""The port's KV engine and I/O engine against the JAX package's.

``repro_torch.core.recovery.PersistentKV`` and ``repro_torch.io.IOEngine``
are copies of their references (``tests/test_torch_copies.py``); here the
same seeded operations drive both packages side by side. Values, commit
LSNs, every durable pool byte after each checkpoint, and the
``RecoveryReport`` of a reopen after a device crash must be equal. The
port's engines price a reopen's WAL replay with
``PMemCostModel(hbm_read_bw_gbps=819.0)``, the JAX package's constant, so
the modeled times compare exactly.
"""

import dataclasses
import warnings

import numpy as np
import pytest

import repro.core.costmodel
import repro.core.recovery
import repro.core.ssd
import repro.io
import repro.pool
import repro_torch.core.recovery
import repro_torch.core.ssd
import repro_torch.io
import repro_torch.pool
from repro_torch.core.costmodel import PMemCostModel

CM = PMemCostModel(hbm_read_bw_gbps=819.0)

#: each package, with the keywords its engines take (the port's cost
#: model is the caller's)
PKGS = {"repro": (repro, {}),
        "repro_torch": (repro_torch, {"cost_model": CM})}
#: each package's cost model at 819 GB/s (the JAX package's default)
CMS = {"repro": repro.core.costmodel.COST_MODEL, "repro_torch": CM}

CONFIGS = {
    "classic": dict(technique="classic"),
    "header": dict(technique="header"),
    "zero": dict(technique="zero"),
    "tiered": dict(slot_budget=4),
    "wal_lanes": dict(wal_lanes=2, wal_group_commit=4),
    "cache_frames": dict(cache_frames=3),
}


def kv_cfg(pkg, **kw):
    kw.setdefault("log_capacity", 1 << 14)
    return pkg.core.recovery.KVConfig(npages=8, page_size=1024,
                                      value_size=64, **kw)


def make_pool(pkg, cfg):
    size = pkg.core.recovery.PersistentKV.region_bytes(cfg)
    pool = pkg.pool.Pool.create(None, size + (1 << 18))
    ssd = None
    if cfg.tiered:
        ssd = pkg.core.ssd.SSD(1 << 22)
        pool.attach_ssd(ssd)
    return pool, ssd


def read(kv, key):
    try:
        return kv.get(key)
    except KeyError:              # tiered: a page no tier holds yet
        return None


def read_all(kv, nkeys):
    return [read(kv, k) for k in range(nkeys)]


def durable(pool, ssd):
    img = [pool.pmem.durable_view().tobytes()]
    if ssd is not None:
        img.append(ssd.durable_read(0, ssd.size).tobytes())
    return img


def run_stream(name, config, seed, n_ops=120, ckpt_every=25):
    """Seeded puts, gets and checkpoints, a device crash and a reopen,
    under one package; returns everything the two packages must agree
    on."""
    pkg, kw = PKGS[name]
    cfg = kv_cfg(pkg, **CONFIGS[config])
    pool, ssd = make_pool(pkg, cfg)
    kv = pool.kv("kv", cfg, **kw)
    rng = np.random.default_rng(seed)
    seen = []
    for i in range(n_ops):
        key = int(rng.integers(cfg.nkeys))
        seen.append(("put", kv.put(key, rng.bytes(cfg.value_size))))
        if i % 7 == 3:
            seen.append(("get", read(kv, int(rng.integers(cfg.nkeys)))))
        if (i + 1) % ckpt_every == 0:
            kv.checkpoint()
            seen.append(("durable", durable(pool, ssd)))
    seen.append(("values", read_all(kv, cfg.nkeys)))
    crash = np.random.default_rng(seed + 1)
    pool.pmem.crash(rng=crash, evict_prob=0.5)
    if ssd is not None:
        ssd.crash(rng=crash, keep_prob=0.5)
    pool2 = pkg.pool.Pool.open(pmem=pool.pmem)
    if ssd is not None:
        pool2.attach_ssd(ssd)
    kv2 = pool2.kv("kv", cfg, **kw)
    seen.append(("recovery", dataclasses.asdict(kv2.last_recovery)))
    seen.append(("recovered", read_all(kv2, cfg.nkeys)))
    kv2.checkpoint()
    seen.append(("durable", durable(pool2, ssd)))
    return seen


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_kv_stream_matches_the_reference(config, seed):
    want = run_stream("repro", config, seed)
    got = run_stream("repro_torch", config, seed)
    assert [k for k, _ in got] == [k for k, _ in want]
    for i, ((kind, a), (_, b)) in enumerate(zip(got, want)):
        assert a == b, (config, i, kind)
    rec = dict(got)["recovery"]
    assert rec["wal_entries"] > 0 and rec["modeled_ns"] > 0


def test_kv_replay_without_a_device_rate_raises():
    """The port's module cost model has no device read rate: a reopen
    that replays records must be given one."""
    cfg = kv_cfg(repro_torch)
    pool, _ = make_pool(repro_torch, cfg)
    kv = pool.kv("kv", cfg)
    kv.put(3, bytes(range(64)))
    pool.pmem.crash(rng=np.random.default_rng(0), evict_prob=0.0)
    with pytest.raises(ValueError, match="device read rate"):
        repro_torch.pool.Pool.open(pmem=pool.pmem).kv("kv", cfg)
    kv2 = repro_torch.pool.Pool.open(pmem=pool.pmem).kv("kv", cfg,
                                                        cost_model=CM)
    assert kv2.get(3) == bytes(range(64))


def test_raw_pmem_constructor_matches_and_warns():
    """The deprecated ``PersistentKV(pmem, cfg)`` path, as the corpus
    uses it: same warning, same bytes, same recovery."""
    out = {}
    for name, (pkg, kw) in PKGS.items():
        cfg = kv_cfg(pkg)
        pm = pkg.core.pmem.PMem(
            pkg.core.recovery.PersistentKV.region_bytes(cfg))
        pm.memset_zero()
        with pytest.warns(DeprecationWarning):
            kv = pkg.core.recovery.PersistentKV(pm, cfg, **kw)
        for k in range(0, cfg.nkeys, 5):
            kv.put(k, bytes([k % 256]) * 64)
        pm.crash(rng=np.random.default_rng(4), evict_prob=0.4)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            kv2 = pkg.core.recovery.PersistentKV.open(pm, cfg, **kw)
        out[name] = (pm.durable_view().tobytes(),
                     dataclasses.asdict(kv2.last_recovery),
                     read_all(kv2, cfg.nkeys))
    assert out["repro_torch"] == out["repro"]


def test_region_bytes_match():
    for config in CONFIGS:
        sizes = {name: pkg.core.recovery.PersistentKV.region_bytes(
                     kv_cfg(pkg, **CONFIGS[config]))
                 for name, (pkg, _) in PKGS.items()}
        assert sizes["repro_torch"] == sizes["repro"], config


# ------------------------------------------------------------- IOEngine

def io_run(name, seed):
    """The engine's four front ends on one pool, seeded, under one
    package: a lane-striped group-commit log, a flush queue over a page
    region, a spill scheduler behind an overcommitted region, and the
    pool's cache; returns what the packages must agree on."""
    pkg, _ = PKGS[name]
    rng = np.random.default_rng(seed)
    pool = pkg.pool.Pool.create(None, 1 << 22)
    pool.attach_ssd(pkg.core.ssd.SSD(1 << 23))
    eng = pkg.io.IOEngine(pool, lanes=4, group_commit=8,
                          cost_model=CMS[name])
    seen = []

    wal = eng.multilog("wal", capacity=1 << 16)
    before = pool.stats.snapshot()
    for i in range(40):
        wal.append(rng.bytes(int(rng.integers(16, 96))))
    wal.commit()
    delta = pool.stats.delta(before)
    seen.append(("multilog", wal.lane_id_base, wal.lanes,
                 eng.modeled_ns(delta), eng.modeled_ns(delta, active_lanes=2),
                 eng.modeled_ns(delta, burst=True)))

    pages = pool.pages("heap", npages=8, page_size=4096, nslots=12)
    fq = eng.flush_queue(pages, lanes=3)
    for pid in range(8):
        fq.enqueue(pid, rng.integers(0, 256, 4096, dtype=np.uint8))
    seen.append(("epoch", dataclasses.asdict(fq.flush_epoch())))
    for pid in (1, 5):
        img = pages.read_page(pid).copy()
        img[64:192] ^= 0xFF
        fq.enqueue(pid, img, [1, 2])
    seen.append(("epoch", dataclasses.asdict(fq.flush_epoch())))

    sp = eng.spill_scheduler(name="sp", map_capacity=1 << 13)
    cold = pool.pages("cold", npages=24, page_size=512, nslots=6)
    sp.attach_pages(cold)
    fq2 = eng.flush_queue(cold, spill=sp)
    imgs = {pid: rng.integers(0, 256, 512, dtype=np.uint8)
            for pid in range(24)}
    for pid, img in imgs.items():
        fq2.enqueue(pid, img)
    seen.append(("spill", dataclasses.asdict(fq2.flush_epoch())))
    seen.append(("tiers", [sp.residency(cold.store, pid)
                           for pid in range(24)]))

    cache = eng.cache(frames=4)
    cache.attach_pages(cold, flushq=fq2, spill=sp)
    c0 = cache.stats.snapshot()
    got = [cache.get(pid, store=cold.store).tobytes()
           for pid in (0, 3, 0, 7, 3, 11, 0)]
    assert got[0] == imgs[0].tobytes()
    seen.append(("cache", got, dataclasses.asdict(cache.stats.delta(c0))))
    seen.append(("durable", pool.pmem.durable_view().tobytes(),
                 pool.ssd_dev.durable_read(0, pool.ssd_dev.size).tobytes()))
    return seen


@pytest.mark.parametrize("seed", [0, 3])
def test_io_engine_matches_the_reference(seed):
    want = io_run("repro", seed)
    got = io_run("repro_torch", seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == b, a[0]


def test_io_engine_lane_ids_do_not_overlap():
    pool = repro_torch.pool.Pool.create(None, 1 << 22)
    eng = repro_torch.io.IOEngine(pool, lanes=3)
    a = eng.multilog("a", capacity=1 << 14)
    b = eng.multilog("b", capacity=1 << 14, lanes=2)
    fq = eng.flush_queue(pool.pages("p", npages=4, page_size=4096))
    assert (a.lane_id_base, b.lane_id_base, fq.lane_id_base) == (0, 3, 5)
    with pytest.raises(ValueError):
        repro_torch.io.IOEngine(pool, lanes=0)
