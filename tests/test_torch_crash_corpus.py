"""The crash corpus, replayed on the port.

The port's own copies of the crash runners of ``tests/corpus_runner.py``.

The checkpoint runners (``run_ckpt_fused_crash``: a save's epoch drain
killed mid-flush, then a device crash with an arbitrary eviction subset;
``run_restore_fused_crash``: a device crash, then a restore killed
mid-leaf-assembly) run on CPU tensors through
``repro_torch.persistence.CheckpointManager``, each under
``kernel_impl="fused"`` and ``"staged"``, and each case must also recover
the same ``(crashed, step, bytes)`` as the JAX package's runner on the
same case: that runner runs unchanged, and what each of its two arms
returns is read as it returns (``sys.setprofile``).

The KV, serve and cluster runners (``run_kv_crash``, ``run_serve_crash``,
``run_cluster_crash``) are written once over a package's classes and run
each case under ``repro`` and under ``repro_torch``: the invariants must
hold on both, and after the crash, the reopen and the resume every
pool's durable bytes (and every flash device's) must be equal.

All of them replay the checked-in cases of ``tests/test_crash_corpus.py``.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import corpus_runner
import repro.cluster
import repro.core
import repro.core.ssd
import repro.pool
import repro.serve
import repro_torch.cluster
import repro_torch.core
import repro_torch.core.ssd
import repro_torch.pool
import repro_torch.serve
from repro_torch.core.costmodel import PMemCostModel
from repro_torch.persistence import (CheckpointConfig, CheckpointManager,
                                     from_numpy, to_numpy)
from test_crash_corpus import (CKPT_FUSED_CORPUS, CLUSTER_CORPUS,
                               CLUSTER_STALE_WAL_CORPUS, CLUSTER_WIDTH_CORPUS,
                               KV_CORPUS, RESTORE_FUSED_CORPUS, SERVE_CORPUS,
                               _ops)

CM = PMemCostModel(hbm_read_bw_gbps=819.0)


class SimCrash(BaseException):
    """Raised by the failpoint to cut a protocol mid-flight. Derived from
    BaseException so no protocol-level handler can eat it."""


class CrashAt:
    """Failpoint callable: crash at the Nth protocol point reached."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.seen = 0

    def __call__(self, point: str) -> None:
        self.seen += 1
        if self.seen == self.n:
            raise SimCrash(point)


def manager(path, impl) -> CheckpointManager:
    cfg = CheckpointConfig(page_size=128 * 1024, manifest_capacity=1 << 16,
                           kernel_impl=impl)
    return CheckpointManager(path, cfg, device="cpu", cost_model=CM)


def outcome(crashed, step, got):
    return crashed, step, {k: v.tobytes() for k, v in
                           sorted(to_numpy(got).items())}


def assert_state_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), \
            (what, k)


def run_ckpt_fused_crash(tmpdir, sparse_positions, crash_step, seed, prob):
    """The port's ``corpus_runner.run_ckpt_fused_crash``: saves full →
    full rewrite → sparse → sparse (the µLog path); the last save's epoch
    drain dies after ``crash_step - 1`` page flushes, the device crashes
    with an eviction subset drawn from ``seed`` and ``prob``, and a fresh
    manager restores. Both kernel arms recover the same committed cut,
    byte for byte; returns ``(crashed, step, bytes)``."""

    def one_run(impl):
        path = os.path.join(tmpdir, "ckpt-%s.pmem" % impl)
        m = manager(path, impl)
        base = np.random.default_rng(7).standard_normal(131072)
        s = from_numpy({"w": base.astype(np.float32)}, "cpu")  # 4 pages
        m.save(0, s)
        s = {"w": s["w"] + 1.0}                      # full rewrite
        m.save(1, s)
        s = {"w": s["w"].clone()}                    # sparse #1 (CoW)
        for p in sparse_positions:
            s["w"][p] += 1.0
        m.save(2, s)
        committed = {k: v.clone() for k, v in s.items()}
        s = {"w": s["w"].clone()}                    # sparse #2 → µLog
        for p in sparse_positions:
            s["w"][p] += 1.0
        fp = CrashAt(crash_step)
        orig = m._flushq._flush_fn

        def failing(pid, page, dirty, active):
            fp("ckpt_page_flush")
            return orig(pid, page, dirty, active)

        m._flushq._flush_fn = failing
        crashed = False
        try:
            rep = m.save(3, s)
        except SimCrash:
            crashed = True
        m.pmem.crash(rng=np.random.default_rng(seed), evict_prob=prob)

        step, got = manager(path, impl).restore()
        if crashed:
            assert step == 2
            want = committed
        else:
            assert step == 3 and rep.pages_mulog >= 1
            want = s
        assert_state_equal(got, want, (impl, step))
        return outcome(crashed, step, got)

    fused = one_run("fused")
    staged = one_run("staged")
    assert fused == staged, \
        "recovery diverged between the fused and staged scan pipelines"
    return fused


def run_restore_fused_crash(tmpdir, sparse_positions, crash_step, seed,
                            prob):
    """The port's ``corpus_runner.run_restore_fused_crash``: two saves of
    three leaves, a device crash, then a restore killed after
    ``crash_step - 1`` leaf assemblies (``_fused_assemble`` or
    ``_staged_assemble``). Restore is read-only, so a fresh manager
    recovers the committed step byte for byte under both arms; returns
    ``(crashed, step, bytes)``."""

    def one_run(impl):
        path = os.path.join(tmpdir, "restore-%s.pmem" % impl)
        m = manager(path, impl)
        base = np.random.default_rng(11).standard_normal(131072)
        s = from_numpy({"w": base.astype(np.float32),            # 512 KiB
                        "b": np.arange(8192, dtype=np.float32),  # 32 KiB
                        "step_mask": np.arange(4096, dtype=np.uint32)},
                       "cpu")
        m.save(0, s)
        s = {k: v.clone() for k, v in s.items()}
        for p in sparse_positions:
            s["w"][p] += 1.0
        m.save(1, s)
        committed = {k: v.clone() for k, v in s.items()}
        m.pmem.crash(rng=np.random.default_rng(seed), evict_prob=prob)

        m2 = manager(path, impl)
        fp = CrashAt(crash_step)
        for name in ("_fused_assemble", "_staged_assemble"):
            orig = getattr(m2, name)

            def failing(pages, csums, verify, _orig=orig):
                fp("restore_apply")
                return _orig(pages, csums, verify)

            setattr(m2, name, failing)
        crashed = False
        try:
            step, got = m2.restore()
        except SimCrash:
            crashed = True
        if not crashed:
            assert step == 1
            assert_state_equal(got, committed, impl)

        step3, got3 = manager(path, impl).restore()
        assert step3 == 1
        assert_state_equal(got3, committed, impl)
        return outcome(crashed, step3, got3)

    fused = one_run("fused")
    staged = one_run("staged")
    assert fused == staged, \
        "restore recovery diverged between fused and staged apply"
    return fused


def jax_outcomes(runner, *args):
    """Run the JAX package's ``runner`` from ``tests/corpus_runner.py`` as
    it is (with its own assertions) and return what its fused and staged
    arms (its inner ``one_run``) returned."""
    seen = []

    def watch(frame, event, arg):
        code = frame.f_code
        if (event == "return" and code.co_name == "one_run"
                and code.co_filename == corpus_runner.__file__):
            seen.append(arg)

    sys.setprofile(watch)
    try:
        runner(*args)
    finally:
        sys.setprofile(None)
    assert len(seen) == 2
    return seen


@pytest.mark.parametrize("positions,step,seed,prob", CKPT_FUSED_CORPUS)
def test_ckpt_fused_crash_corpus_on_the_port(tmp_path, positions, step,
                                             seed, prob):
    (tmp_path / "port").mkdir()
    got = run_ckpt_fused_crash(str(tmp_path / "port"), positions, step,
                               seed, prob)
    want = jax_outcomes(corpus_runner.run_ckpt_fused_crash,
                        str(tmp_path), positions, step, seed, prob)
    assert want == [got, got]


@pytest.mark.parametrize("positions,step,seed,prob", RESTORE_FUSED_CORPUS)
def test_restore_fused_crash_corpus_on_the_port(tmp_path, positions, step,
                                                seed, prob):
    (tmp_path / "port").mkdir()
    got = run_restore_fused_crash(str(tmp_path / "port"), positions, step,
                                  seed, prob)
    want = jax_outcomes(corpus_runner.run_restore_fused_crash,
                        str(tmp_path), positions, step, seed, prob)
    assert want == [got, got]


# ============================================ KV, serve and cluster corpora

def package(root, kv_kw, cluster_kw):
    """What the runners below take of one package: its classes, and the
    keywords its engines (``kv``) and clusters (``cluster``) take."""
    return types.SimpleNamespace(
        name=root.__name__, KVConfig=root.core.KVConfig, PMem=root.core.PMem,
        PersistentKV=root.core.PersistentKV, Pool=root.pool.Pool,
        SSD=root.core.ssd.SSD, ClusterConfig=root.cluster.ClusterConfig,
        ClusterKV=root.cluster.ClusterKV, serve=root.serve, kv=kv_kw,
        cluster=cluster_kw)


PKGS = [package(repro, {}, {}),
        package(repro_torch, {"cost_model": CM},
                {"device": "cpu", "cost_model": CM})]


def durable_bytes(pmems, ssds=()):
    """Every device's durable bytes, in order."""
    return ([pm.durable_view().tobytes() for pm in pmems]
            + [d.durable_read(0, d.size).tobytes() for d in ssds])


def run_kv_crash_on(P, technique, ops, ckpt_every, seed, prob):
    """``corpus_runner.run_kv_crash`` over package ``P``: every committed
    put survives an arbitrary crash. Returns the durable bytes after the
    reopen."""
    cfg = P.KVConfig(npages=4, page_size=1024, value_size=64,
                     technique=technique, log_capacity=1 << 15)
    pm = P.PMem(P.PersistentKV.region_bytes(cfg))
    pm.memset_zero()
    with pytest.warns(DeprecationWarning):
        kv = P.PersistentKV(pm, cfg, **P.kv)
    expected = {}
    for i, (k, v) in enumerate(ops):
        value = bytes([(v + j) % 256 for j in range(64)])
        kv.put(k, value)
        expected[k] = value
        if ckpt_every and (i + 1) % ckpt_every == 0:
            kv.checkpoint()
    pm.crash(rng=np.random.default_rng(seed), evict_prob=prob)
    with pytest.warns(DeprecationWarning):
        kv2 = P.PersistentKV.open(pm, cfg, **P.kv)
    for k, value in expected.items():
        assert kv2.get(k) == value
    return durable_bytes([pm])


def run_serve_crash_on(P, n_requests, wl_seed, crash_step, seed, prob, *,
                       admission=True, slo_us=500.0):
    """``corpus_runner.run_serve_crash`` over package ``P``: the front end
    crashed inside a request batch, then the device; per tenant the
    recovered KV holds exactly the replay of a contiguous prefix of the
    applied puts, at least through the last committed batch. Returns
    ``(crashed, durable bytes after the reopen)``."""
    S = P.serve
    cfg = P.KVConfig(npages=8, page_size=1024, value_size=64,
                     log_capacity=1 << 17, wal_lanes=2, wal_group_commit=2,
                     wal_gen_sets=2, auto_checkpoint=False)
    pool = P.Pool.create(None, 2 * P.PersistentKV.region_bytes(cfg)
                         + (1 << 21), sockets=2)
    tenants = [
        S.TenantSpec(name="t0", clients=40, rate=40_000.0,
                     get_frac=0.4, put_frac=0.6),
        S.TenantSpec(name="t1", clients=40, rate=40_000.0,
                     get_frac=0.3, put_frac=0.5, scan_frac=0.2, scan_len=4),
    ]
    reqs = S.generate(tenants, nkeys=cfg.nkeys, duration_s=0.2,
                      seed=wl_seed, limit=n_requests)
    assert len(reqs) == n_requests
    fe = S.ServeFrontend(pool, tenants, cfg,
                         slo=S.SLOConfig(p99_target_us=slo_us),
                         admission=admission, failpoints=CrashAt(crash_step),
                         record_applied=True, **P.kv)
    crashed = False
    try:
        fe.run(reqs)
    except SimCrash:
        crashed = True
    if crash_step > 2 * n_requests:
        assert not crashed

    pool.pmem.crash(rng=np.random.default_rng(seed), evict_prob=prob)
    pool2 = P.Pool.open(pmem=pool.pmem)
    for tname in ("t0", "t1"):
        kv2 = pool2.kv(tname, cfg, **P.kv)
        applied = [(k, v) for (t, k, v) in fe.applied_puts if t == tname]
        floor = fe.committed_puts(tname)
        m = len(kv2.wal.recovered.entries)
        assert floor <= m <= len(applied), (tname, floor, m, len(applied))
        expected = dict(applied[:m])
        zero = bytes(cfg.value_size)
        for k in range(cfg.nkeys):
            assert kv2.get(k) == expected.get(k, zero), (tname, k)
    return crashed, durable_bytes([pool.pmem])


def run_cluster_crash_on(P, nshards, new_nshards, n_ops, ckpt, crash_step,
                         seed, prob, *, tiered=False, ssd_keep=1.0,
                         resume_interleave=False, width=1, devices=None):
    """``corpus_runner.run_cluster_crash`` over package ``P``: a view
    change crashed at a protocol point, then every device; each range is
    owned by exactly its old or its new owner, every committed put reads
    back, ``resume`` converges re-moving only unflipped ranges, the
    sources are scrubbed, and (``resume_interleave``) a second crash
    replays no stale WAL residue. Each assertion names its invariant.
    ``devices`` (a list) receives ``(pmems, ssds)`` as soon as the
    devices exist. Returns ``(crashed, durable bytes at the end)``."""
    kv_kw = dict(npages=8, page_size=512, value_size=32,
                 log_capacity=1 << 15)
    if tiered:
        kv_kw["slot_budget"] = 4
    cfg = P.ClusterConfig(kv=P.KVConfig(**kv_kw), n_ranges=8)
    all_sids = range(max(nshards, new_nshards))
    meta = P.Pool.create(None, P.ClusterKV.meta_pool_bytes(cfg))
    pools, ssds = {}, {}
    for sid in all_sids:
        pools[sid] = P.Pool.create(None, P.ClusterKV.shard_pool_bytes(cfg)
                                   + (1 << 18 if tiered else 0))
        if tiered:
            ssds[sid] = P.SSD(1 << 23)
            pools[sid].attach_ssd(ssds[sid])
    pmems = [meta.pmem] + [pools[sid].pmem for sid in sorted(pools)]
    flash = [ssds[sid] for sid in sorted(ssds)]
    if devices is not None:
        devices.append((pmems, flash))
    c = P.ClusterKV(meta, pools, cfg, shards=range(nshards), **P.cluster)

    expected = {}
    x = (seed & 0x7FFFFFFF) or 1
    for i in range(n_ops):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        k = x % cfg.nkeys
        value = bytes(((x >> 7) + i + j) % 256 for j in range(32))
        c.put(k, value)
        expected[k] = value
        if ckpt and (i + 1) % ckpt == 0:
            c.checkpoint()
    c.commit()

    target = sorted(range(new_nshards))
    pre_owner = dict(c.map.owners())
    goal = c.map.assignment(target)
    c.failpoints = CrashAt(crash_step)
    crashed = False
    try:
        c.reshard(target, width=width)
    except SimCrash:
        crashed = True
    c.failpoints = None

    def crash_all(rng):
        meta.pmem.crash(rng=rng, evict_prob=prob)
        for sid in sorted(pools):
            pools[sid].pmem.crash(rng=rng, evict_prob=prob)
            if tiered:
                ssds[sid].crash(rng=rng, keep_prob=ssd_keep)

    def reopen():
        pools2 = {}
        for sid, p in pools.items():
            pools2[sid] = P.Pool.open(pmem=p.pmem)
            if tiered:
                pools2[sid].attach_ssd(ssds[sid])
        return P.ClusterKV.open(P.Pool.open(pmem=meta.pmem), pools2, cfg,
                                **P.cluster)

    crash_all(np.random.default_rng(seed))
    c2 = reopen()

    owners_after_crash = dict(c2.map.owners())
    for r in range(cfg.n_ranges):
        assert owners_after_crash[r] in (pre_owner[r], goal[r]), \
            ("exactly one owner", r)
    if not crashed:
        assert owners_after_crash == goal, "owners after a clean run"
        assert c2.map.pending is None, "no pending view after a clean run"

    zero = bytes(cfg.kv.value_size)
    for k in range(cfg.nkeys):
        if k in expected:
            assert c2.get(k) == expected[k], ("committed value after the "
                                               "reopen", k)
        else:
            try:
                got = c2.get(k)
            except KeyError:
                continue
            assert got == zero, ("unwritten key after the reopen", k)

    if resume_interleave:
        still_moving = [r for r in range(cfg.n_ranges)
                        if owners_after_crash[r] != goal[r]]
        keys_per_range = cfg.pages_per_range * cfg.kv.recs_per_page
        for r in still_moving:
            for k in range(r * keys_per_range, (r + 1) * keys_per_range):
                x = (1103515245 * x + 12345) & 0x7FFFFFFF
                value = bytes(((x >> 9) + k + j) % 256 for j in range(32))
                c2.put(k, value)
                expected[k] = value
        c2.commit()
        for sid in sorted({owners_after_crash[r] for r in still_moving}):
            c2.engine(sid).checkpoint()

    rep = c2.resume(width=width)
    if rep is not None:
        already_flipped = {r for r in range(cfg.n_ranges)
                           if owners_after_crash[r] == goal[r]
                           and pre_owner[r] != goal[r]}
        assert set(rep.ranges_moved).isdisjoint(already_flipped), \
            "resume re-moved a flipped range"
    assert c2.map.pending is None, "no pending view after resume"
    assert dict(c2.map.owners()) == goal, "owners after resume"
    assert tuple(c2.map.shards) == tuple(target), "shards after resume"
    for k, value in expected.items():
        assert c2.get(k) == value, ("committed value after resume", k)

    ppr = cfg.pages_per_range
    for r in range(cfg.n_ranges):
        if goal[r] == pre_owner[r]:
            continue
        eng = c2.engine(pre_owner[r])
        for pid in range(r * ppr, (r + 1) * ppr):
            assert eng.durable_page_image(pid) is None, ("scrubbed source",
                                                         r, pid)

    if resume_interleave:
        crash_all(np.random.default_rng(seed + 1))
        c3 = reopen()
        assert c3.map.pending is None, "no pending view after the restart"
        assert dict(c3.map.owners()) == goal, "owners after the restart"
        for k, value in expected.items():
            assert c3.get(k) == value, ("committed value after the restart",
                                        k)
    return crashed, durable_bytes(pmems, flash)


def on_both(runner, *args, **kw):
    """``runner`` under each package; the two outcomes must be equal."""
    got = [runner(P, *args, **kw) for P in PKGS]
    assert got[1] == got[0], "the port's durable bytes differ"
    return got[0]


@pytest.mark.parametrize("technique,ops_seed,n,ckpt,seed,prob", KV_CORPUS)
def test_kv_crash_corpus_on_the_port(technique, ops_seed, n, ckpt, seed,
                                     prob):
    on_both(run_kv_crash_on, technique, _ops(ops_seed, n), ckpt, seed, prob)


@pytest.mark.parametrize(
    "n,wseed,step,seed,prob,admission,slo", SERVE_CORPUS)
def test_serve_crash_corpus_on_the_port(n, wseed, step, seed, prob,
                                        admission, slo):
    crashed, _ = on_both(run_serve_crash_on, n, wseed, step, seed, prob,
                         admission=admission, slo_us=slo)
    assert crashed == (step <= 2 * n)


@pytest.mark.parametrize(
    "nsh,new,n,ckpt,step,seed,prob,tiered,skeep", CLUSTER_CORPUS)
def test_cluster_crash_corpus_on_the_port(nsh, new, n, ckpt, step, seed,
                                          prob, tiered, skeep):
    crashed, _ = on_both(run_cluster_crash_on, nsh, new, n, ckpt, step,
                         seed, prob, tiered=tiered, ssd_keep=skeep)
    assert crashed == (step != 99)


@pytest.mark.parametrize(
    "nsh,new,n,ckpt,step,seed,prob,width", CLUSTER_WIDTH_CORPUS)
def test_cluster_width_crash_corpus_on_the_port(nsh, new, n, ckpt, step,
                                                seed, prob, width):
    crashed, _ = on_both(run_cluster_crash_on, nsh, new, n, ckpt, step,
                         seed, prob, width=width)
    assert crashed == (step != 99)


@pytest.mark.parametrize(
    "nsh,new,n,ckpt,step,seed,prob,tiered,skeep", CLUSTER_STALE_WAL_CORPUS)
def test_cluster_stale_wal_corpus_on_the_port(nsh, new, n, ckpt, step, seed,
                                              prob, tiered, skeep):
    assert on_both(run_cluster_crash_on, nsh, new, n, ckpt, step, seed,
                   prob, tiered=tiered, ssd_keep=skeep,
                   resume_interleave=True)[0]


def test_cluster_stale_wal_concurrent_driver_on_the_port():
    assert on_both(run_cluster_crash_on, 2, 4, 48, 0, 7, 7309, 0.5,
                   width=2, resume_interleave=True)[0]


#: hypothesis's falsifying example of the reference's
#: ``tests/test_cluster_props.py::test_reshard_crash_tiered_source``:
#: (nshards, new_nshards, n_ops, ckpt, crash_step, seed, prob), tiered,
#: the crash dropping every unflushed flash write
TIERED_FAULT = (3, 4, 48, 8, 1, 4, 0.0)


def test_tiered_reshard_fault_is_the_reference_s():
    """The reference loses a committed value when a tiered engine that
    checkpointed reopens after a reshard began (ROADMAP.md §3). The port's
    copy must fail the same invariant at the same key, with the same
    durable bytes; when the reference is repaired, this test fails until
    the port follows."""
    with pytest.raises(AssertionError) as ref:
        corpus_runner.run_cluster_crash(*TIERED_FAULT, tiered=True,
                                        ssd_keep=0.0)
    key = ref.value.args[0]
    out = []
    for P in PKGS:
        devices = []
        with pytest.raises(AssertionError) as err:
            run_cluster_crash_on(P, *TIERED_FAULT, tiered=True, ssd_keep=0.0,
                                 devices=devices)
        out.append((str(err.value), durable_bytes(*devices[0])))
    # the message's first line is the invariant's name and the key; the
    # rest shows the value read and the value committed
    assert out[0][0].splitlines()[0] == repr(
        ("committed value after the reopen", key))
    assert out[1] == out[0]
