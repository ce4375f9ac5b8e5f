"""The port's sharded cluster (``repro_torch.cluster``) against the JAX
package's.

The same seeded workload goes through a ``ClusterKV`` of each package;
then a view change grows or shrinks it. The ``ReshardReport``s, the
owners, every value and every pool's durable bytes (the meta pool's and
each shard's) must be equal. The port runs its migration copy's
``apply_unpack`` on ``device="cpu"`` here, which takes the kernel's plain
version; on the card the same call launches the CUDA kernel
(``chip_smoke.py``'s cluster path). Its engines price with
``PMemCostModel(hbm_read_bw_gbps=819.0)``, the JAX package's constant.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.cluster
import repro.core.recovery
import repro.pool
import repro_torch.cluster
import repro_torch.core.recovery
import repro_torch.pool
from repro_torch.core.costmodel import PMemCostModel

CM = PMemCostModel(hbm_read_bw_gbps=819.0)
#: the module the router's migration copy imports ``apply_unpack`` from
OP = importlib.import_module("repro_torch.kernels.apply_unpack")

#: each package, with the keywords its ClusterKV takes
PKGS = {"repro": (repro, {}),
        "repro_torch": (repro_torch, {"device": "cpu", "cost_model": CM})}


def build(name, nshards, npools, n_ops, ckpt, *, impl="auto", page_size=512,
          seed=12345):
    """A cluster of ``npools`` in-memory shard pools, its first view on
    shards ``0..nshards-1``, loaded with ``n_ops`` LCG-seeded puts (a
    checkpoint every ``ckpt``); returns ``(cfg, meta, pools, cluster,
    expected)``."""
    pkg, kw = PKGS[name]
    kv = pkg.core.recovery.KVConfig(npages=8, page_size=page_size,
                                    value_size=32, log_capacity=1 << 15)
    cfg = pkg.cluster.ClusterConfig(kv=kv, n_ranges=8, kernel_impl=impl)
    CK = pkg.cluster.ClusterKV
    meta = pkg.pool.Pool.create(None, CK.meta_pool_bytes(cfg))
    pools = {sid: pkg.pool.Pool.create(None, CK.shard_pool_bytes(cfg))
             for sid in range(npools)}
    c = CK(meta, pools, cfg, shards=range(nshards), **kw)
    expected = {}
    x = seed
    for i in range(n_ops):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        k = x % cfg.nkeys
        value = bytes(((x >> 7) + i + j) % 256 for j in range(32))
        c.put(k, value)
        expected[k] = value
        if ckpt and (i + 1) % ckpt == 0:
            c.checkpoint()
    c.commit()
    return cfg, meta, pools, c, expected


def durable(meta, pools):
    return [meta.pmem.durable_view().tobytes()] + [
        pools[sid].pmem.durable_view().tobytes() for sid in sorted(pools)]


def reshard_run(name, nsh, new, n_ops, ckpt, width, impl):
    cfg, meta, pools, c, expected = build(name, nsh, max(nsh, new), n_ops,
                                          ckpt, impl=impl)
    before = dict(c.map.owners())
    rep = c.reshard(range(new), width=width)
    values = [c.get(k) for k in range(cfg.nkeys)]
    for k, v in expected.items():
        assert values[k] == v, (name, k)
    return (dataclasses.asdict(rep), before, dict(c.map.owners()),
            c.map.view, c.shards, values, durable(meta, pools))


SHAPES = [
    (2, 3, 44, 10),    # grow, page images and a WAL tail
    (4, 2, 48, 10),    # shrink
    (2, 4, 48, 0),     # grow, never checkpointed: WAL records only
]


@pytest.mark.parametrize("impl", ["fused", "staged"])
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("nsh,new,n_ops,ckpt", SHAPES)
def test_reshard_matches_the_reference(nsh, new, n_ops, ckpt, width, impl):
    want = reshard_run("repro", nsh, new, n_ops, ckpt, width, impl)
    got = reshard_run("repro_torch", nsh, new, n_ops, ckpt, width, impl)
    rep = got[0]
    assert rep["ranges_moved"] and (rep["pages_moved"] > 0) == (ckpt > 0)
    assert rep["wal_records_moved"] > 0 or n_ops % ckpt == 0
    for what, a, b in zip(("report", "owners before", "owners", "view",
                           "shards", "values", "durable bytes"), got, want):
        assert a == b, what


def test_copy_pages_lands_the_same_bytes_on_both_arms():
    """The fused arm (one ``apply_unpack`` over the range) and the staged
    arm (the host loop) land the same page images, in the port as in the
    reference."""
    out = {}
    for name in PKGS:
        for impl in ("fused", "staged"):
            cfg, meta, pools, c, _ = build(name, 2, 3, 40, 10, impl=impl)
            vc = c.begin_reshard(range(3))
            r = vc.todo[0]
            src = c.engine(c.map.owner_of_range(r))
            dst = c.engine(vc.target[r])
            nbytes = c._copy_pages(src, dst, r, vc)
            frames = [dst.cache.get(pid, store=dst.store).tobytes()
                      for pid in c._range_pids(r)]
            out[name, impl] = (nbytes, vc.pages_moved, tuple(frames))
    assert out["repro_torch", "fused"][0] > 0
    assert len(set(out.values())) == 1


@pytest.mark.parametrize("page_size", [512, 4096])
def test_copy_pages_verifies_every_image(monkeypatch, page_size):
    """The fused arm's checksums are the bare per-page popcounts, as
    uint32 (a 4 KiB page of set bits counts 32,768); an image changed
    between the summary and the landing raises rather than lands."""
    cfg, meta, pools, c, _ = build("repro_torch", 2, 3, 0, 0, impl="fused",
                                   page_size=page_size)
    for k in range(cfg.nkeys):
        c.put(k, b"\xff" * 32)
    c.commit()
    c.checkpoint()
    calls = []
    real = OP.apply_unpack

    def spy(base, packed, index, expected, **kw):
        calls.append((np.asarray(expected), packed.device, base.device,
                      kw["block_bytes"]))
        return real(base, packed, index, expected, **kw)

    monkeypatch.setattr(OP, "apply_unpack", spy)
    rep = c.reshard(range(3))
    assert len(calls) == len(rep.ranges_moved)
    for exp, pdev, bdev, bb in calls:
        assert exp.dtype == np.uint32 and bb == page_size
        assert (exp == 8 * page_size).all()
        assert pdev == bdev == torch.device("cpu")

    def corrupt(base, packed, index, expected, **kw):
        packed = packed.clone()
        packed[7] ^= 1
        return real(base, packed, index, expected, **kw)

    monkeypatch.setattr(OP, "apply_unpack", corrupt)
    with pytest.raises(RuntimeError, match="checksum mismatch on 1 of"):
        c.reshard(range(2))


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: ClusterKV(device='cuda') builds")
    pkg, _ = PKGS["repro_torch"]
    kv = pkg.core.recovery.KVConfig(npages=8, page_size=512, value_size=32,
                                    log_capacity=1 << 15)
    cfg = pkg.cluster.ClusterConfig(kv=kv, n_ranges=8)
    CK = pkg.cluster.ClusterKV
    meta = pkg.pool.Pool.create(None, CK.meta_pool_bytes(cfg))
    pools = {0: pkg.pool.Pool.create(None, CK.shard_pool_bytes(cfg))}
    for make in (lambda: CK(meta, pools, cfg),
                 lambda: CK.open(meta, pools, cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_reopen_and_resume_match_the_reference():
    """A view change cut at its 6th protocol point, a crash of every
    device, a reopen (``ClusterKV.open``) and ``resume``."""

    class Cut(BaseException):
        pass

    def cut_at(n):
        seen = []

        def fp(point):
            seen.append(point)
            if len(seen) == n:
                raise Cut(point)
        return fp

    out = {}
    for name, (pkg, kw) in PKGS.items():
        cfg, meta, pools, c, expected = build(name, 4, 4, 48, 10)
        c.failpoints = cut_at(6)
        with pytest.raises(Cut):
            c.reshard(range(2), width=2)
        rng = np.random.default_rng(9)
        meta.pmem.crash(rng=rng, evict_prob=0.5)
        for sid in sorted(pools):
            pools[sid].pmem.crash(rng=rng, evict_prob=0.5)
        meta2 = pkg.pool.Pool.open(pmem=meta.pmem)
        pools2 = {sid: pkg.pool.Pool.open(pmem=p.pmem)
                  for sid, p in pools.items()}
        c2 = pkg.cluster.ClusterKV.open(meta2, pools2, cfg, **kw)
        mid = (dict(c2.map.owners()), c2.map.pending)
        rep = c2.resume(width=2)
        for k, v in expected.items():
            assert c2.get(k) == v, (name, k)
        out[name] = (mid, dataclasses.asdict(rep), dict(c2.map.owners()),
                     [dataclasses.asdict(c2.engine(s).last_recovery)
                      for s in sorted(pools2)],
                     durable(meta2, pools2))
    assert out["repro_torch"] == out["repro"]


# ------------------------------------------------- shard map, membership

def test_rendezvous_owner_matches_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        shards = sorted(set(int(s) for s in rng.integers(0, 64, 5)))
        r = int(rng.integers(0, 1 << 20))
        assert (repro_torch.cluster.rendezvous_owner(r, shards)
                == repro.cluster.rendezvous_owner(r, shards))
    for pkg in (repro, repro_torch):
        with pytest.raises(ValueError):
            pkg.cluster.rendezvous_owner(0, [])


def test_shard_map_matches_the_reference():
    out = {}
    for name, (pkg, _) in PKGS.items():
        pool = pkg.pool.Pool.create(None, 1 << 20)
        sm = pkg.cluster.ShardMap(pool, n_ranges=16, nkeys=4096,
                                  shards=[0, 1, 2], map_capacity=1 << 11)
        seen = [sm.assignment([0, 1, 2, 3]), sm.moving_ranges([0, 1, 2, 3]),
                sm.moving_ranges([1, 2])]
        view = sm.begin_view([0, 1, 2, 3])
        for r in sm.moving_ranges([0, 1, 2, 3])[:2]:
            sm.record_owner(r, view, sm.assignment([0, 1, 2, 3])[r])
        seen.append((view, dict(sm.owners()), sm.pending))
        sm2 = pkg.cluster.ShardMap(pkg.pool.Pool.open(pmem=pool.pmem))
        seen.append((sm2.view, sm2.shards, dict(sm2.owners()), sm2.pending))
        view = sm2.begin_view([0, 1, 2, 3])     # resume the pending view
        for r in sm2.moving_ranges([0, 1, 2, 3]):
            sm2.record_owner(r, view, sm2.assignment([0, 1, 2, 3])[r])
        sm2.commit_view()
        for _ in range(20):                 # past capacity: compaction
            for ids in ([1, 2], [0, 1, 2, 3]):
                view = sm2.begin_view(ids)
                for r in sm2.moving_ranges(ids):
                    sm2.record_owner(r, view, sm2.assignment(ids)[r])
                sm2.commit_view()
        seen.append((sm2.view, dict(sm2.owners()), sm2.owner_of_range(5),
                     pool.pmem.durable_view().tobytes()))
        out[name] = seen
    assert out["repro_torch"] == out["repro"]


def test_membership_matches_the_reference():
    rng = np.random.default_rng(11)
    beats = [(int(h), float(t)) for h, t in
             zip(rng.integers(0, 6, 80), np.sort(rng.uniform(0, 30, 80)))]
    steps = [(int(h), float(rng.uniform(0.5, 1.5) * (4 if h == 3 else 1)))
             for h in rng.integers(0, 6, 120)]
    out = {}
    for name, (pkg, _) in PKGS.items():
        reg = pkg.cluster.HeartbeatRegistry(deadline_s=4.0)
        pol = pkg.cluster.BackupStepPolicy(threshold=1.6, patience=2)
        seen = []
        for i, (h, t) in enumerate(beats):
            reg.beat(h, now=t)
            if i % 10 == 9:
                seen.append(("sweep", reg.sweep(now=t + 2.0), reg.alive))
        for i, (h, dt) in enumerate(steps):
            pol.observe(h, dt)
            if i % 6 == 5:
                seen.append(("evaluate", pol.evaluate()))
        seen.append((sorted(reg.dead), sorted(pol.cordoned),
                     pkg.cluster.plan_view(range(6), registry=reg),
                     pkg.cluster.plan_view(range(6), policy=pol),
                     pkg.cluster.plan_view(range(6), registry=reg,
                                           policy=pol)))
        with pytest.raises(ValueError):
            pkg.cluster.plan_view(sorted(reg.dead), registry=reg)
        out[name] = seen
    assert out["repro_torch"] == out["repro"]
    assert out["repro"][-1][1] == [3]
