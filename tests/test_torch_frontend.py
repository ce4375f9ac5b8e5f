"""The port's serving front end (``repro_torch.serve``) against the JAX
package's ``repro.serve``.

Both packages generate the same seeded open-loop workload and serve it
through per-tenant KV engines: the requests, the ``ServeReport`` (latency
summaries, served and shed counts, busy time, makespan, batches, hit
ratios), every recorded latency and every durable byte of the tenants'
pool must be equal. The port's front end prices with
``PMemCostModel(hbm_read_bw_gbps=819.0)``, the JAX package's constant.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.recovery
import repro.core.ssd
import repro.pool
import repro.serve
import repro_torch.core.recovery
import repro_torch.core.ssd
import repro_torch.pool
import repro_torch.serve
from repro_torch.core.costmodel import PMemCostModel

CM = PMemCostModel(hbm_read_bw_gbps=819.0)

#: each package, with the keywords its ServeFrontend takes
PKGS = {"repro": (repro, {}),
        "repro_torch": (repro_torch, {"cost_model": CM})}


def tenants(pkg):
    TS = pkg.serve.TenantSpec
    return [TS(name="t0", clients=300, rate=30_000.0, get_frac=0.6,
               put_frac=0.4, zipf_s=1.3),
            TS(name="t1", clients=300, rate=20_000.0, get_frac=0.5,
               put_frac=0.3, scan_frac=0.2, scan_len=4, zipf_s=1.2)]


def report(rep, names):
    """Everything a ``ServeReport`` holds, as plain values."""
    rec = rep.recorder
    return (dataclasses.asdict(rep.overall),
            {k: dataclasses.asdict(v) for k, v in rep.by_tenant.items()},
            rep.served, rep.shed, rep.busy_ns, rep.makespan_ns, rep.batches,
            rep.ops, rep.hit_ratio, rep.throughput_rps,
            [rec.latencies_ns(n) for n in names], rec.histogram(),
            [rec.shed_count(n) for n in names])


def serve_run(name, *, admission, slo_us, tiered, seed):
    pkg, kw = PKGS[name]
    extra = dict(slot_budget=6, cache_frames=10) if tiered else {}
    cfg = pkg.core.recovery.KVConfig(
        npages=16, page_size=1024, value_size=64, log_capacity=1 << 17,
        wal_lanes=2, wal_group_commit=2, wal_gen_sets=2, **extra)
    pool = pkg.pool.Pool.create(
        None, 3 * pkg.core.recovery.PersistentKV.region_bytes(cfg)
        + (1 << 21), sockets=2)
    ssd = None
    if tiered:
        ssd = pkg.core.ssd.SSD(1 << 23)
        pool.attach_ssd(ssd)
    specs = tenants(pkg)
    fe = pkg.serve.ServeFrontend(
        pool, specs, cfg,
        slo=pkg.serve.SLOConfig(p99_target_us=slo_us,
                                queue_budget_us=slo_us / 2),
        admission=admission, record_applied=True, **kw)
    for t in ("t0", "t1"):
        kv = fe.kv(t)
        for k in range(0, cfg.nkeys, 3):
            kv.put(k, bytes([k % 251]) * cfg.value_size)
        kv.checkpoint()
    reqs = pkg.serve.generate(specs, nkeys=cfg.nkeys, duration_s=0.02,
                              seed=seed)
    rep = fe.run(reqs)
    seen = [[dataclasses.astuple(r) for r in reqs],
            report(rep, ["t0", "t1"]), fe.applied_puts,
            [fe.committed_puts(t) for t in ("t0", "t1")],
            [fe.lane_k_budget(t) for t in ("t0", "t1")],
            [[fe.kv(t).get(k) for k in range(cfg.nkeys)]
             for t in ("t0", "t1")],
            pool.pmem.durable_view().tobytes()]
    if ssd is not None:
        seen.append(ssd.durable_read(0, ssd.size).tobytes())
    return seen, rep


@pytest.mark.parametrize("admission,slo_us,tiered", [
    (True, 500.0, False),
    (False, 500.0, False),
    (True, 0.05, False),       # a tight SLO: shedding in flight
    (True, 50.0, True),        # tiered tenants behind a bounded cache
])
def test_frontend_matches_the_reference(admission, slo_us, tiered):
    want, _ = serve_run("repro", admission=admission, slo_us=slo_us,
                        tiered=tiered, seed=7)
    got, rep = serve_run("repro_torch", admission=admission, slo_us=slo_us,
                         tiered=tiered, seed=7)
    assert rep.served > 0 and rep.batches > 0
    if admission and slo_us < 1:
        assert rep.shed > 0
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, i


def test_workload_matches_the_reference():
    for seed in (0, 1, 2):
        reqs = {name: [dataclasses.astuple(r) for r in pkg.serve.generate(
                    tenants(pkg), nkeys=256, duration_s=0.01, seed=seed)]
                for name, (pkg, _) in PKGS.items()}
        assert reqs["repro_torch"] == reqs["repro"]
        assert len(reqs["repro"]) > 100


def test_latency_helpers_match_the_reference():
    rng = np.random.default_rng(3)
    arrivals = rng.integers(0, 10_000, 500)
    lat = rng.integers(1, 2_000_000, 500)
    out = {}
    for name, (pkg, _) in PKGS.items():
        s = sorted(int(x) for x in lat)
        pcts = [pkg.serve.percentile_ns(s, q)
                for q in (0.01, 0.5, 0.9, 0.99, 0.999, 1.0)]
        rec = pkg.serve.LatencyRecorder()
        for i, (a, d) in enumerate(zip(arrivals, lat)):
            rec.record(f"t{i % 3}", int(a), int(a + d))
            if i % 11 == 0:
                rec.shed(f"t{i % 2}")
        out[name] = (pcts, rec.tenants(),
                     [dataclasses.asdict(rec.summary(t))
                      for t in (None, "t0", "t1", "t2")],
                     rec.histogram(), rec.histogram("t1", base_us=4.0,
                                                    factor=3.0),
                     rec.latencies_ns(), rec.shed_count(),
                     pkg.serve.percentile_ns([], 0.5))
        with pytest.raises(ValueError):
            pkg.serve.percentile_ns(s, 0.0)
        with pytest.raises(ValueError):
            rec.record("t0", 20, 10)
    assert out["repro_torch"] == out["repro"]


def modelstate(name):
    pkg, _ = PKGS[name]
    pool = pkg.pool.Pool.create(None, 1 << 23)
    ssd = pkg.core.ssd.SSD(1 << 24)
    pool.attach_ssd(ssd)
    ms = pkg.serve.ModelStateStore(pool, "tinyllama-1.1b", name="ms",
                                   page_size=4096, slot_frac=0.25, seed=3)
    seen = [ms.shards, ms.npages, ms.nslots, ms.tiered,
            [ms.residency(pid) for pid in range(ms.npages)],
            [ms.read_shard(s).tobytes() for s in (0, 1, ms.num_shards - 1)],
            [ms.verify_shard(s) for s in range(ms.num_shards)],
            [ms.residency(pid) for pid in range(ms.npages)],
            pool.pmem.durable_view().tobytes(),
            ssd.durable_read(0, ssd.size).tobytes()]
    return ms, seen


def test_modelstate_matches_the_reference():
    _, want = modelstate("repro")
    ms, got = modelstate("repro_torch")
    assert ms.tiered and all(got[6]) and "ssd" in got[4]
    assert ms.num_shards == ms.config.num_layers + 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, i


def test_modelstate_refuses_an_architecture_not_ported():
    pool = repro_torch.pool.Pool.create(None, 1 << 22)
    pool.attach_ssd(repro_torch.core.ssd.SSD(1 << 23))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        repro_torch.serve.ModelStateStore(pool, "mamba2-130m")
