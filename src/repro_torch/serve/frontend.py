"""Request scheduler + admission controller — the serving frontend.

One :class:`ServeFrontend` owns one engine per tenant: a
:class:`~repro_torch.core.recovery.PersistentKV` (its own WAL lanes, flush
queue, page region) on a shared pool, all fronted by the pool's one
:class:`~repro_torch.cache.BufferManager`. Lanes are per-tenant hardware —
each tenant's batches execute on its own KV's lanes and overlap in
modeled time with other tenants' batches (the engine clock is
max-over-lanes, not a global serializer). What tenants *share* is the
DRAM frame pool — which is why cache quotas, not scheduling, are the
isolation lever.

The serving loop is a discrete-event simulation on the modeled clock:

1. **Arrivals** (from :mod:`repro_torch.serve.workload`) are admitted or
   shed the moment they arrive, per tenant: estimated wait = time
   until the tenant's lanes free up + its queued ops × an EWMA of its
   per-op service time; if that exceeds the SLO's queue budget the
   request is rejected *before* touching the engine (its WAL never
   sees it — recovery-wise a shed request never happened).
2. **Batching** reuses the WAL's adaptive group-commit state: a
   tenant's admit-batch budget is the sum of its WAL's
   :meth:`MultiLog.lane_k` targets — when the placer has grown a
   lane's group commit under sustained load, the frontend admits
   bigger batches to match (one ``commit()`` per batch); when
   latency-bound traffic has shrunk them, batches follow.
3. **Service time** is fully modeled: the exact PMem/SSD/cache op
   deltas the batch executed, priced by ``engine_time_ns`` (+ the SSD
   model when tiered). Every request in a batch completes when its
   batch does; latency = completion − arrival
   (:mod:`repro_torch.serve.latency`). Batches across tenants execute in
   start-time order (ties broken by tenant position), so cache state
   — and therefore every counter — is bit-stable across runs.

Crash semantics: the frontend adds no durability points of its own.
Everything flows through ``PersistentKV.put`` / the WAL's group
commit, so a crash mid-batch recovers exactly the committed prefix —
admitted-but-uncommitted requests recover as if they had been shed
(asserted by the serve cases in ``tests/test_crash_corpus.py``). The
optional ``failpoints`` hook (the corpus' ``CrashAt`` protocol) fires
at ``req_applied`` / ``batch_commit`` points to make that testable.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import COST_MODEL, SSD_COST_MODEL, PMemCostModel
from repro_torch.serve.latency import LatencyRecorder, LatencySummary
from repro_torch.serve.workload import Request, TenantSpec

__all__ = ["SLOConfig", "ServeFrontend", "ServeReport"]


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """The serving contract the admission controller enforces.

    ``queue_budget_us`` is the wait the controller will knowingly book
    a request into before shedding it instead; it defaults to the p99
    target (a request admitted into a longer queue would already have
    blown the tail on arrival)."""

    #: tail-latency objective, µs of modeled time (reported against
    #: the p99 of served requests)
    p99_target_us: float = 500.0
    #: max estimated wait a request may be queued behind (None → the
    #: p99 target)
    queue_budget_us: Optional[float] = None

    @property
    def queue_budget_ns(self) -> float:
        """The shed threshold in ns (see class docstring)."""
        budget = (self.queue_budget_us if self.queue_budget_us is not None
                  else self.p99_target_us)
        return budget * 1000.0


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """Everything one :meth:`ServeFrontend.run` produced."""

    #: per-request digests: overall and per tenant
    overall: LatencySummary
    by_tenant: Dict[str, LatencySummary]
    #: the recorder itself (histograms, raw latency lists)
    recorder: LatencyRecorder
    #: requests served / shed
    served: int
    shed: int
    #: summed per-tenant lane busy time, and end-to-end makespan
    #: (modeled ns; tenants overlap, so busy can exceed makespan)
    busy_ns: float
    makespan_ns: float
    #: batches executed and ops applied (scan = scan_len ops)
    batches: int
    ops: int
    #: per-tenant DRAM hit ratio over the run (buffer-manager per-owner
    #: accounting)
    hit_ratio: Dict[str, float]

    @property
    def throughput_rps(self) -> float:
        """Served requests per second of modeled time."""
        return self.served / (self.makespan_ns / 1e9) if self.makespan_ns \
            else 0.0


class _Tenant:
    """Frontend-side runtime state for one tenant: its engine, queue,
    lane busy-horizon, and per-op service estimate."""

    __slots__ = ("spec", "kv", "queue", "free_ns", "ewma_ns",
                 "applied", "committed")

    def __init__(self, spec: TenantSpec, kv) -> None:
        self.spec = spec
        self.kv = kv
        self.queue: Deque[Request] = deque()
        #: this tenant's lanes are busy until here (modeled ns)
        self.free_ns = 0.0
        #: EWMA per-op service estimate (None until the first batch)
        self.ewma_ns: Optional[float] = None
        #: puts applied / puts known committed (crash bookkeeping)
        self.applied = 0
        self.committed = 0


def _put_value(value_size: int, tenant: str, key: int, vseed: int) -> bytes:
    """The deterministic value a put request writes: unique per
    ``(tenant, key, vseed)``, so tests can recognize exactly which
    request's write is (or is not) present after a crash."""
    raw = f"{tenant}:{key}:{vseed}:".encode()
    reps = -(-value_size // len(raw))
    return (raw * reps)[:value_size]


class ServeFrontend:
    """Admission-controlled, batch-scheduled serving over per-tenant
    :class:`~repro_torch.core.recovery.PersistentKV` engines (module doc)."""

    #: EWMA weight of the newest per-op service observation
    _EWMA_ALPHA = 0.2

    def __init__(self, pool, tenants: Sequence[TenantSpec], kv_cfg, *,
                 slo: Optional[SLOConfig] = None,
                 admission: bool = True,
                 min_batch: int = 1,
                 failpoints: Optional[Callable[[str], None]] = None,
                 record_applied: bool = False,
                 cost_model: PMemCostModel = COST_MODEL) -> None:
        """Build one KV engine per tenant on ``pool`` (all sharing the
        pool's cache and, if tiered, its SSD).

        Args:
            pool: the :class:`repro_torch.pool.Pool` hosting every tenant.
            tenants: traffic specs; ``spec.name`` becomes the KV name.
            kv_cfg: one :class:`~repro_torch.core.recovery.KVConfig` shared by
                every tenant (``nkeys`` bounds the workload key space).
            slo: serving contract (default :class:`SLOConfig`).
            admission: ``False`` disables shedding — every arrival
                queues, however deep the backlog (the open-loop
                collapse mode the benchmarks contrast against).
            min_batch: admit-batch floor before ``lane_k`` feedback.
            failpoints: crash-corpus hook, called with protocol-point
                names (``req_applied`` / ``batch_commit``).
            record_applied: keep ``(tenant, key, value)`` for every put
                applied, in order (crash-corpus bookkeeping).
            cost_model: prices each batch and the tenants' WAL replays.
        """
        self.cost_model = cost_model
        self.pool = pool
        self.slo = slo if slo is not None else SLOConfig()
        self.admission = bool(admission)
        self.min_batch = max(1, int(min_batch))
        self.failpoints = failpoints
        self.record_applied = bool(record_applied)
        self.applied_puts: List[Tuple[str, int, bytes]] = []
        self.kv_cfg = kv_cfg
        self._tenants: Dict[str, _Tenant] = {}
        self._order: List[str] = []
        for spec in tenants:
            kv = pool.kv(spec.name, kv_cfg, cost_model=cost_model)
            self._tenants[spec.name] = _Tenant(spec, kv)
            self._order.append(spec.name)
        self.cache = pool.cache()

    # ---------------------------------------------------------- plumbing

    def kv(self, tenant: str):
        """The tenant's :class:`~repro_torch.core.recovery.PersistentKV`."""
        return self._tenants[tenant].kv

    def cache_owner(self, tenant: str) -> str:
        """The buffer-manager owner key of a tenant's pages region."""
        return f"{tenant}.pages"

    def set_cache_quota(self, tenant: str, frames: Optional[int]) -> None:
        """Cap a tenant's resident DRAM frames
        (:meth:`repro_torch.cache.BufferManager.set_quota` on its pages
        region; ``None`` lifts the cap)."""
        self.cache.set_quota(self.cache_owner(tenant), frames)

    def set_cache_scan_frac(self, tenant: str, frac: Optional[float]) -> None:
        """Override one tenant's 2Q probationary fraction
        (:meth:`repro_torch.cache.BufferManager.set_scan_frac` on its pages
        region; ``None`` reverts to the pool cache's ``scan_frac``).
        Only meaningful with a :meth:`set_cache_quota` cap — the split
        sizes against the tenant's budget. A scan-heavy tenant set to
        e.g. ``0.25`` cycles a quarter of its quota instead of churning
        its own hot set."""
        self.cache.set_scan_frac(self.cache_owner(tenant), frac)

    def committed_puts(self, tenant: str) -> int:
        """Puts of this tenant known durably committed (advanced after
        each of its batches' WAL commit — a crash-corpus lower bound on
        what must recover)."""
        return self._tenants[tenant].committed

    def lane_k_budget(self, tenant: str) -> int:
        """The tenant's adaptive admit-batch budget: its WAL's summed
        per-lane group-commit targets (:meth:`MultiLog.lane_k`) — the
        public surface of the ``LanePlacer`` signals. A single-lane WAL
        (no ``lane_k``) counts its static ``group_commit``; floored at
        ``min_batch``."""
        wal = self._tenants[tenant].kv.wal
        lane_k = getattr(wal, "lane_k", None)
        if lane_k is not None:
            total = sum(lane_k())
        else:
            total = int(getattr(wal, "group_commit", 1) or 1)
        return max(self.min_batch, total)

    def _fp(self, point: str) -> None:
        if self.failpoints is not None:
            self.failpoints(point)

    # --------------------------------------------------------- admission

    @staticmethod
    def _req_ops(r: Request) -> int:
        return r.scan_len if r.op == "scan" else 1

    def _should_shed(self, t: _Tenant, r: Request) -> bool:
        """Per-tenant backlog rule (module doc): estimated wait behind
        the tenant's own queue vs the SLO's queue budget."""
        if not self.admission or t.ewma_ns is None:
            return False          # no service estimate yet: admit
        wait = max(0.0, t.free_ns - r.arrival_ns)
        wait += sum(self._req_ops(q) for q in t.queue) * t.ewma_ns
        return wait > self.slo.queue_budget_ns

    def _admit(self, r: Request, rec: LatencyRecorder) -> None:
        t = self._tenants[r.tenant]
        if self._should_shed(t, r):
            rec.shed(r.tenant)
        else:
            t.queue.append(r)

    # ----------------------------------------------------------- serving

    def _apply(self, t: _Tenant, r: Request) -> int:
        """Execute one request against its tenant's engine; returns the
        op count it contributed (scan = ``scan_len``)."""
        kv = t.kv
        if r.op == "get":
            kv.get(r.key)
            ops = 1
        elif r.op == "put":
            value = _put_value(self.kv_cfg.value_size, r.tenant, r.key,
                               r.vseed)
            kv.put(r.key, value)
            t.applied += 1
            if self.record_applied:
                self.applied_puts.append((r.tenant, r.key, value))
            ops = 1
        elif r.op == "scan":
            stop = min(r.key + r.scan_len, self.kv_cfg.nkeys)
            for k in range(r.key, stop):
                kv.get(k)
            ops = max(1, stop - r.key)
        else:
            raise ValueError(f"unknown op {r.op!r}")
        self._fp("req_applied")
        return ops

    def _execute(self, t: _Tenant, start_ns: float
                 ) -> Tuple[float, List[Request], int]:
        """Drain one admit batch from the tenant's queue at ``start_ns``
        on its own lanes: apply, commit its WAL once, price the exact op
        deltas. Returns ``(done_ns, batch, ops)``."""
        pool = self.pool
        pm0 = pool.stats.snapshot()
        c0 = self.cache.stats.snapshot()
        ssd = pool.ssd_dev
        ssd0 = ssd.stats.snapshot() if ssd is not None else None
        budget = self.lane_k_budget(t.spec.name)
        batch: List[Request] = []
        ops = 0
        had_put = False
        while t.queue and len(batch) < budget:
            r = t.queue.popleft()
            batch.append(r)
            ops += self._apply(t, r)
            had_put = had_put or r.op == "put"
        if had_put:
            commit = getattr(t.kv.wal, "commit", None)
            if commit is not None:
                commit()     # single-lane Logs are durable at append
        self._fp("batch_commit")
        t.committed = t.applied
        service = self.cost_model.engine_time_ns(
            pool.stats.delta(pm0), cache=self.cache.stats.delta(c0))
        if ssd is not None:
            service += SSD_COST_MODEL.time_ns(ssd.stats.delta(ssd0))
        per_op = service / max(1, ops)
        if t.ewma_ns is None:
            t.ewma_ns = per_op
        else:
            t.ewma_ns += self._EWMA_ALPHA * (per_op - t.ewma_ns)
        done = start_ns + service
        t.free_ns = done
        return done, batch, ops

    def run(self, requests: Sequence[Request]) -> ServeReport:
        """Serve an arrival-ordered request list to completion;
        discrete-event on the modeled clock (module doc). Deterministic:
        same requests + same engine state → bit-identical report."""
        rec = LatencyRecorder()
        hit0 = {name: self.cache.owner_stats(
                    self.cache_owner(name)).snapshot()
                for name in self._order}
        busy = 0.0
        batches = 0
        total_ops = 0
        served = 0
        i, n = 0, len(requests)
        while True:
            # earliest batch start over tenants with queued work
            # (tie → tenant position: deterministic cache interleaving)
            cand: Optional[Tuple[float, int]] = None
            for ti, name in enumerate(self._order):
                t = self._tenants[name]
                if not t.queue:
                    continue
                s = max(t.free_ns, float(t.queue[0].arrival_ns))
                if cand is None or s < cand[0]:
                    cand = (s, ti)
            next_arr = requests[i].arrival_ns if i < n else None
            if cand is None:
                if next_arr is None:
                    break
                self._admit(requests[i], rec)
                i += 1
                continue
            if next_arr is not None and next_arr <= cand[0]:
                # the arrival happens before any lane frees: admission
                # decisions observe the queue as of their arrival time
                self._admit(requests[i], rec)
                i += 1
                continue
            t = self._tenants[self._order[cand[1]]]
            done, batch, ops = self._execute(t, cand[0])
            busy += done - cand[0]
            batches += 1
            total_ops += ops
            served += len(batch)
            for r in batch:
                rec.record(r.tenant, r.arrival_ns, int(done))
        hits = {}
        for name in self._order:
            d = self.cache.owner_stats(self.cache_owner(name)).delta(
                hit0[name])
            hits[name] = d.hit_ratio
        makespan = max((self._tenants[n].free_ns for n in self._order),
                      default=0.0)
        return ServeReport(
            overall=rec.summary(),
            by_tenant={name: rec.summary(name) for name in self._order},
            recorder=rec,
            served=served,
            shed=rec.shed_count(),
            busy_ns=busy,
            makespan_ns=makespan,
            batches=batches,
            ops=total_ops,
            hit_ratio=hits,
        )
