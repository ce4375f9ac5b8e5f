"""A minimal buffer-managed storage engine tying the primitives together.

This is the validation vehicle of paper §3.3.2 (HyMem + YCSB): a DRAM
buffer pool of fixed-size pages over a PMem page region, with a
write-ahead log using any of the three logging techniques. The buffer
pool is a real one: a bounded
:class:`~repro_torch.cache.BufferManager` (``pool.cache``) rather than a
resident array — reads fault frames in from whichever tier holds the
page (DRAM frame → PMem slot → SSD spill extent), writes dirty frames
that the checkpoint epoch writes back, and ``KVConfig(cache_frames=…)``
bounds the DRAM footprint independently of the PMem slot budget. It
exists to

  * demonstrate the I/O primitives composing into a correct engine,
  * run the YCSB-style 100 %-write validation (``benchmarks/tab_ycsb.py``),
  * provide the crash-recovery property-test target (arbitrary eviction
    subsets at crash time must never lose a committed put).

All persistent layout goes through :class:`repro_torch.pool.Pool` — the engine
never sees a raw byte offset. Its named directory regions are
``<name>.root`` (failure-atomic ping-pong root: two slots, max-generation
rule, same line-atomicity argument as the pvn), ``<name>.pages``
(PageStore slots + µlogs) and the redo log: a single region
``<name>.wal`` by default, or — with ``KVConfig(wal_lanes > 1)`` — a
generational lane-striped :class:`~repro_torch.io.multilog.MultiLog` over
``<name>.wal.g<j>.lane<i>`` plus the ``<name>.wal.gen`` ring header. A
tiered engine (``KVConfig(slot_budget=…)``) adds the spill scheduler's
regions (``<name>.sp.*``) and requires a flash device on the pool
(``pool.attach_ssd``). The preferred constructor is
``pool.kv(name, cfg)``; passing a bare :class:`PMem` still works as a
deprecation shim (the engine formats/attaches a pool in place — raw
base offsets are gone, the shim exists only for old call sites).

Commit protocol per ``put``: modify the DRAM page (track dirty lines),
append a redo record to the WAL, persist per the technique. Background
``checkpoint()`` flushes dirty pages (hybrid CoW/µLog; through a
spill-aware flush-queue epoch when tiered, so a working set larger than
the PMem slot budget overflows to SSD instead of failing) and then
advances the root recording the checkpoint LSN, and truncates the WAL —
``reset`` in place for a single-lane log, a generation ``roll`` for the
striped one (the sealed generation is retired to SSD by the same
epoch's spill drain, which is what bounds the PMem log footprint over
an unbounded run). Recovery = page table scan (cross-tier max-pvn rule
when spilled) + µlog replay + redo of WAL entries past the checkpoint
LSN (puts are idempotent, so the §3.2.1 "log entries might be
reapplied" caveat is benign here).

The port's own copy of ``repro.core.recovery``. One change: the cost
model that prices a reopen's WAL replay is the caller's
(``cost_model=``), since the port's module cost model carries no device
read rate and the replay scan is charged at it.
"""

from __future__ import annotations

import dataclasses
import struct
import warnings
from typing import Dict, Optional, Tuple

from repro_torch.core.blocks import BlockGeometry, PAPER_GEOMETRY, align_up
from repro_torch.core.costmodel import COST_MODEL, PMemCostModel
from repro_torch.core.log import LogConfig
from repro_torch.core.pageflush import PageStore, PageStoreLayout
from repro_torch.core.pmem import PMem

__all__ = ["PersistentKV", "KVConfig", "RecoveryReport"]

_ROOT = struct.Struct("<QQ")  # generation, checkpoint_lsn
_REC = struct.Struct("<II")   # key, value_len   (redo record header)

#: spill-map log capacity per buffer for a tiered KV — referenced by both
#: the scheduler construction and the region_bytes sizing, which must agree
_SPILL_MAP_CAPACITY = 1 << 14


@dataclasses.dataclass(frozen=True)
class KVConfig:
    """Engine configuration. The tiered-storage knobs (``slot_budget``,
    ``wal_lanes``/``wal_gen_sets``) turn the fixed-size engine into one
    whose working set may exceed its PMem budget: cold page slots spill
    to the pool's attached SSD, and the redo log runs lane-striped over a
    generation ring that a checkpoint rolls (and the spill tier retires)
    instead of growing without bound."""

    npages: int = 16
    page_size: int = 4096
    value_size: int = 64
    log_capacity: int = 1 << 20
    technique: str = "zero"              # classic | header | zero
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    geometry: BlockGeometry = PAPER_GEOMETRY
    auto_checkpoint: bool = True
    #: checkpoint page flushing runs through a lane-partitioned
    #: repro_torch.io FlushQueue when > 1 (the Hybrid crossover then follows
    #: the actual active-lane count of each checkpoint epoch)
    flush_lanes: int = 1
    #: PMem page-slot budget. None = the classic sizing (every page fits:
    #: npages + 25 % slack). A value <= npages *overcommits* the slot
    #: array — the pool must have an SSD attached, and a SpillScheduler
    #: evicts cold slots at checkpoint epochs instead of failing.
    slot_budget: Optional[int] = None
    #: redo-log stripe width; > 1 runs the WAL on a generational
    #: repro_torch.io MultiLog (regions <name>.wal.g<j>.lane<i>) whose
    #: generations a checkpoint seals and rolls
    wal_lanes: int = 1
    #: appends batched per lane barrier on the multi-lane WAL. 1 (the
    #: default) keeps every put() durable at return, like the single-lane
    #: WAL; > 1 trades that for amortized barriers (a put is durable at
    #: the next full batch or checkpoint)
    wal_group_commit: int = 1
    #: generation ring size for the multi-lane WAL (>= 2): bounded PMem
    #: log footprint = wal_gen_sets x log_capacity
    wal_gen_sets: int = 2
    #: fraction of page slots the spill keeps free beyond each epoch's
    #: immediate need (eviction slack)
    spill_low_watermark: float = 0.25
    #: NUMA home socket for the engine's root/pages (and single-lane WAL)
    #: regions on a multi-socket pool; multi-lane WAL regions are spread
    #: over the sockets by the pool's LanePlacer regardless
    socket: int = 0
    #: DRAM buffer-pool frames. None = every page fits (``npages`` frames
    #: — the classic resident buffer pool). A smaller value bounds the
    #: engine's DRAM footprint: cold frames are clock-evicted (dirty ones
    #: park in the flush queue until the next checkpoint epoch) and reads
    #: fault back in from the page's resident tier. 0 disables caching.
    cache_frames: Optional[int] = None
    #: touches before an SSD-resident page is promoted back into a PMem
    #: slot on read (k-touch admission; 1 = promote on first access)
    cache_admit_k: int = 2
    #: 2Q probationary fraction of a quota'd owner's frame budget
    #: (scan resistance; 1.0 disables the split — see
    #: ``pool.cache(scan_frac=)``)
    cache_scan_frac: float = 1.0

    @property
    def recs_per_page(self) -> int:
        return self.page_size // self.value_size

    @property
    def nkeys(self) -> int:
        return self.npages * self.recs_per_page

    @property
    def nslots(self) -> int:
        if self.slot_budget is not None:
            return self.slot_budget
        return self.npages + max(2, self.npages // 4)

    @property
    def tiered(self) -> bool:
        """Whether this config needs the SSD tier (overcommitted slots)."""
        return self.slot_budget is not None and self.slot_budget <= self.npages


@dataclasses.dataclass
class RecoveryReport:
    """What one engine reopen's WAL replay did, on the modeled clock.

    ``active_lanes`` is the number of WAL lanes that contributed
    replayed records; the replay *applies* records in global-LSN order
    (cross-lane writes to one key must land in commit order) but
    *attributes* each record's device work to the lane that carried it,
    so ``engine_time_ns``'s max-over-lanes model prices the lanes
    draining concurrently — Izraelevitz et al. (arXiv:1903.05714): PMem
    read bandwidth scales with thread count far better than writes, so
    a lane-striped WAL should replay at lane parallelism, not as one
    serial stream."""

    wal_entries: int = 0
    #: bytes of replayed redo records (the recovery read-scan traffic)
    wal_bytes: int = 0
    active_lanes: int = 1
    modeled_ns: float = 0.0


class PersistentKV:
    """Fixed-size-record KV store: DRAM buffer pool + pool-managed PMem."""

    def __init__(self, pool_or_pmem, cfg: KVConfig, *, name: str = "kv",
                 cost_model: PMemCostModel = COST_MODEL,
                 _recover: bool = False) -> None:
        from repro_torch.pool import Pool
        if isinstance(pool_or_pmem, PMem):
            # deprecation shim for the legacy (pmem, cfg) constructor:
            # format-or-open a pool directly over the caller's region
            warnings.warn(
                "PersistentKV(pmem, cfg) raw-region construction is "
                "deprecated; use pool.kv(name, cfg) on a repro_torch.pool.Pool "
                "instead", DeprecationWarning, stacklevel=2)
            pmpool = Pool.attach(pool_or_pmem)
        else:
            pmpool = pool_or_pmem
        if cfg.geometry != pmpool.geometry:
            raise ValueError("KVConfig.geometry must match the pool geometry")
        self._pmpool = pmpool
        self.pmem = pmpool.pmem
        self.cfg = cfg
        self.name = name
        #: prices a reopen's WAL replay (its scan at the device read rate)
        self.cost_model = cost_model
        g = cfg.geometry

        recover = _recover or pmpool.directory.lookup(f"{name}.root") is not None
        #: lane placer for the WAL stripes and checkpoint flush epochs
        #: (None on a single-socket pool — placement is then a no-op)
        self._placer = pmpool.placer() if pmpool.sockets > 1 else None
        self.root = pmpool.raw(f"{name}.root", nbytes=2 * g.cache_line,
                               socket=cfg.socket)
        pages = pmpool.pages(f"{name}.pages", npages=cfg.npages,
                             page_size=cfg.page_size, nslots=cfg.nslots,
                             socket=cfg.socket)
        self.store: PageStore = pages.store
        self._spill = None
        if cfg.tiered:
            from repro_torch.tier import SpillScheduler
            if pmpool.ssd_dev is None:
                raise ValueError(
                    f"KVConfig(slot_budget={cfg.slot_budget}) overcommits "
                    f"{cfg.npages} pages onto {cfg.nslots} PMem slots; "
                    f"attach a flash device first (pool.attach_ssd)")
            self._spill = SpillScheduler(
                pmpool, name=f"{name}.sp",
                low_watermark=cfg.spill_low_watermark,
                map_capacity=_SPILL_MAP_CAPACITY)
            self._spill.attach_pages(pages)
        if cfg.wal_lanes > 1:
            from repro_torch.io.multilog import MultiLog
            self.wal = MultiLog(pmpool, f"{name}.wal", lanes=cfg.wal_lanes,
                                capacity=cfg.log_capacity,
                                technique=cfg.technique,
                                group_commit=cfg.wal_group_commit,
                                cfg=cfg.log, gen_sets=cfg.wal_gen_sets,
                                placer=self._placer)
            if self._spill is not None:
                self.wal.attach_spill(self._spill)
        else:
            self.wal = pmpool.log(f"{name}.wal", capacity=cfg.log_capacity,
                                  technique=cfg.technique, cfg=cfg.log,
                                  socket=cfg.socket)
        self.checkpoint_lsn = 0
        self._root_gen = 0
        # --- volatile state: the DRAM buffer pool is the pool's shared
        # BufferManager; the engine's dirty tracking, snapshot reads and
        # tier faulting all live behind cache.get/write/writeback --------
        from repro_torch.io.flushq import FlushQueue
        self._fq = FlushQueue(self.store, lanes=cfg.flush_lanes,
                              spill=self._spill, placer=self._placer)
        # Explicit cache config is verified against a pre-existing pool
        # cache (conflict raises); values still at the KVConfig defaults
        # reuse it quietly. A cache-less pool defaults to the classic
        # resident buffer pool: one frame per page.
        from repro_torch.cache import BufferManager
        self.cache = BufferManager.for_pool(
            pmpool, frames=cfg.cache_frames,
            admit_k=None if cfg.cache_admit_k == KVConfig.cache_admit_k
            else cfg.cache_admit_k,
            scan_frac=None if cfg.cache_scan_frac == KVConfig.cache_scan_frac
            else cfg.cache_scan_frac,
            default_frames=cfg.npages, default_admit_k=cfg.cache_admit_k,
            default_scan_frac=cfg.cache_scan_frac)
        self.cache.attach_pages(pages, flushq=self._fq, spill=self._spill)
        #: accounting of the most recent reopen's WAL replay (None on a
        #: fresh engine)
        self.last_recovery: Optional[RecoveryReport] = None
        if recover:
            self._recover_state()

    # ------------------------------------------------------------- sizing

    @staticmethod
    def region_bytes(cfg: KVConfig) -> int:
        """Pool region size that fits this engine (directory included).

        Accounts for whichever WAL shape the config selects — single-lane
        (one log region) or generational multi-lane (``wal_gen_sets``
        lane sets plus the generation header) — and for the spill
        scheduler's PMem-side regions (map double buffer + head) when the
        slot budget overcommits."""
        from repro_torch.pool import DEFAULT_MAX_REGIONS, Pool
        g = cfg.geometry
        layout = PageStoreLayout(base=0, page_size=cfg.page_size,
                                 npages=cfg.npages, nslots=cfg.nslots,
                                 geometry=g,
                                 overcommit=cfg.nslots <= cfg.npages)
        if cfg.wal_lanes > 1:
            per_lane = g.pad_to_block(
                max(1, cfg.log_capacity // cfg.wal_lanes))
            wal_bytes = (cfg.wal_gen_sets * cfg.wal_lanes
                         * (per_lane + g.block)
                         + align_up(2 * g.cache_line, g.block))
        else:
            wal_bytes = cfg.log_capacity + 4 * g.block
        spill_bytes = 0
        if cfg.tiered:
            # map double buffer + ping-pong head (see PersistentKV.__init__)
            spill_bytes = 2 * (_SPILL_MAP_CAPACITY + g.block) \
                + align_up(2 * g.cache_line, g.block)
        return (Pool.overhead_bytes(g, DEFAULT_MAX_REGIONS)
                + align_up(2 * g.cache_line, g.block)
                + PageStore.region_bytes(layout, n_mulogs=1)
                + wal_bytes + spill_bytes)

    # --------------------------------------------------------------- api

    def _locate(self, key: int) -> Tuple[int, int]:
        if not (0 <= key < self.cfg.nkeys):
            raise KeyError(key)
        return key // self.cfg.recs_per_page, (key % self.cfg.recs_per_page) * self.cfg.value_size

    def put(self, key: int, value: bytes) -> int:
        """Durable upsert; returns the commit LSN (absolute across WAL
        generations; WAL-internal LSNs restart at 1 after a checkpoint)."""
        if len(value) != self.cfg.value_size:
            raise ValueError("fixed-size values only")
        pid, off = self._locate(key)
        # buffer-pool write: dirties the page's DRAM frame (faulting the
        # rest of the page in from its resident tier if needed — write
        # faults never promote); nothing touches PMem until a checkpoint
        self.cache.write(pid, off, value, store=self.store)
        try:
            lsn = self.wal.append(_REC.pack(key, len(value)) + value)
        except RuntimeError:
            if not self.cfg.auto_checkpoint:
                raise
            self.checkpoint()
            lsn = self.wal.append(_REC.pack(key, len(value)) + value)
        return self.checkpoint_lsn + lsn

    def get(self, key: int) -> bytes:
        pid, off = self._locate(key)
        page = self.cache.get(pid, store=self.store)
        return page[off : off + self.cfg.value_size].tobytes()

    # -------------------------------------------------------- checkpoint

    def checkpoint(self) -> None:
        """Flush all dirty pages (hybrid), advance the root, truncate the
        WAL.

        Page flushes precede the root update; a crash in between merely
        replays redo records onto already-flushed pages (idempotent puts).
        The dirty frames drain through the buffer manager's write-back
        epoch (one lane-partitioned ``FlushQueue`` drain at
        ``cfg.flush_lanes``, frames pinned for the duration); a tiered
        engine additionally spills cold slots to SSD during that epoch
        instead of failing allocation.

        WAL truncation depends on the log: a single-lane WAL starts a new
        generation in place (``reset`` re-zeroes the region); a multi-lane
        WAL *rolls* — the sealed generation moves to the next ring slot,
        stays recoverable, and the spill scheduler retires it to SSD in
        the same checkpoint epoch.
        """
        self.cache.writeback(self.store)
        ckpt_lsn = self.checkpoint_lsn + (self.wal.next_lsn - 1)
        self._root_gen += 1
        slot = self._root_gen % 2
        g = self.cfg.geometry
        self.root.store(slot * g.cache_line,
                        _ROOT.pack(self._root_gen, ckpt_lsn), streaming=True)
        self.root.persist(slot * g.cache_line, _ROOT.size)
        self.checkpoint_lsn = ckpt_lsn
        # New WAL generation. Multi-lane: seal + ring roll (and retire the
        # sealed generation to SSD within this checkpoint epoch). Single-
        # lane: re-zero in place (Zero logging requires it) and restart
        # the writer at LSN 1.
        if getattr(self.wal, "generational", False):
            self.wal.roll()
            if self._spill is not None:
                self._spill.drain()
        else:
            self.wal.reset()

    # ----------------------------------------------------------- recovery

    def _read_root(self) -> Tuple[int, int]:
        img = self.root.durable_view()
        best = (0, 0)
        g = self.cfg.geometry
        for slot in range(2):
            gen, lsn = _ROOT.unpack_from(img, slot * g.cache_line)
            if gen > best[0]:
                best = (gen, lsn)
        return best

    def _recover_state(self) -> None:
        self._root_gen, self.checkpoint_lsn = self._read_root()
        # No eager page loads: the buffer manager faults each page in
        # from whichever tier holds its newest version (cross-tier
        # max-pvn rule) on first access, and write faults never promote
        # — recovery does not churn the slot budget before the workload
        # tells us which pages are actually hot.
        # Redo WAL entries past the checkpoint (the handle recovered them
        # when it was opened, and is already positioned at the tail):
        # each write dirties the page's frame, re-flushed at the next
        # checkpoint exactly like a fresh put. Records APPLY in
        # global-LSN order (cross-lane writes to one key must land in
        # commit order) but each record's device work is attributed to
        # the WAL lane that carried it, so the cost model prices a
        # lane-striped WAL's replay at max-over-lanes — see
        # RecoveryReport.
        rec = self.wal.recovered
        lanes = getattr(rec, "lanes", None) or []
        lane_base = getattr(self.wal, "lane_id_base", 0)
        lane_cpu = getattr(self.wal, "lane_cpu", None)
        before = self.pmem.stats.snapshot()
        report = RecoveryReport()
        stripe_bytes: Dict[int, int] = {}
        for n, entry in enumerate(rec.entries):
            key, vlen = _REC.unpack_from(entry, 0)
            value = entry[_REC.size : _REC.size + vlen]
            pid, off = self._locate(key)
            report.wal_entries += 1
            report.wal_bytes += len(entry)
            if n < len(lanes) and lane_cpu is not None:
                lane = lanes[n]
                stripe_bytes[lane] = stripe_bytes.get(lane, 0) + len(entry)
                with self.pmem.lane(lane_base + lane,
                                    socket=lane_cpu[lane]):
                    self.cache.write(pid, off, bytes(value),
                                     store=self.store)
            else:
                stripe_bytes[-1] = stripe_bytes.get(-1, 0) + len(entry)
                self.cache.write(pid, off, bytes(value), store=self.store)
        report.active_lanes = max(1, len(set(lanes))) if lanes else 1
        # The replay scan reads each lane's stripe concurrently (PMem
        # reads scale with threads — Izraelevitz), so the scan term is
        # the LARGEST stripe, not the summed WAL bytes; a single-lane
        # log degenerates to the full serial scan.
        report.modeled_ns = self.cost_model.engine_time_ns(
            self.pmem.stats.delta(before),
            active_lanes=report.active_lanes,
            scan_read_bytes=max(stripe_bytes.values(), default=0))
        self.last_recovery = report

    @classmethod
    def open(cls, pool_or_pmem, cfg: KVConfig, *, name: str = "kv",
             cost_model: PMemCostModel = COST_MODEL) -> "PersistentKV":
        return cls(pool_or_pmem, cfg, name=name, cost_model=cost_model,
                   _recover=True)

    # ------------------------------------------------- cross-shard handoff
    # (repro_torch.cluster view changes: a migration's "copy" step reads the
    # source engine's *durable* cut — page images + committed WAL records
    # — so the bytes it ships are exactly what the source's own recovery
    # would reconstruct, and re-running an interrupted copy is idempotent.)

    def durable_page_image(self, pid: int):
        """The page's newest *flushed* content, read from whichever tier
        holds it (cross-tier max-pvn rule), or ``None`` if the page was
        never flushed. Never promotes, never touches DRAM frames — this
        is the migration copy source, not a read path."""
        if self._spill is not None:
            if self._spill.residency(self.store, pid) is None:
                return None
            return self._spill.read_page(self.store, pid, promote=False)
        if pid not in self.store.table:
            return None
        data, _pvn = self.store.fill_page(pid)
        return data

    def committed_wal_records(self):
        """``(key, value)`` pairs of every redo record a restart right
        now would replay, oldest first: sealed-but-unretired generations
        (rare — checkpoint retires them in the same epoch), then the
        durable prefix of the live generation re-read from PMem. Applied
        through the target's own ``put`` during a migration, so each
        record lands in the target's WAL *after* the page images it
        supersedes."""
        out = []
        if getattr(self.wal, "generational", False):
            sealed = self.wal.sealed_generations()
            for gen in sorted(sealed):
                for entry in sealed[gen]:
                    key, vlen = _REC.unpack_from(entry, 0)
                    out.append((key, bytes(entry[_REC.size:_REC.size + vlen])))
        for entry in self.wal.recover().entries:
            key, vlen = _REC.unpack_from(entry, 0)
            out.append((key, bytes(entry[_REC.size:_REC.size + vlen])))
        return out

    def discard_page(self, pid: int) -> None:
        """Drop every copy of a page this engine holds — DRAM frame,
        parked flush-queue image, PMem slot, SSD extent. The view-change
        invalidation step: only call when the page's content is durably
        owned elsewhere (the ownership record has flipped), because the
        bytes are gone from this engine afterwards."""
        self.cache.drop(pid, store=self.store)
        if self._spill is not None:
            self._spill.discard_page(self.store, pid)
        elif pid in self.store.table:
            self.store.release(pid)
