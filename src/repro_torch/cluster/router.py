"""``ClusterKV``: N independent engines behind one durable shard map,
with crash-consistent live view changes.

Each shard is a full :class:`~repro_torch.core.recovery.PersistentKV` engine
on its **own pool** — its own WAL lanes, flush queue, spill tier and
DRAM frames — exactly as ``repro_torch.serve`` builds per-tenant engines. The
router owns no data: it routes every ``put``/``get`` by the durable
per-range ownership record in the :class:`~repro_torch.cluster.shardmap.ShardMap`
(on a small dedicated *meta pool*), so "who answers this key" has a
single point of truth at every instant, including mid-reshard.

**Life of a view change** (``reshard``), per moving range, generalizing
the spill protocol's down-tier-first ordering to cross-shard handoff::

    copy   — durable page images + committed WAL records stream from
             the source engine into the target's frames and WAL
    flush  — the target writes the range back and commits its WAL: the
             bytes are durable on the new owner, but unreachable (the
             ownership record still names the old one)
    own    — ONE Zero-log barrier flips the range's ownership record:
             the atomic per-range commit point
    inval  — the source durably discards its copies (frames, parked
             images, PMem slots, SSD extents)

A crash strictly before ``own`` recovers exactly-old-owner (the copy
never mutated the source); at or after it, exactly-new-owner (the
source's leftovers are unreachable and scrubbed at reopen). Never both,
never neither — the crash-corpus invariant. Resuming an interrupted
view change re-runs only the not-yet-flipped ranges (the copy step is
idempotent: it re-ships the same durable cut) and converges.

Migration traffic is charged on the modeled clock: each range's step
prices the PMem/SSD/cache deltas it caused on *both* engines through
``engine_time_ns`` and adds the interconnect term
``cluster_transfer_ns(bytes_moved)`` on the receiving side, so
``benchmarks/cluster_reshard.py`` can race resharding against
foreground traffic deterministically.

The port's own copy of ``repro.cluster.router``. The migration copy's
verify-and-assemble pass runs the port's ``apply_unpack`` on the
router's ``device`` (a CUDA device unless the caller asks for the CPU):
one upload of the range's images, one launch and one download per
range. The cost model is the caller's (``cost_model=``), as the engines'
WAL replays are priced at its device read rate.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import COST_MODEL, SSD_COST_MODEL, PMemCostModel
from repro_torch.core.recovery import KVConfig, PersistentKV, _REC
from repro_torch.cluster.shardmap import ShardMap

__all__ = ["ClusterConfig", "ClusterKV", "CausalSession", "ReshardReport",
           "ViewChange"]


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Shape of a sharded KV: the per-shard engine config plus the range
    geometry of the shard map.

    ``kv.npages`` spans the **global** key space (every engine can host
    any page; which pages it actually materializes is decided by
    ownership), carved into ``n_ranges`` equal page-aligned ranges —
    the granule of migration and of ownership records."""

    kv: KVConfig = dataclasses.field(default_factory=KVConfig)
    n_ranges: int = 8
    map_capacity: int = 1 << 14
    #: migration copy verification: ``"auto"``/``"fused"``/``"ref"`` run
    #: one ``apply_unpack`` pass per range (checksum-verify + assemble
    #: the shipped page images in a single device read); ``"staged"``
    #: keeps the per-page host loop. Bytes landed on the target are
    #: identical either way — this only picks how the transfer is
    #: verified and priced.
    kernel_impl: str = "auto"

    def __post_init__(self) -> None:
        if self.n_ranges < 1 or self.kv.npages % self.n_ranges:
            raise ValueError(
                f"n_ranges={self.n_ranges} must divide npages="
                f"{self.kv.npages} (ranges are page-aligned)")

    @property
    def pages_per_range(self) -> int:
        """Pages per migration granule."""
        return self.kv.npages // self.n_ranges

    @property
    def nkeys(self) -> int:
        """Global key space size (== the per-engine key space)."""
        return self.kv.nkeys


@dataclasses.dataclass(frozen=True)
class ReshardReport:
    """What one view change did, on the modeled clock.

    ``engine_ns`` is the full modeled cost of the migration steps (PMem
    + SSD + cache work on both sides, interconnect term included);
    ``transfer_ns`` is the interconnect term alone. ``wall_ns`` is the
    modeled *wall clock*: within each batch of concurrently in-flight
    ranges (``width=`` on ``begin_reshard``), each engine serializes its
    own work but distinct engines overlap, so a batch costs
    max-over-engines (plus the serialized shard-map flips) rather than
    the serial sum. Even at ``width=1`` a range's reader (source) and
    writer (target) pipeline, so ``wall_ns <= engine_ns`` always; the
    win from ``width > 1`` is overlapping *different* src/dst pairs."""

    view: int
    shards: Tuple[int, ...]
    ranges_moved: Tuple[int, ...]
    pages_moved: int
    page_bytes: int
    wal_records_moved: int
    wal_bytes: int
    engine_ns: float
    transfer_ns: float
    wall_ns: float = 0.0

    @property
    def bytes_moved(self) -> int:
        """Total migration payload: page images + WAL records."""
        return self.page_bytes + self.wal_bytes


class ViewChange:
    """One in-flight view change, migrated ``width`` ranges at a time.

    Callers that interleave foreground traffic (the reshard-under-load
    benchmark, a serving loop) drive :meth:`step` themselves; the last
    step commits the view. :meth:`run` drives it to completion.

    ``width > 1`` flights that many ranges concurrently: one
    :meth:`step` runs the batch stage-interleaved — every range's copy,
    then every flush, then every ownership flip, then every invalidate
    — with each range's failpoints firing independently at its own
    protocol points. Per-range ordering (copy < flush < own < inval) is
    exactly the serial protocol's, so the exactly-old-XOR-exactly-new
    crash invariant is untouched and the migrated bytes are identical
    to a ``width=1`` run; only the modeled wall clock changes (distinct
    engines overlap — see ``ReshardReport.wall_ns``)."""

    def __init__(self, cluster: "ClusterKV", shards: Iterable[int], *,
                 width: int = 1) -> None:
        """Durably start the view change toward ``shards`` (re-entrant
        for resume — see ``ShardMap.begin_view``)."""
        ids = tuple(sorted(int(s) for s in shards))
        unknown = set(ids) - set(cluster._engines)
        if unknown:
            raise ValueError(f"no engines for shards {sorted(unknown)}")
        self._c = cluster
        self.width = max(1, int(width))
        self.view = cluster.map.begin_view(ids)
        cluster._fp("view:started")
        self.target_shards = ids
        self.target = cluster.map.assignment(ids)
        #: ranges still to migrate, in range order (deterministic)
        self.todo: List[int] = cluster.map.moving_ranges(ids)
        self.moved: List[int] = []
        self.pages_moved = 0
        self.page_bytes = 0
        self.wal_records_moved = 0
        self.wal_bytes = 0
        self.engine_ns = 0.0
        self.transfer_ns = 0.0
        self.wall_ns = 0.0
        self._done = False

    def step(self) -> bool:
        """Migrate the next batch of up to ``width`` moving ranges
        (commit the view once none remain). Returns True while more
        steps are pending."""
        if self._done:
            return False
        if self.todo:
            batch = self.todo[:self.width]
            del self.todo[:self.width]
            self._c._migrate_batch(batch, self.view, self)
            self.moved.extend(batch)
        if not self.todo:
            self._c._scrub_all()
            self._c.map.commit_view()
            self._c._fp("view:committed")
            self._done = True
            return False
        return True

    def run(self) -> ReshardReport:
        """Drive the view change to completion and report it."""
        while self.step():
            pass
        return self.report()

    def report(self) -> ReshardReport:
        """The migration's byte/time accounting so far."""
        return ReshardReport(
            view=self.view, shards=self.target_shards,
            ranges_moved=tuple(self.moved), pages_moved=self.pages_moved,
            page_bytes=self.page_bytes,
            wal_records_moved=self.wal_records_moved,
            wal_bytes=self.wal_bytes, engine_ns=self.engine_ns,
            transfer_ns=self.transfer_ns, wall_ns=self.wall_ns)


class CausalSession:
    """A client session with cross-shard causal consistency.

    Within a session, before a write lands on a shard every *other*
    shard holding one of the session's earlier-not-yet-committed writes
    is group-committed first. Each shard's WAL recovers a contiguous
    durable prefix, so after any crash a surviving write implies all its
    causal predecessors survive too — across shards, not just within
    one — which is the acceptance suite's causal-chain invariant.
    Reads go through the owners' frames: read-your-writes for free."""

    def __init__(self, cluster: "ClusterKV") -> None:
        """Bind to a router; sessions are cheap, make one per client."""
        self._c = cluster
        self._uncommitted: set = set()

    def put(self, key: int, value: bytes) -> int:
        """Causally ordered durable upsert (see class docstring)."""
        sid = self._c.owner_of(key)
        for dep in sorted(self._uncommitted - {sid}):
            self._c._commit_shard(dep)
            self._uncommitted.discard(dep)
        lsn = self._c.put(key, value)
        self._uncommitted.add(sid)
        return lsn

    def get(self, key: int) -> bytes:
        """Read through the owning engine's frames."""
        return self._c.get(key)

    def flush(self) -> None:
        """Commit every shard this session still has in flight."""
        for sid in sorted(self._uncommitted):
            self._c._commit_shard(sid)
        self._uncommitted.clear()


class ClusterKV:
    """Sharded PersistentKV: route by durable ownership, reshard live.

    Open-or-create over a meta pool (shard map) plus one pool per shard
    (engines, named ``s<sid>`` on their pool). Tiered configs need each
    shard pool's SSD attached **before** construction. ``shards=``
    restricts the *initial view* to a subset of the provided pools —
    spare pools idle until a reshard pulls them in (the add-shard
    scenario). On reopen the constructor recovers every engine and the
    map, then scrubs non-owner leftovers of every range (frames the
    engines' WAL replay resurrected for keys they no longer own, durable
    copies an interrupted invalidation left behind, and — via a
    checkpoint of any engine whose WAL holds records for ranges it does
    not own — stale WAL residue that would otherwise replay over newer
    page images on a later restart) — reopening is therefore
    self-healing, and resuming an interrupted view change is just
    ``resume()``."""

    def __init__(self, meta_pool, shard_pools: Dict[int, object],
                 cfg: Optional[ClusterConfig] = None, *,
                 shards: Optional[Iterable[int]] = None,
                 device="cuda",
                 cost_model: PMemCostModel = COST_MODEL) -> None:
        """Open-or-create; see the class docstring. ``device`` is where
        the migration copy verifies and assembles each range's page
        images (``apply_unpack``): a CUDA device unless the caller asks
        for the CPU; without a card, ``"cuda"`` raises. ``cost_model``
        prices the migration steps and the engines' WAL replays."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ClusterKV(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        self.cost_model = cost_model
        #: host seconds of the fused migration copies' device round trips
        #: (upload, apply_unpack, download)
        self.device_copy_s = 0.0
        cfg = cfg or ClusterConfig()
        self.cfg = cfg
        self.meta_pool = meta_pool
        self._pools = dict(sorted(shard_pools.items()))
        if len({id(p) for p in self._pools.values()}) != len(self._pools):
            raise ValueError("each shard needs its own pool")
        #: test-only failpoint hook — called with a protocol point name;
        #: raising aborts mid-protocol exactly like a crash would
        self.failpoints = None
        recover = meta_pool.directory.lookup("sm.hd") is not None
        ids = tuple(sorted(int(s) for s in (shards if shards is not None
                                            else self._pools)))
        if set(ids) - set(self._pools):
            raise ValueError(f"shards {ids} not all backed by pools")
        self.map = ShardMap(meta_pool, n_ranges=cfg.n_ranges,
                            nkeys=cfg.nkeys, shards=ids,
                            map_capacity=cfg.map_capacity)
        if (self.map.n_ranges, self.map.nkeys) != (cfg.n_ranges, cfg.nkeys):
            raise ValueError(
                f"map geometry ({self.map.n_ranges} ranges, "
                f"{self.map.nkeys} keys) does not match the config "
                f"({cfg.n_ranges}, {cfg.nkeys})")
        self._engines: Dict[int, PersistentKV] = {
            sid: pool.kv(f"s{sid}", cfg.kv, cost_model=cost_model)
            for sid, pool in self._pools.items()}
        missing = set(self.map.owners().values()) - set(self._engines)
        if missing:
            raise ValueError(f"map names owners {sorted(missing)} but no "
                             f"pool was provided for them")
        if recover:
            self._scrub_all()

    def pool(self, sid: int):
        """The pmem pool backing shard ``sid`` (for pricing its deltas
        through ``engine_time_ns`` and for test assertions)."""
        return self._pools[int(sid)]

    @classmethod
    def open(cls, meta_pool, shard_pools: Dict[int, object],
             cfg: Optional[ClusterConfig] = None, *, device="cuda",
             cost_model: PMemCostModel = COST_MODEL) -> "ClusterKV":
        """Reopen after a restart (same as the constructor on existing
        pools — provided for symmetry with ``PersistentKV.open``)."""
        return cls(meta_pool, shard_pools, cfg, device=device,
                   cost_model=cost_model)

    # ----------------------------------------------------------- failpoint

    def _fp(self, point: str) -> None:
        if self.failpoints is not None:
            self.failpoints(point)

    # -------------------------------------------------------------- sizing

    @staticmethod
    def shard_pool_bytes(cfg: ClusterConfig) -> int:
        """Pool bytes one shard's engine needs (directory included)."""
        return PersistentKV.region_bytes(cfg.kv) + (1 << 14)

    @staticmethod
    def meta_pool_bytes(cfg: ClusterConfig) -> int:
        """Pool bytes the shard map's meta pool needs."""
        from repro_torch.pool import DEFAULT_MAX_REGIONS, Pool
        g = cfg.kv.geometry
        return (Pool.overhead_bytes(g, DEFAULT_MAX_REGIONS)
                + ShardMap.region_bytes(g, cfg.map_capacity) + (1 << 12))

    # ------------------------------------------------------------- routing

    def range_of(self, key: int) -> int:
        """The page-aligned range a key belongs to."""
        if not (0 <= key < self.cfg.nkeys):
            raise KeyError(key)
        return (key // self.cfg.kv.recs_per_page) // self.cfg.pages_per_range

    def owner_of(self, key: int) -> int:
        """The shard whose durable ownership record answers this key."""
        return self.map.owner_of_range(self.range_of(key))

    def engine(self, sid: int) -> PersistentKV:
        """A shard's engine (tests and benchmarks poke at internals)."""
        return self._engines[sid]

    @property
    def view(self) -> int:
        """Last committed view number."""
        return self.map.view

    @property
    def shards(self) -> Tuple[int, ...]:
        """Shard ids of the committed view."""
        return self.map.shards

    def _range_pids(self, r: int) -> range:
        ppr = self.cfg.pages_per_range
        return range(r * ppr, (r + 1) * ppr)

    # ----------------------------------------------------------------- api

    def put(self, key: int, value: bytes) -> int:
        """Durable upsert on the owning shard; returns its engine LSN."""
        return self._engines[self.owner_of(key)].put(key, value)

    def get(self, key: int) -> bytes:
        """Read from the owning shard — exactly one engine ever answers
        a key under a given map state."""
        return self._engines[self.owner_of(key)].get(key)

    def commit(self) -> None:
        """Group-commit every engine's WAL tail."""
        for sid in sorted(self._engines):
            self._commit_shard(sid)

    def checkpoint(self) -> None:
        """Checkpoint every engine (flush + WAL truncation)."""
        for sid in sorted(self._engines):
            self._engines[sid].checkpoint()

    def session(self) -> CausalSession:
        """A causally consistent client session (see CausalSession)."""
        return CausalSession(self)

    def _commit_shard(self, sid: int) -> None:
        commit = getattr(self._engines[sid].wal, "commit", None)
        if commit is not None:
            commit()

    def digest(self) -> str:
        """sha256 over the committed view, every ownership record and
        every key's current value — the bit-determinism witness the
        acceptance suite compares across identically seeded runs."""
        h = hashlib.sha256()
        h.update(struct.pack("<QI", self.map.view, len(self.map.shards)))
        for sid in self.map.shards:
            h.update(struct.pack("<I", sid))
        for r in range(self.cfg.n_ranges):
            h.update(struct.pack("<II", r, self.map.owner_of_range(r)))
        for key in range(self.cfg.nkeys):
            try:
                h.update(self.get(key))
            except KeyError:
                h.update(b"\x00absent")
        return h.hexdigest()

    # -------------------------------------------------------- view changes

    def begin_reshard(self, shards: Iterable[int], *,
                      width: int = 1) -> ViewChange:
        """Durably start a view change toward ``shards`` and hand back
        the step-at-a-time driver. ``width`` is how many ranges each
        step flights concurrently (see ``ViewChange``)."""
        return ViewChange(self, shards, width=width)

    def reshard(self, shards: Iterable[int], *,
                width: int = 1) -> ReshardReport:
        """Run a full view change to ``shards`` (see module docstring
        for the per-range protocol) and report what moved."""
        return self.begin_reshard(shards, width=width).run()

    def resume(self, *, width: int = 1) -> Optional[ReshardReport]:
        """Finish a view change a crash interrupted, if any: re-runs the
        not-yet-flipped ranges and commits. Returns None when no view is
        pending."""
        if self.map.pending is None:
            return None
        return self.reshard(self.map.pending[1], width=width)

    # ----------------------------------------------- migration internals

    def _snap(self, sid: int):
        """Stats snapshot of one shard's pool + cache + SSD (pricing)."""
        pool, eng = self._pools[sid], self._engines[sid]
        return (pool.stats.snapshot(), eng.cache.stats.snapshot(),
                pool.ssd_dev.stats.snapshot() if pool.ssd_dev else None)

    def _price(self, sid: int, snap, *, transfer_bytes: int = 0) -> float:
        """Modeled ns of the work ``sid`` did since ``snap``."""
        pool, eng = self._pools[sid], self._engines[sid]
        p0, c0, d0 = snap
        ns = self.cost_model.engine_time_ns(pool.stats.delta(p0),
                                       cache=eng.cache.stats.delta(c0),
                                       cluster_transfer_bytes=transfer_bytes)
        if d0 is not None:
            ns += SSD_COST_MODEL.time_ns(pool.ssd_dev.stats.delta(d0))
        return ns

    def _copy_pages(self, src: PersistentKV, dst: PersistentKV, r: int,
                    vc: ViewChange) -> int:
        """Ship one range's durable page images to the target's frames,
        verified. Returns the page bytes moved.

        The fused path (``cfg.kernel_impl != "staged"``) runs ONE
        ``apply_unpack`` pass over the whole range on the receiving
        side: checksum-verify every shipped image against the source's
        per-page popcount summary and assemble them in a single device
        read, instead of a per-page host loop. A mismatch means the
        transfer corrupted a page — raise rather than land bad bytes.
        The landed bytes are identical on both paths."""
        pids: List[int] = []
        imgs: List[np.ndarray] = []
        for pid in self._range_pids(r):
            img = src.durable_page_image(pid)
            if img is None:
                continue
            pids.append(pid)
            imgs.append(np.ascontiguousarray(img, dtype=np.uint8))
        ps = self.cfg.kv.page_size
        if pids and self.cfg.kernel_impl != "staged" and ps % 128 == 0:
            from repro_torch.kernels.apply_unpack import apply_unpack
            t0 = time.perf_counter()
            packed = torch.from_numpy(
                np.concatenate([i.reshape(-1) for i in imgs])).to(self.device)
            self.device_copy_s += time.perf_counter() - t0
            expected = np.array(
                [int(np.unpackbits(i.reshape(-1)).sum()) for i in imgs],
                dtype=np.uint32)
            t0 = time.perf_counter()
            res = apply_unpack(torch.zeros(len(pids) * ps, dtype=torch.uint8,
                                           device=self.device), packed,
                               np.arange(len(pids), dtype=np.int32),
                               expected, block_bytes=ps,
                               impl=self.cfg.kernel_impl)
            if res.nbad:
                raise RuntimeError(
                    f"migration copy of range {r}: checksum mismatch on "
                    f"{res.nbad} of {len(pids)} page image(s)")
            out = res.out.cpu().numpy()
            self.device_copy_s += time.perf_counter() - t0
            imgs = [out[i * ps:(i + 1) * ps] for i in range(len(pids))]
        page_bytes = 0
        for pid, img in zip(pids, imgs):
            dst.cache.put(pid, img, store=dst.store)
            vc.pages_moved += 1
            page_bytes += int(img.size)
            self._fp("copy:page")
        return page_bytes

    def _migrate_batch(self, batch: List[int], view: int,
                       vc: ViewChange) -> None:
        """Migrate a batch of ranges stage-interleaved: every range's
        copy, then every flush, then every ownership flip, then every
        invalidate (each range keeps the module docstring's per-range
        ordering and failpoints, so crash behavior per range is exactly
        the serial protocol's), priced on the modeled clock.

        Wall-clock pricing: each range's work is attributed to the
        engines that did it (source-side ns, target-side ns including
        the interconnect term, shard-map ns). Within the batch one
        engine serializes everything it touches, distinct engines
        overlap — the batch's wall time is the max over engines of
        their summed work, plus the (serialized) shard-map flips."""
        moves = []
        for r in batch:
            moves.append({"r": r, "src": self.map.owner_of_range(r),
                          "dst": vc.target[r], "moved": 0,
                          "ns_src": 0.0, "ns_dst": 0.0, "ns_meta": 0.0})

        # --- copy: each range ships the source's durable cut. Commit
        # the source WAL tail first so the cut covers every applied
        # write, then ship page images (checkpoint-age) and committed
        # WAL records (newer, replayed through dst.put so they land in
        # the target's own WAL *after* the images they supersede —
        # recovery order stays valid).
        for m in moves:
            src, dst = self._engines[m["src"]], self._engines[m["dst"]]
            s0, d0 = self._snap(m["src"]), self._snap(m["dst"])
            self._commit_shard(m["src"])
            page_bytes = self._copy_pages(src, dst, m["r"], vc)
            wal_bytes = wal_records = 0
            for key, value in src.committed_wal_records():
                if self.range_of(key) != m["r"]:
                    continue
                dst.put(key, value)
                wal_records += 1
                wal_bytes += _REC.size + len(value)
                self._fp("copy:wal")
            m["moved"] = page_bytes + wal_bytes
            vc.page_bytes += page_bytes
            vc.wal_bytes += wal_bytes
            vc.wal_records_moved += wal_records
            m["ns_src"] += self._price(m["src"], s0)
            m["ns_dst"] += self._price(m["dst"], d0,
                                       transfer_bytes=m["moved"])
        # --- flush: durable on each target, still unreachable
        for m in moves:
            d0 = self._snap(m["dst"])
            self._engines[m["dst"]].cache.writeback(
                self._engines[m["dst"]].store)
            self._commit_shard(m["dst"])
            self._fp("flush:done")
            m["ns_dst"] += self._price(m["dst"], d0)
        # --- ownership records: the atomic per-range commit points
        for m in moves:
            m0 = self.meta_pool.stats.snapshot()
            self.map.record_owner(m["r"], view, m["dst"])
            self._fp("own:committed")
            m["ns_meta"] += self.cost_model.engine_time_ns(
                self.meta_pool.stats.delta(m0))
        # --- invalidate: each source durably forgets its range
        for m in moves:
            s0 = self._snap(m["src"])
            for pid in self._range_pids(m["r"]):
                self._engines[m["src"]].discard_page(pid)
            self._fp("invalidate:done")
            m["ns_src"] += self._price(m["src"], s0)

        per_engine: Dict[int, float] = {}
        for m in moves:
            per_engine[m["src"]] = per_engine.get(m["src"], 0.0) + m["ns_src"]
            per_engine[m["dst"]] = per_engine.get(m["dst"], 0.0) + m["ns_dst"]
            vc.engine_ns += m["ns_src"] + m["ns_dst"] + m["ns_meta"]
            vc.transfer_ns += self.cost_model.cluster_transfer_ns(m["moved"])
        vc.wall_ns += (max(per_engine.values(), default=0.0)
                       + sum(m["ns_meta"] for m in moves))

    def _scrub_all(self) -> None:
        """Discard every non-owner copy of every range — idempotent
        convergence sweep (reopen + view-change tail). Quietly drops
        frames an engine's WAL replay resurrected for keys that migrated
        away, finishes any invalidation a crash interrupted, and fences
        stale WAL residue (below)."""
        owners = self.map.owners()
        owned: Dict[int, set] = {sid: set() for sid in self._engines}
        for r, own_sid in owners.items():
            owned.setdefault(own_sid, set()).add(r)
            for sid, eng in self._engines.items():
                if sid == own_sid:
                    continue
                for pid in self._range_pids(r):
                    eng.discard_page(pid)
        # WAL fence: an engine whose WAL still holds committed records
        # for ranges it does NOT own would replay them unconditionally on
        # a later restart — over newer page images shipped by a re-run
        # copy (the migration target after a crash-interrupted copy) or
        # by a reshard that moves the range back (the migration source,
        # whose records outlive the invalidate step) — reverting
        # committed writes. Checkpoint such engines now: the non-owned
        # frames were dropped above, so the checkpoint flushes only owned
        # data and truncates the stale records away.
        for sid in sorted(self._engines):
            eng = self._engines[sid]
            if any(self.range_of(key) not in owned[sid]
                   for key, _ in eng.committed_wal_records()):
                eng.checkpoint()
