"""The spill scheduler — PMem→SSD eviction, promotion, and recovery.

One :class:`SpillScheduler` owns one pool's flash tier: the
:class:`~repro_torch.core.ssd.SSD` device, the SSD *arena* regions it
bump-allocates extents from (``KIND_SSD`` directory records), and the
durable **spill map** that makes every spilled object reachable after a
crash. Two object kinds spill:

* **cold page slots** — a :class:`~repro_torch.io.flushq.FlushQueue` epoch
  that outgrows the PMem slot budget evicts least-recently-touched
  pages: the slot's durable bytes go to an SSD extent, a checksummed map
  record commits (one Zero-log barrier), and only then is the PMem slot
  header invalidated and freed. Access promotes the page back
  (:meth:`read_page`), CoW-ing it into a PMem slot with a version number
  strictly above its SSD history, then tombstoning the map record.
* **sealed WAL generations** — :meth:`MultiLog.roll
  <repro_torch.io.multilog.MultiLog.roll>` enqueues the sealed generation
  here; :meth:`drain` serializes its entries to an extent, flushes the
  device, commits the map record, and only then advances the log's
  durable retired watermark. The watermark is what recovery consults,
  so a crash mid-spill recovers the generation wholly from PMem (not yet
  retired) or wholly from SSD (retired) — **never both**, and never a
  partial spill (the map record, which locates the SSD copy, is only
  committed after the device flush).

The ordering discipline throughout is *down-tier first*: SSD bytes →
SSD flush → PMem map record → PMem source invalidation. Every crash
window leaves either two identical copies (resolved by preferring the
PMem version at equal-or-higher pvn / an unretired watermark) or one.

The spill map itself is double-buffered: records append to one of two
Zero logs (``<name>.map0/1``) selected by a ping-pong head
(``<name>.mhd``); when the active log fills, the live records are
written to the other log and the head flips atomically.

"Async" here means what it means everywhere in this codebase: spill
work runs at *epoch* boundaries (a flush-queue drain, a checkpoint),
off the application's critical path, and its modeled SSD time is
reported separately so the cost model can overlap it with PMem lane
work. The simulator executes it inline.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.costmodel import SSD_COST_MODEL, SSDCostModel
from repro_torch.core.persist import FlushKind
from repro_torch.core.ssd import SSD, SSDStats

__all__ = ["SpillScheduler", "SpillStats"]

# map record types
_REC_PAGE = 1        # page spilled:   owner, pid, pvn, ssd_off, length, crc
_REC_PAGE_BACK = 2   # page promoted:  owner, pid, pvn
_REC_GEN = 3         # generation spilled: owner, gen, ssd_off, length,
                     #                     entry count, crc

_PAGE = struct.Struct("<IQQII")    # pid, pvn, ssd_off, length, crc
_PAGE_BACK = struct.Struct("<IQ")  # pid, pvn
_GEN = struct.Struct("<QQIII")     # gen, ssd_off, length, count, crc
_MHD = struct.Struct("<QI")        # counter, active map index
_U32 = struct.Struct("<I")

#: default SSD arena region size
DEFAULT_ARENA_BYTES = 1 << 22


class SpillStats:
    """Monotonic spill-activity counters (volatile; the durable truth is
    the spill map)."""

    def __init__(self) -> None:
        self.pages_spilled = 0
        self.pages_promoted = 0
        self.generations_spilled = 0
        self.map_compactions = 0


class SpillScheduler:
    """Eviction/promotion scheduler for one pool's SSD tier.

    Construction opens (or creates) the durable spill map and replays it;
    page stores are then registered with :meth:`attach_pages` and
    generational logs with :meth:`MultiLog.attach_spill
    <repro_torch.io.multilog.MultiLog.attach_spill>`. The scheduler is safe to
    re-open on a recovered pool: everything it needs is in the map and
    the directory.

        pool = Pool.create(None, 1 << 24)
        pool.attach_ssd(SSD(1 << 26))
        sp = SpillScheduler(pool, name="sp")
        pages = pool.pages("heap", npages=256, page_size=4096, nslots=32)
        sp.attach_pages(pages)
        fq = pages.flush_queue(lanes=4)
        fq.spill = sp                      # or FlushQueue(..., spill=sp)
    """

    def __init__(self, pool, ssd: Optional[SSD] = None, *,
                 name: str = "spill",
                 low_watermark: float = 0.25,
                 arena_bytes: int = DEFAULT_ARENA_BYTES,
                 map_capacity: int = 1 << 16,
                 keep_generations: int = 8,
                 arena_socket: int = 0,
                 ssd_cost: SSDCostModel = SSD_COST_MODEL) -> None:
        """Open-or-create the scheduler's durable state on ``pool``.

        Args:
            pool: the :class:`repro_torch.pool.Pool` whose consumers spill.
            ssd: flash device; attached to the pool if not already
                (``None`` uses the pool's previously attached device).
            name: prefix for the scheduler's regions (``<name>.mhd``,
                ``<name>.map0/1`` in PMem; ``<name>.sx<i>`` on SSD) —
                keep it short, region names cap at 20 bytes.
            low_watermark: fraction of a store's slots kept free beyond
                the immediate need when evicting (eviction slack, so
                each epoch does not immediately re-trigger a drain).
            arena_bytes: size of each SSD arena region; a new arena is
                allocated (a directory entry) when the current one fills.
            map_capacity: bytes per spill-map log; the map compacts into
                its double buffer when full.
            keep_generations: retired WAL generations kept reachable per
                log (newest first). Older archive records are pruned at
                the next spill so the map's live set stays bounded — the
                *correctness* tier for a generation is always the
                watermark, this only bounds how far back the SSD archive
                reaches.
            arena_socket: NUMA home socket for arenas this scheduler
                *creates* (existing arenas keep their directory-recorded
                home). The cache's fill-socket accounting reads it back
                via :meth:`fill_socket`.
            ssd_cost: converts the device's op counts to modeled time.
        """
        self.pool = pool
        if ssd is not None:
            pool.attach_ssd(ssd)
        if pool.ssd_dev is None:
            raise ValueError(
                "SpillScheduler needs a flash device: pass ssd= or call "
                "pool.attach_ssd(SSD(...)) first")
        self.ssd: SSD = pool.ssd_dev
        self.name = name
        self.low_watermark = float(low_watermark)
        self.arena_bytes = int(arena_bytes)
        self.keep_generations = int(keep_generations)
        self.arena_socket = int(arena_socket)
        self.ssd_cost = ssd_cost
        self.stats = SpillStats()
        #: test-only failpoint hook: called with a protocol point name;
        #: raising aborts mid-protocol exactly like a crash would
        self.failpoints = None
        #: promotion admission policy: ``(owner, pid) -> bool`` consulted
        #: before any on-access promotion. ``None`` = promote on first
        #: access (the legacy behavior). A ``repro_torch.cache.BufferManager``
        #: registers its k-touch counter here, so every consumer —
        #: including direct ``read_page(promote=True)`` callers —
        #: inherits the same policy.
        self.admission = None
        #: mid-flush guard: ``(owner, pid) -> bool``; pages reported
        #: pinned are not eviction victims in :meth:`ensure_slots`'s
        #: normal pass (the buffer manager pins a frame for the duration
        #: of its write-back epoch). The ``allow_protected`` retry may
        #: still take them — same rule as the epoch's own batch.
        self.pin_guard = None
        #: post-eviction hook ``(owner, pid)`` called after *every* page
        #: eviction, in addition to the per-owner ``on_evict`` callbacks
        #: (the buffer manager resets its admission count there)
        self.on_page_evict = None

        cl = pool.geometry.cache_line
        self._mhd = pool.raw(f"{name}.mhd", nbytes=2 * cl)
        self._maps = []
        for j in (0, 1):
            rname = f"{name}.map{j}"
            if pool.directory.lookup(rname) is not None:
                self._maps.append(pool.log(rname))   # durable record decides
            else:
                self._maps.append(pool.log(rname, capacity=int(map_capacity),
                                           technique="zero"))
        self._mhd_counter, self._active_map = self._read_mhd()

        # durable state, replayed from the active map log
        self._page_map: Dict[Tuple[str, int], Tuple[int, int, int, int]] = {}
        self._gen_map: Dict[Tuple[str, int], Tuple[int, int, int, int]] = {}
        for raw in self._maps[self._active_map].recovered.entries:
            self._replay(bytes(raw))

        # SSD arenas (KIND_SSD regions <name>.sx<i>) + bump pointer
        self._arenas = []
        i = 0
        while pool.directory.lookup(f"{name}.sx{i}") is not None:
            self._arenas.append(pool.ssd_region(f"{name}.sx{i}"))
            i += 1
        self._bump = 0
        for off, length, *_ in list(self._page_map.values()) + list(
                self._gen_map.values()):
            self._bump = max(self._bump, off + length)
        for a in self._arenas:
            self._bump = max(self._bump, a.base)
        # Extents whose page was promoted (tombstoned) or re-spilled are
        # reusable: no live map record references them, and the record
        # that superseded them was durably committed BEFORE they were
        # freed, so reuse is crash-safe. The list is volatile but
        # RECONSTRUCTIBLE: the replayed map is the complete live set, so
        # on (re)open every arena byte below the bump pointer that no
        # live record covers is a hole a previous run leaked — free it.
        # (Records pruned from the archive tail are only reclaimed this
        # way once a compaction durably drops them from the map; until
        # then the stale replayed record keeps the extent conservatively
        # live. Durable *compaction* of the arenas themselves remains
        # open — see ROADMAP.)
        self._free_extents: List[Tuple[int, int]] = []
        self._rebuild_free_extents()

        # volatile: registered stores, LRU clock, queued generation spills
        self._stores: Dict[int, Tuple[str, object]] = {}
        self._on_evict: Dict[str, object] = {}
        self._clock = 0
        self._last_use: Dict[Tuple[str, int], int] = {}
        self._genq: List[Tuple[object, int]] = []

    # ------------------------------------------------------------ wiring

    def attach_pages(self, pages, name: Optional[str] = None,
                     on_evict=None) -> None:
        """Register a page store (or :class:`~repro_torch.pool.PagesHandle`) so
        its pages can spill. ``name`` keys the store's map records and
        defaults to the handle's region name. ``on_evict(pid)``, if
        given, is called after each eviction — consumers with their own
        per-page bookkeeping (the checkpoint manager's shadow slots) use
        it to drop state that referenced the freed slot."""
        store = getattr(pages, "store", pages)
        owner = name if name is not None else getattr(pages, "name", None)
        if owner is None:
            raise ValueError("attach_pages needs a PagesHandle or an "
                             "explicit name= for a bare PageStore")
        self._stores[id(store)] = (owner, store)
        if on_evict is not None:
            self._on_evict[owner] = on_evict
        # Seed the store's pvn floors from the map: a page whose version
        # history continued on SSD must re-enter PMem strictly above it
        # (recovery resolves tiers by max pvn).
        for (o, pid), (_, _, pvn, _) in self._page_map.items():
            if o == owner:
                store.pvn_floor[pid] = max(store.pvn_floor.get(pid, 0), pvn)

    def _owner_of(self, store) -> str:
        try:
            return self._stores[id(store)][0]
        except KeyError:
            raise ValueError(
                "page store is not registered with this scheduler; call "
                "attach_pages(handle) first") from None

    def touch(self, pid: int, store=None) -> None:
        """Record recent use of a page (LRU signal). With a single
        registered store the store argument may be omitted."""
        owner = (self._owner_of(store) if store is not None
                 else next(iter(self._stores.values()), ("?",))[0])
        self._clock += 1
        self._last_use[(owner, int(pid))] = self._clock

    # ----------------------------------------------------------- failpoint

    def _fp(self, point: str) -> None:
        if self.failpoints is not None:
            self.failpoints(point)

    # ------------------------------------------------------------ spill map

    def _read_mhd(self) -> Tuple[int, int]:
        img = self._mhd.durable_view()
        cl = self.pool.geometry.cache_line
        best = (0, 0)
        for slot in range(2):
            counter, active = _MHD.unpack_from(img, slot * cl)
            if counter > best[0]:
                best = (counter, active)
        return best

    def _write_mhd(self, active: int) -> None:
        self._mhd_counter += 1
        slot = self._mhd_counter % 2
        cl = self.pool.geometry.cache_line
        self._mhd.store(slot * cl, _MHD.pack(self._mhd_counter, active),
                        streaming=True)
        self._mhd.persist(slot * cl, _MHD.size, kind=FlushKind.NT)
        self._active_map = active

    @staticmethod
    def _encode(rtype: int, owner: str, body: bytes) -> bytes:
        ob = owner.encode("utf-8")
        return bytes([rtype, len(ob)]) + ob + body

    def _replay(self, raw: bytes) -> None:
        rtype, olen = raw[0], raw[1]
        owner = raw[2 : 2 + olen].decode("utf-8")
        body = raw[2 + olen :]
        if rtype == _REC_PAGE:
            pid, pvn, off, length, crc = _PAGE.unpack_from(body)
            self._page_map[(owner, pid)] = (off, length, pvn, crc)
        elif rtype == _REC_PAGE_BACK:
            pid, pvn = _PAGE_BACK.unpack_from(body)
            cur = self._page_map.get((owner, pid))
            if cur is not None and pvn >= cur[2]:
                del self._page_map[(owner, pid)]
        elif rtype == _REC_GEN:
            gen, off, length, count, crc = _GEN.unpack_from(body)
            self._gen_map[(owner, gen)] = (off, length, count, crc)

    def _map_append(self, raw: bytes) -> None:
        """Durably append one map record (one Zero-log barrier),
        compacting into the double buffer when the active log fills."""
        try:
            self._maps[self._active_map].append(raw)
        except RuntimeError:
            self._compact_map()
            try:
                self._maps[self._active_map].append(raw)
            except RuntimeError:
                raise RuntimeError(
                    f"spill map {self.name!r} cannot hold its live record "
                    f"set even after compaction ({len(self._page_map)} "
                    f"pages + {len(self._gen_map)} generations); create "
                    f"the scheduler with a larger map_capacity") from None
        self._replay(raw)

    def _compact_map(self) -> None:
        """Rewrite the live records into the inactive map log, then flip
        the ping-pong head (one barrier — the atomic switch; a crash
        before it recovers the old map, after it the new one)."""
        other = 1 - self._active_map
        self._maps[other].reset()
        try:
            for (owner, pid), (off, length, pvn, crc) in self._page_map.items():
                self._maps[other].append(self._encode(
                    _REC_PAGE, owner, _PAGE.pack(pid, pvn, off, length, crc)))
            for (owner, gen), (off, length, count, crc) in self._gen_map.items():
                self._maps[other].append(self._encode(
                    _REC_GEN, owner, _GEN.pack(gen, off, length, count, crc)))
        except RuntimeError:
            raise RuntimeError(
                f"spill map {self.name!r} cannot hold its live record set "
                f"({len(self._page_map)} pages + {len(self._gen_map)} "
                f"generations); create the scheduler with a larger "
                f"map_capacity") from None
        self._write_mhd(other)
        self.stats.map_compactions += 1

    # --------------------------------------------------------- SSD extents

    def _rebuild_free_extents(self) -> None:
        """Rebuild the extent free-list from the durable spill map: every
        arena byte below the bump pointer not covered by a live map
        record is reusable. Run at (re)open, this reclaims the holes a
        previous process run tombstoned or superseded but could only
        leak (the free list used to be rebuilt-by-use only) — a
        long-lived tiered engine's SSD footprint now survives reopen
        proportional to its live set plus the archive tail."""
        live = sorted(
            (off, length)
            for off, length, *_ in list(self._page_map.values())
            + list(self._gen_map.values()))
        self._free_extents = []
        li = 0
        for a in sorted(self._arenas, key=lambda a: a.base):
            end = min(a.base + a.length, self._bump)
            pos = a.base
            while li < len(live) and live[li][0] < end:
                off, length = live[li]
                if off + length <= pos:
                    li += 1
                    continue
                if off > pos:
                    self._free_extents.append((pos, off - pos))
                pos = max(pos, off + length)
                li += 1
            if pos < end:
                self._free_extents.append((pos, end - pos))

    def _alloc(self, nbytes: int) -> int:
        """Allocate an SSD extent: reuse a freed one when it fits, else
        bump-allocate, growing the arena set (a new ``KIND_SSD``
        directory region) when the current arenas run out."""
        nbytes = max(1, int(nbytes))
        for i, (off, ln) in enumerate(self._free_extents):
            if ln >= nbytes:
                del self._free_extents[i]
                if ln > nbytes:
                    self._free_extents.append((off + nbytes, ln - nbytes))
                return off
        for a in self._arenas:
            if self._bump >= a.base and self._bump + nbytes <= a.base + a.length:
                off = self._bump
                self._bump += nbytes
                return off
        size = max(self.arena_bytes, nbytes)
        arena = self.pool.ssd_region(f"{self.name}.sx{len(self._arenas)}",
                                     nbytes=size, socket=self.arena_socket)
        self._arenas.append(arena)
        off = arena.base
        self._bump = off + nbytes
        return off

    # ----------------------------------------------------------- page side

    def ensure_slots(self, store, need: int = 1,
                     protect: Iterable[int] = (),
                     allow_protected: bool = False) -> int:
        """Evict cold pages until ``store`` has ``need`` free slots (plus
        the low-watermark slack). Pages in ``protect`` (the epoch's own
        batch) are not victims — unless ``allow_protected`` is set, which
        the flush queue's mid-batch retry uses when CoW genuinely found
        no slot (a batch larger than the whole budget has to cycle
        through its own members). Returns the number of pages evicted;
        stops early once only protected pages remain (without the
        override) or the store is empty."""
        owner = self._owner_of(store)
        protected: Set[int] = {int(p) for p in protect}
        if self.pin_guard is not None:
            # the buffer manager's mid-flush guard: a page whose DRAM
            # frame is pinned (its image is inside a write-back epoch) is
            # not a victim — same standing as the epoch's own batch
            protected |= {pid for pid in store.table
                          if self.pin_guard(owner, pid)}
        slack = int(self.low_watermark * store.layout.nslots)
        target = min(int(need) + slack, store.layout.nslots)
        evicted = 0
        while len(store.free) < target:
            victims = [pid for pid in store.table if pid not in protected]
            if not victims:
                break
            victim = min(victims,
                         key=lambda p: self._last_use.get((owner, p), 0))
            self._evict_page(owner, store, victim)
            evicted += 1
        if allow_protected:
            hard = min(int(need), store.layout.nslots)
            while len(store.free) < hard and store.table:
                victim = min(store.table,
                             key=lambda p: self._last_use.get((owner, p), 0))
                self._evict_page(owner, store, victim)
                evicted += 1
        return evicted

    def _evict_page(self, owner: str, store, pid: int) -> None:
        """Spill one page: SSD bytes → flush → map record → release the
        PMem slot. See the module docstring for the crash argument."""
        layout = store.layout
        slot, pvn = store.table[pid]
        data = store.pmem.load(layout.slot_data_off(slot), layout.page_size,
                               uncached=True)
        prev = self._page_map.get((owner, pid))   # re-spill supersedes this
        off = self._alloc(layout.page_size)
        self.ssd.pwrite(off, data)
        self._fp("page:ssd_written")
        self.ssd.flush()
        self._fp("page:ssd_flushed")
        crc = zlib.crc32(data.tobytes()) & 0xFFFFFFFF
        self._map_append(self._encode(
            _REC_PAGE, owner, _PAGE.pack(pid, pvn, off, layout.page_size,
                                         crc)))
        self._fp("page:mapped")
        if prev is not None:
            # the new record durably superseded the old extent — reusable
            self._free_extents.append((prev[0], prev[1]))
        store.release(pid)
        store.pvn_floor[pid] = max(store.pvn_floor.get(pid, 0), pvn)
        self._last_use.pop((owner, pid), None)
        self.stats.pages_spilled += 1
        cb = self._on_evict.get(owner)
        if cb is not None:
            cb(pid)
        if self.on_page_evict is not None:
            self.on_page_evict(owner, pid)

    def residency(self, store, pid: int) -> Optional[str]:
        """Which tier holds the page's current version under the
        cross-tier max-pvn rule: ``"pmem"``, ``"ssd"``, or ``None`` when
        the page has never been flushed. The buffer manager's fill path
        routes on this."""
        owner = self._owner_of(store)
        pid = int(pid)
        rec = self._page_map.get((owner, pid))
        if pid in store.table and (rec is None
                                   or store.table[pid][1] >= rec[2]):
            return "pmem"
        return "ssd" if rec is not None else None

    def _arena_socket_of(self, off: int) -> int:
        """Home socket of the arena covering an SSD extent offset (the
        directory-recorded region home; 0 if no arena covers it)."""
        for a in self._arenas:
            if a.base <= off < a.base + a.length:
                return a.record.socket
        return 0

    def fill_socket(self, store, pid: int) -> int:
        """The NUMA home socket a cache fill for this page would read
        from: the PMem slot's home-socket tag when PMem-resident, the
        covering SSD arena's region home when spilled, 0 for pages in
        neither tier. The buffer manager tags frames (and counts remote
        fills) with this."""
        owner = self._owner_of(store)
        pid = int(pid)
        tier = self.residency(store, pid)
        if tier == "pmem":
            slot, _ = store.table[pid]
            return store.pmem.home_socket(store.layout.slot_off(slot))
        if tier == "ssd":
            return self._arena_socket_of(self._page_map[(owner, pid)][0])
        return 0

    def read_page(self, store, pid: int, *, promote: bool = True
                  ) -> np.ndarray:
        """Read a page wherever it lives. PMem-resident pages read from
        their slot; spilled ones read from SSD (checksum-verified) and,
        with ``promote=True``, are re-installed in a PMem slot (evicting
        something colder if the store is full) with a version number
        strictly above their SSD history, then tombstoned off the map.

        When an :attr:`admission` policy is registered (the buffer
        manager's k-touch counter), ``promote=True`` is a *request*: the
        policy decides whether this access actually promotes — replacing
        the legacy promote-on-first-access."""
        owner = self._owner_of(store)
        pid = int(pid)
        self.touch(pid, store)
        if promote and self.admission is not None:
            promote = bool(self.admission(owner, pid))
        # cross-tier max-pvn rule (residency): the PMem slot wins at
        # equal pvn (the copies are identical then — the crash landed
        # between the map record and the slot release); a *lower* PMem
        # pvn is a stale durable header the SSD history superseded
        tier = self.residency(store, pid)
        if tier == "pmem":
            return store.read_page(pid)
        if tier is None:
            raise KeyError(f"page {pid} of {owner!r} is in neither tier")
        off, length, pvn, crc = self._page_map[(owner, pid)]
        data = self.ssd.pread(off, length)
        if (zlib.crc32(data.tobytes()) & 0xFFFFFFFF) != crc:
            raise RuntimeError(
                f"page {pid} of {owner!r}: SSD copy fails its checksum "
                f"(torn spill should be unreachable — map records commit "
                f"after the device flush)")
        if promote:
            self.ensure_slots(store, need=1, protect=(pid,))
            store.flush_cow(pid, data, pvn_floor=pvn + 1)
            self._fp("page:promoted")
            self._map_append(self._encode(
                _REC_PAGE_BACK, owner, _PAGE_BACK.pack(pid, pvn)))
            # the durable tombstone released the extent for reuse
            self._free_extents.append((off, length))
            self.stats.pages_promoted += 1
        return data

    def discard_page(self, store, pid: int) -> None:
        """Durably forget a page from *both* tiers — the cross-shard
        invalidation step of a view change (repro.cluster): by the time
        the source engine discards a range, its new owner already holds
        the content durably behind a committed ownership record, so
        ordering within the discard is not a commit point. The SSD copy
        is superseded by the same ``PAGE_BACK`` tombstone a promotion
        writes (the extent is reusable once the tombstone is durable);
        the PMem slot is released through the store's durable
        header-invalidate, with the version floor pinned so a later
        re-migration back cannot resurrect the stale history."""
        owner = self._owner_of(store)
        pid = int(pid)
        rec = self._page_map.pop((owner, pid), None)
        if rec is not None:
            off, length, pvn, _crc = rec
            self._map_append(self._encode(
                _REC_PAGE_BACK, owner, _PAGE_BACK.pack(pid, pvn)))
            self._free_extents.append((off, length))
        if pid in store.table:
            slot_pvn = store.table[pid][1]
            store.release(pid)
            store.pvn_floor[pid] = max(store.pvn_floor.get(pid, 0), slot_pvn)
        self._last_use.pop((owner, pid), None)

    def read_spilled(self, owner: str, pid: int,
                     pvn: Optional[int] = None) -> np.ndarray:
        """Checksum-verified read of a spilled page *by owner name*,
        without a registered store — the checkpoint restore path, which
        deliberately verifies manifests before opening the page region.
        ``pvn`` (if given) must match the map record's, so a manifest can
        pin the exact version it committed."""
        rec = self._page_map.get((owner, int(pid)))
        if rec is None:
            raise KeyError(f"page {pid} of {owner!r} is not on SSD")
        off, length, rec_pvn, crc = rec
        if pvn is not None and int(pvn) != rec_pvn:
            raise KeyError(
                f"page {pid} of {owner!r}: SSD holds pvn {rec_pvn}, "
                f"caller pinned pvn {pvn}")
        data = self.ssd.durable_read(off, length)
        if (zlib.crc32(data.tobytes()) & 0xFFFFFFFF) != crc:
            raise RuntimeError(
                f"page {pid} of {owner!r}: SSD copy fails its checksum")
        return data

    def read_spilled_many(self, owner: str,
                          wants: List[Tuple[int, Optional[int]]]
                          ) -> List[np.ndarray]:
        """Batched :meth:`read_spilled`: fetch ``[(pid, pvn), ...]`` in
        one call, returned in request order. The fused restore path uses
        this so a leaf's SSD-resident pages arrive together and the
        whole leaf can be verified+assembled in a single device pass;
        any page that is missing, version-mismatched or corrupt raises
        exactly like the single-page read would."""
        return [self.read_spilled(owner, pid, pvn) for pid, pvn in wants]

    def spilled_pages(self, store=None) -> Dict[int, int]:
        """``{pid: pvn}`` of pages currently mapped to SSD (for one
        registered store, or all owners when ``store`` is ``None``)."""
        if store is None:
            return {pid: rec[2] for (_, pid), rec in self._page_map.items()}
        owner = self._owner_of(store)
        return {pid: rec[2] for (o, pid), rec in self._page_map.items()
                if o == owner}

    # ------------------------------------------------------ generation side

    def enqueue_generation(self, multilog, gen: int) -> None:
        """Queue a sealed WAL generation as a spill candidate (called by
        :meth:`MultiLog.roll`, and by ``attach_spill`` for generations
        recovered sealed-but-unretired). The generation stays
        PMem-resident and recoverable until :meth:`drain` durably
        retires it. Duplicate enqueues coalesce."""
        item = (multilog, int(gen))
        if item not in self._genq:
            self._genq.append(item)

    def drain(self) -> int:
        """Process every queued generation spill: serialize → SSD write →
        device flush → map record → advance the log's retired watermark
        (which re-zeroes the freed ring slot). Returns the number of
        generations retired. Runs at epoch boundaries (a checkpoint, a
        ring-full roll) — never on the append path."""
        done = 0
        queue, self._genq = self._genq, []
        for ml, gen in queue:
            if gen <= ml.retired_upto:
                continue  # already retired (e.g. an earlier forced drain)
            payloads = ml.sealed_generations().get(gen)
            if payloads is None:
                continue
            buf = bytearray(_U32.pack(len(payloads)))
            for p in payloads:
                buf += _U32.pack(len(p)) + p
            blob = bytes(buf)
            off = self._alloc(len(blob))
            self.ssd.pwrite(off, blob)
            self._fp("gen:ssd_written")
            self.ssd.flush()
            self._fp("gen:ssd_flushed")
            crc = zlib.crc32(blob) & 0xFFFFFFFF
            self._map_append(self._encode(
                _REC_GEN, ml.name,
                _GEN.pack(gen, off, len(blob), len(payloads), crc)))
            self._fp("gen:mapped")
            ml.mark_retired(gen)
            self._fp("gen:retired")
            # prune the archive tail so the map's live set stays bounded
            # (the SSD extents of pruned generations leak — the archive is
            # best-effort history, the watermark is the correctness rule)
            floor = gen - self.keep_generations
            for key in [k for k in self._gen_map
                        if k[0] == ml.name and k[1] <= floor]:
                del self._gen_map[key]
            self.stats.generations_spilled += 1
            done += 1
        return done

    def read_generation(self, owner: str, gen: int) -> List[bytes]:
        """Payloads of a retired generation, read back from SSD and
        verified against the map record's checksum and entry count."""
        rec = self._gen_map.get((owner, int(gen)))
        if rec is None:
            raise KeyError(f"generation {gen} of {owner!r} is not on SSD")
        off, length, count, crc = rec
        blob = self.ssd.pread(off, length).tobytes()
        if (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
            raise RuntimeError(
                f"generation {gen} of {owner!r}: SSD copy fails its "
                f"checksum (torn spill should be unreachable — the "
                f"retired watermark advances only after the device flush)")
        (n,) = _U32.unpack_from(blob, 0)
        if n != count:
            raise RuntimeError(f"generation {gen} of {owner!r}: entry "
                               f"count mismatch ({n} != {count})")
        out: List[bytes] = []
        pos = _U32.size
        for _ in range(n):
            (ln,) = _U32.unpack_from(blob, pos)
            pos += _U32.size
            out.append(blob[pos : pos + ln])
            pos += ln
        return out

    # ------------------------------------------------------------- metrics

    @property
    def pending_generations(self) -> int:
        """Sealed generations queued but not yet durably retired."""
        return len(self._genq)

    def modeled_ns(self, delta: SSDStats) -> float:
        """Modeled SSD time for a device op-count delta."""
        return self.ssd_cost.time_ns(delta)
