"""``repro_torch.cache.BufferManager`` — the DRAM rung of the Fig. 3 ladder.

The paper's latency ladder (Fig. 3: DRAM ≪ PMem ≪ flash) is what makes
tier placement worth engineering, yet until this module the stack read
every page from its *resident* tier on every access and promoted
SSD-resident pages on first touch — scans thrashed the spill tier and
nothing was ever served at DRAM latency. The buffer manager closes the
ladder's top rung: a bounded pool of DRAM *frames* in front of the
PMem page slots and the SSD spill tier, so the read path becomes

    frame hit (DRAM)  →  slot fill (PMem, uncached device read)
                      →  spill fill (SSD, checksum-verified via the map)

with per-tier hit/miss accounting (:class:`CacheStats`) that
``costmodel`` converts to modeled time against the Fig. 3 constants.
Every counter is attributed twice — globally (``stats``) and under the
region owner that caused it (``stats_by_owner``) — so a multi-tenant
consumer (``repro.serve``) gets per-tenant hit ratios for free, and
:meth:`BufferManager.set_quota` can cap one owner's resident frames
without touching the shared clock.

Design points, each load-bearing for crash safety:

* **Volatile by construction.** Frames are DRAM: nothing the cache does
  changes what a crash recovers. Dirty frames reach PMem only through
  the owning :class:`~repro_torch.io.flushq.FlushQueue` — the exact epoch
  path writes took before the cache existed — so recovery is
  bit-identical with the cache enabled, disabled, or sized to zero
  (``tests/test_crash_corpus.py`` replays the same op stream under
  ``frames=0`` and a warm cache and asserts identical recovered state).
* **Clock eviction, far-first then clean-first.** Frames are recycled
  by a clock (second-chance) sweep. Every frame records the NUMA
  socket it was *filled from* (the PMem slot's home-socket tag, or the
  SSD arena's region home); under pressure the sweep prefers far-filled
  frames, then clean ones — far-clean → near-clean → far-dirty →
  near-dirty, pin/ref rules unchanged. A dirty victim is not flushed
  synchronously but *parked* in the flush queue's pending set (still
  DRAM, still coalescing), where the next epoch drain picks it up —
  eviction never adds a durability point. On a single-socket pool every
  fill is near and the sweep is bit-identical to the socket-blind
  clock (``numa_evict=False`` restores that order for A/B).
* **Remote fills are charged the Izraelevitz read rung.** A fill whose
  source tier lives on a far socket crosses the interconnect; the
  counts land in ``CacheStats.remote_fills`` / ``remote_fill_bytes``
  and both ``readpath_time_ns`` and ``engine_time_ns(cache=…)`` add the
  ``numa_remote_block_mult`` surcharge (arXiv:1903.05714). Zero remote
  fills add exactly 0.0 — an all-near run is bit-identical to the
  pre-NUMA model.
* **2Q scan resistance inside an owner's quota.** Frames enter a
  *probationary* segment and graduate to *protected* on re-reference
  (Götze arXiv:2001.02172). For a quota'd owner whose probationary
  frames have reached ``scan_frac`` of the quota, the quota sweep
  recycles probationary frames only — one sequential scan cycles the
  probationary fraction of that owner's budget and leaves its
  re-referenced hot set resident. ``scan_frac=1.0`` (the default)
  disables the split; the knob is fixed at ``pool.cache(scan_frac=)``
  construction like ``admit_k`` and can be overridden per owner
  (:meth:`BufferManager.set_scan_frac` — the serve layer's per-tenant
  handle).
* **Pin/unpin.** A pinned frame is never clock-evicted, and the spill
  scheduler treats pinned pages as protected during ``ensure_slots``,
  so a spill epoch cannot evict the PMem slot of a page whose frame is
  mid-flush (:meth:`writeback` pins the batch for the epoch).
* **k-touch admission.** SSD→PMem promotion is no longer
  first-access: a spilled page is served *from DRAM* (the frame) until
  it has been touched ``admit_k`` times, and only then CoW-promoted
  into a PMem slot. Scans stop churning the slot budget; genuinely hot
  pages still end up in PMem. The policy is also registered as the
  spill scheduler's ``admission`` hook so direct
  :meth:`~repro_torch.tier.spill.SpillScheduler.read_page` callers inherit
  it. Write faults never promote (the fill is about to be superseded by
  a flush-queue CoW anyway).

One manager fronts one pool (``pool.cache(frames=, admit_k=)``, cached
like ``pool.placer()``); page regions register with
:meth:`attach_pages` and share the frame pool, keyed by region name —
the same multi-store shape as :class:`~repro_torch.tier.spill.SpillScheduler`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.costmodel import (
    COST_MODEL,
    SSD_COST_MODEL,
    PMemCostModel,
    SSDCostModel,
)

__all__ = ["BufferManager", "CacheStats"]


@dataclasses.dataclass
class CacheStats:
    """Per-tier read-path counts. All fields are monotonic counters.

    ``costmodel.PMemCostModel.readpath_time_ns`` converts a delta of
    these into modeled nanoseconds on the Fig. 3 ladder; DRAM-hit terms
    also fold into ``engine_time_ns(..., cache=delta)``.
    """

    #: reads served from a DRAM frame (or the flush queue's pending set)
    dram_hits: int = 0
    dram_hit_bytes: int = 0
    #: frame fills from a PMem page slot (uncached device reads)
    pmem_fills: int = 0
    pmem_fill_bytes: int = 0
    #: frame fills from the SSD spill tier (checksum-verified map reads)
    ssd_fills: int = 0
    ssd_fill_bytes: int = 0
    #: fills (PMem or SSD) whose source tier is homed on a far NUMA
    #: socket — a subset of pmem_fills/ssd_fills; the cost models add
    #: the Izraelevitz remote read surcharge for exactly these
    remote_fills: int = 0
    remote_fill_bytes: int = 0
    #: fresh pages materialized as zero frames (resident in no tier yet)
    fresh_pages: int = 0
    #: SSD→PMem promotions the k-touch policy admitted
    promotions: int = 0
    #: SSD reads served without promotion (below the admission threshold)
    admissions_deferred: int = 0
    #: clean frames recycled by the clock sweep
    evictions_clean: int = 0
    #: dirty frames parked in the flush queue by the clock sweep
    evictions_dirty: int = 0
    #: installs that overshot an owner's quota because every one of that
    #: owner's frames was pinned (the best-effort escape hatch of
    #: :meth:`BufferManager.set_quota`) — the serve layer's isolation
    #: claims are auditable against this
    quota_overflows: int = 0
    #: dirty frames pushed through a write-back epoch
    writebacks: int = 0

    def snapshot(self) -> "CacheStats":
        """A frozen copy of the current counters (windowing, like
        :meth:`PMemStats.snapshot <repro_torch.core.pmem.PMemStats.snapshot>`)."""
        return dataclasses.replace(self)

    def delta(self, since: "CacheStats") -> "CacheStats":
        """Counts accrued since a :meth:`snapshot`."""
        d = CacheStats()
        for f in dataclasses.fields(CacheStats):
            setattr(d, f.name,
                    getattr(self, f.name) - getattr(since, f.name))
        return d

    @property
    def accesses(self) -> int:
        """Total read-path accesses that touched any tier."""
        return (self.dram_hits + self.pmem_fills + self.ssd_fills
                + self.fresh_pages)

    @property
    def hit_ratio(self) -> float:
        """Fraction of read-path accesses served at DRAM latency."""
        total = self.accesses
        return self.dram_hits / total if total else 0.0


class _Frame:
    """One DRAM frame: a page image plus its cache state."""

    __slots__ = ("owner", "pid", "data", "dirty", "pins", "ref",
                 "socket", "protected")

    def __init__(self, owner: str, pid: int, data: np.ndarray,
                 socket: int = 0) -> None:
        self.owner = owner
        self.pid = pid
        self.data = data
        #: dirty line set (empty = clean; ``None`` = every line dirty),
        #: same convention as :meth:`FlushQueue.enqueue`
        self.dirty: Optional[Set[int]] = set()
        self.pins = 0
        self.ref = False
        #: NUMA socket the frame was filled from (the source tier's
        #: home-socket tag; DRAM-born content — writes, restores,
        #: fresh pages — carries the cache's local socket)
        self.socket = int(socket)
        #: 2Q segment: frames install probationary and graduate on
        #: re-reference; a quota'd owner's scan recycles only its
        #: probationary fraction (see ``scan_frac``)
        self.protected = False

    @property
    def is_dirty(self) -> bool:
        return self.dirty is None or bool(self.dirty)


class BufferManager:
    """Bounded DRAM frame pool fronting the three-tier page read path."""

    def __init__(self, pool=None, *, frames: int = 64, admit_k: int = 2,
                 scan_frac: float = 1.0, local_socket: int = 0,
                 cost_model: PMemCostModel = COST_MODEL,
                 ssd_cost: SSDCostModel = SSD_COST_MODEL) -> None:
        """Create a manager with ``frames`` DRAM frames.

        Args:
            pool: the :class:`repro_torch.pool.Pool` this cache fronts (held
                for introspection only; all I/O goes through registered
                stores and their flush queues).
            frames: frame-pool capacity in pages. ``0`` disables
                caching entirely — every read fills from its resident
                tier and every write routes straight into the flush
                queue's pending set; admission counting still runs, so
                promotion behavior is identical to a warm cache.
            admit_k: touches before an SSD-resident page is promoted
                into a PMem slot (1 = the legacy promote-on-first-access).
            scan_frac: probationary fraction of a quota'd owner's frame
                budget (2Q scan resistance). Once an owner's
                probationary frames reach ``scan_frac`` of its quota,
                the quota sweep recycles probationary frames only, so
                one sequential scan cycles that fraction of the budget
                and leaves the re-referenced (protected) hot set
                resident. ``1.0`` disables the split (the legacy
                clean-first quota sweep). Overridable per owner via
                :meth:`set_scan_frac`.
            local_socket: the NUMA socket the cache's consumers fault
                from; fills sourced from a region homed elsewhere count
                as ``remote_fills`` and pay the Izraelevitz read
                surcharge. Single-socket pools leave this at 0.
            cost_model: converts :class:`CacheStats` deltas and PMem op
                counts to modeled time.
            ssd_cost: flash constants for the SSD rungs of the ladder.
        """
        self.pool = pool
        self.capacity = max(0, int(frames))
        self.admit_k = max(1, int(admit_k))
        if not 0.0 < float(scan_frac) <= 1.0:
            raise ValueError("scan_frac must be in (0, 1]")
        self.scan_frac = float(scan_frac)
        self.local_socket = int(local_socket)
        #: socket-aware eviction order (far-clean → near-clean →
        #: far-dirty → near-dirty). ``False`` restores the socket-blind
        #: clean-first clock — the A/B knob ``benchmarks/readpath.py``
        #: uses to price what far-first eviction recovers.
        self.numa_evict = True
        self.cost_model = cost_model
        self.ssd_cost = ssd_cost
        self.stats = CacheStats()
        #: per-owner (region-name) CacheStats — every counter bump on
        #: ``stats`` is mirrored here under the owner that caused it
        #: (eviction counters attribute to the *victim* frame's owner),
        #: so ``sum(stats_by_owner.values())`` == ``stats`` field-wise.
        #: The serve layer reads these for per-tenant hit ratios.
        self.stats_by_owner: Dict[str, CacheStats] = {}
        self._frames: Dict[Tuple[str, int], _Frame] = {}
        self._ring: List[Tuple[str, int]] = []     # clock order
        self._hand = 0
        #: dirty keys in first-dirtied order — the write-back enqueue
        #: order, which matches the order a frameless (frames=0) run
        #: inserts the same pages into the flush queue
        self._dirty_order: Dict[Tuple[str, int], None] = {}
        self._stores: Dict[str, object] = {}
        self._owner_by_id: Dict[int, str] = {}
        self._fq: Dict[str, object] = {}
        self._spill: Dict[str, object] = {}
        #: touches per (owner, pid) — the k-touch admission counter
        self._touches: Dict[Tuple[str, int], int] = {}
        #: resident-frame count per owner (quota bookkeeping)
        self._owner_frames: Dict[str, int] = {}
        #: opt-in per-owner frame ceilings (absent = share freely)
        self._quota: Dict[str, int] = {}
        #: per-owner scan_frac overrides (absent = the cache-wide value)
        self._scan_frac: Dict[str, float] = {}

    # ------------------------------------------------------------- wiring

    @staticmethod
    def for_pool(pool, *, frames: Optional[int] = None,
                 admit_k: Optional[int] = None,
                 scan_frac: Optional[float] = None,
                 default_frames: Optional[int] = None,
                 default_admit_k: Optional[int] = None,
                 default_scan_frac: Optional[float] = None
                 ) -> "BufferManager":
        """Consumer-side get-or-create for ``pool.cache`` distinguishing
        *explicit* configuration from *defaults*: an explicit ``frames``
        / ``admit_k`` / ``scan_frac`` is verified against a pre-existing
        pool cache (a conflict raises, per :meth:`repro_torch.pool.Pool.cache`);
        ``None`` reuses an existing cache quietly, and only on a
        cache-less pool falls back to ``default_frames`` /
        ``default_admit_k`` / ``default_scan_frac`` (e.g. PersistentKV's
        one-frame-per-page buffer pool)."""
        if pool._cache is None:
            return pool.cache(
                frames=frames if frames is not None else default_frames,
                admit_k=admit_k if admit_k is not None else default_admit_k,
                scan_frac=(scan_frac if scan_frac is not None
                           else default_scan_frac))
        return pool.cache(frames=frames, admit_k=admit_k,
                          scan_frac=scan_frac)

    def attach_pages(self, pages, *, flushq=None, spill=None,
                     name: Optional[str] = None) -> None:
        """Register a page region (:class:`~repro_torch.pool.PagesHandle` or a
        bare :class:`~repro_torch.core.pageflush.PageStore` with ``name=``) as
        a consumer of the frame pool.

        ``flushq`` is the region's :class:`~repro_torch.io.flushq.FlushQueue`
        — the only path dirty frames take to PMem (one is created with
        defaults if omitted). ``spill`` is the region's
        :class:`~repro_torch.tier.spill.SpillScheduler`, if tiered; the cache
        registers its k-touch policy as the scheduler's ``admission``
        hook and its pinned set as the ``pin_guard``, and resets a
        page's touch count when its slot is evicted."""
        store = getattr(pages, "store", pages)
        owner = name if name is not None else getattr(pages, "name", None)
        if owner is None:
            raise ValueError("attach_pages needs a PagesHandle or an "
                             "explicit name= for a bare PageStore")
        if flushq is None:
            from repro_torch.io.flushq import FlushQueue
            flushq = FlushQueue(store, spill=spill)
        if spill is None:
            spill = flushq.spill
        self._stores[owner] = store
        self._owner_by_id[id(store)] = owner
        self._fq[owner] = flushq
        self._spill[owner] = spill
        if spill is not None:
            spill.admission = self._admit
            spill.pin_guard = self._is_pinned
            spill.on_page_evict = self._on_slot_evicted

    def _resolve(self, store) -> Tuple[str, object]:
        if store is None:
            if len(self._stores) != 1:
                raise ValueError(
                    "this cache fronts multiple page regions; pass store=")
            owner = next(iter(self._stores))
            return owner, self._stores[owner]
        st = getattr(store, "store", store)
        try:
            owner = self._owner_by_id[id(st)]
        except KeyError:
            raise ValueError(
                "page store is not registered with this cache; call "
                "attach_pages(handle) first") from None
        return owner, st

    # ------------------------------------------------------- accounting

    def _acct(self, owner: str, field: str, n: int = 1) -> None:
        """Bump one :class:`CacheStats` counter globally *and* under the
        owner it is attributed to (the accessed region for hits/fills,
        the victim frame's region for evictions)."""
        setattr(self.stats, field, getattr(self.stats, field) + n)
        per = self.stats_by_owner.get(owner)
        if per is None:
            per = self.stats_by_owner[owner] = CacheStats()
        setattr(per, field, getattr(per, field) + n)

    def owner_stats(self, owner: str) -> CacheStats:
        """The live :class:`CacheStats` attributed to one region owner
        (created on first request, so callers may ``snapshot()`` it
        before the first access). Owners are region names — the serve
        layer keys tenants by their KV's pages region."""
        per = self.stats_by_owner.get(owner)
        if per is None:
            per = self.stats_by_owner[owner] = CacheStats()
        return per

    def frames_of(self, owner: str) -> int:
        """Resident-frame count currently held by one region owner."""
        return self._owner_frames.get(owner, 0)

    def set_quota(self, owner: str, frames: Optional[int]) -> None:
        """Cap one owner's resident frames (``None`` lifts the cap).

        The cap is enforced at install time: a new frame for an
        at-quota owner first clock-evicts one of *that owner's* frames
        (clean-first, pin/ref rules as usual) instead of stealing from
        the shared pool — the cache-isolation half of per-tenant
        quotas. Best-effort: if every one of the owner's frames is
        pinned, the install overflows the cap rather than failing
        (pins are transient — epoch drains — so the overshoot is too).
        Quotas are volatile policy, like frames themselves: they never
        change what a crash recovers."""
        if frames is None:
            self._quota.pop(owner, None)
            return
        if frames < 0:
            raise ValueError("quota must be >= 0 frames")
        self._quota[owner] = int(frames)

    def quota(self, owner: str) -> Optional[int]:
        """The owner's frame cap, or ``None`` if uncapped."""
        return self._quota.get(owner)

    def set_scan_frac(self, owner: str, frac: Optional[float]) -> None:
        """Override one owner's probationary fraction (``None`` reverts
        to the cache-wide ``scan_frac``). Only meaningful together with
        a quota (the 2Q split sizes against the owner's budget); the
        serve layer exposes it per tenant
        (:meth:`ServeFrontend.set_cache_scan_frac
        <repro.serve.frontend.ServeFrontend.set_cache_scan_frac>`)."""
        if frac is None:
            self._scan_frac.pop(owner, None)
            return
        if not 0.0 < float(frac) <= 1.0:
            raise ValueError("scan_frac must be in (0, 1]")
        self._scan_frac[owner] = float(frac)

    def scan_frac_of(self, owner: str) -> float:
        """The probationary fraction in force for one owner."""
        return self._scan_frac.get(owner, self.scan_frac)

    # -------------------------------------------------------- admission

    def _admit(self, owner: str, pid: int) -> bool:
        """The spill scheduler's ``admission`` hook: promote only once a
        page has been touched ``admit_k`` times."""
        return self._touches.get((owner, int(pid)), 0) >= self.admit_k

    def _is_pinned(self, owner: str, pid: int) -> bool:
        f = self._frames.get((owner, int(pid)))
        return f is not None and f.pins > 0

    def _on_slot_evicted(self, owner: str, pid: int) -> None:
        """A page's PMem slot left for SSD: restart its admission count
        (re-promotion must be re-earned) — the DRAM frame, if any, stays
        valid (frames cache *content*, tiers own durability)."""
        self._touches.pop((owner, int(pid)), None)

    def touches(self, pid: int, store=None) -> int:
        """Current admission-touch count for a page."""
        owner, _ = self._resolve(store)
        return self._touches.get((owner, int(pid)), 0)

    def _note_touch(self, key: Tuple[str, int], spill, store) -> None:
        self._touches[key] = self._touches.get(key, 0) + 1
        if spill is not None:
            spill.touch(key[1], store)

    # ------------------------------------------------------- frame pool

    def _install(self, key: Tuple[str, int], data: np.ndarray,
                 socket: Optional[int] = None) -> _Frame:
        """Install a page image as a frame (probationary — it graduates
        to protected on re-reference). An at-quota owner first evicts
        one of its *own* frames (see :meth:`set_quota`); the shared
        pool clock-evicts only when globally full. ``socket`` is the
        fill-source socket tag (``None`` = DRAM-born content, tagged
        local)."""
        assert self.capacity > 0
        owner = key[0]
        q = self._quota.get(owner)
        if q is not None and self._owner_frames.get(owner, 0) >= q:
            # best-effort: every frame of this owner may be pinned — the
            # install then overflows the cap (pins are transient), but
            # audibly: quota_overflows is the serve layer's isolation
            # escape-hatch counter
            if not self._evict_frame(owner_only=owner):
                self._acct(owner, "quota_overflows")
        if len(self._frames) >= self.capacity:
            self._evict_frame()
        f = _Frame(owner, key[1], data,
                   socket=self.local_socket if socket is None else socket)
        self._frames[key] = f
        self._ring.append(key)
        self._owner_frames[owner] = self._owner_frames.get(owner, 0) + 1
        return f

    def _probation_due(self, owner: str) -> bool:
        """Whether the owner's probationary segment has reached its
        ``scan_frac`` share of the quota — the quota sweep then recycles
        probationary frames only (2Q: a scan cycles inside its own
        fraction instead of churning the protected hot set)."""
        q = self._quota.get(owner)
        if q is None or q <= 0:
            return False
        cap = max(1, int(self.scan_frac_of(owner) * q))
        if cap >= q:
            return False          # scan_frac=1.0: the split is off
        nprob = sum(1 for k, f in self._frames.items()
                    if k[0] == owner and not f.protected)
        return nprob >= cap

    def _evict_frame(self, owner_only: Optional[str] = None) -> bool:
        """Evict one frame. ``owner_only`` restricts the sweep to one
        owner's frames (quota enforcement; other owners' ref bits are
        left untouched) and returns ``False`` instead of raising when
        every candidate is pinned. A quota'd owner whose probationary
        segment is full recycles probationary frames first (2Q)."""
        if owner_only is not None and self._probation_due(owner_only):
            if self._sweep(owner_only, probation_only=True):
                return True
        if self._sweep(owner_only):
            return True
        if owner_only is not None:
            return False
        raise RuntimeError(
            f"buffer manager: all {self.capacity} frames are pinned")

    def _sweep(self, owner_only: Optional[str] = None, *,
               probation_only: bool = False) -> bool:
        """Clock sweep in far-first, clean-first preference order:
        far-clean → near-clean → far-dirty → near-dirty (far = the
        frame's fill socket differs from ``local_socket``). Pinned and
        referenced frames are skipped (ref bits cleared on the pass that
        considers them); a dirty victim parks its image in the flush
        queue. With no far-filled frames — every single-socket pool —
        the far passes are no-ops and the sweep is bit-identical to the
        socket-blind clean-first clock (as it is with
        ``numa_evict=False``)."""
        local = self.local_socket
        has_far = self.numa_evict and any(
            f.socket != local for f in self._frames.values())
        for require_clean, require_far in ((True, True), (True, False),
                                           (False, True), (False, False)):
            if require_far and not has_far:
                continue
            swept = 0
            limit = 2 * len(self._ring)   # ref bits all clear after one lap
            while self._ring and swept < limit:
                if self._hand >= len(self._ring):
                    self._hand = 0
                key = self._ring[self._hand]
                f = self._frames[key]
                # candidacy filters leave ref bits alone — a pass that
                # cannot take a frame must not spend its second chance
                if ((owner_only is not None and key[0] != owner_only)
                        or (probation_only and f.protected)
                        or (require_far and f.socket == local)):
                    self._hand += 1
                    swept += 1
                    continue
                if f.pins > 0:
                    self._hand += 1
                    swept += 1
                    continue
                if f.ref:
                    f.ref = False
                    self._hand += 1
                    swept += 1
                    continue
                if require_clean and f.is_dirty:
                    self._hand += 1
                    swept += 1
                    continue
                self._drop_frame(key, park_dirty=True)
                return True
        return False

    def _drop_frame(self, key: Tuple[str, int], *, park_dirty: bool) -> None:
        f = self._frames.pop(key)
        idx = self._ring.index(key)
        del self._ring[idx]
        if idx < self._hand:
            self._hand -= 1
        self._owner_frames[key[0]] -= 1
        if f.is_dirty:
            self._dirty_order.pop(key, None)
            if park_dirty:
                # park in the flush queue's (DRAM) pending set: the next
                # epoch drain flushes it — no new durability point here
                lines = None if f.dirty is None else sorted(f.dirty)
                self._fq[key[0]].enqueue(key[1], f.data, lines,
                                         copy=False, touch=False)
                self._acct(key[0], "evictions_dirty")
        else:
            self._acct(key[0], "evictions_clean")

    def _mark_dirty(self, key: Tuple[str, int], f: _Frame,
                    dirty_lines: Optional[Sequence[int]]) -> None:
        was_clean = not f.is_dirty
        if dirty_lines is None or f.dirty is None:
            f.dirty = None
        else:
            f.dirty.update(int(i) for i in dirty_lines)
        if was_clean and f.is_dirty:
            self._dirty_order[key] = None

    # ---------------------------------------------------------- tiers

    def _residency(self, owner: str, store, pid: int) -> Optional[str]:
        """Which tier holds the page's current version: ``"pmem"``,
        ``"ssd"``, or ``None`` (never flushed)."""
        sp = self._spill[owner]
        if sp is not None:
            return sp.residency(store, pid)
        return "pmem" if pid in store.table else None

    def _fill(self, owner: str, store, pid: int, *,
              for_write: bool) -> Tuple[np.ndarray, int]:
        """Read the page from its resident tier (the frame-fill path).
        Returns ``(data, socket)`` — the source tier's home socket tags
        the frame and, when it differs from ``local_socket``, the fill
        counts as remote (the Izraelevitz read surcharge).

        Never promotes: read faults had their admission decision taken by
        :meth:`_promote_if_due` before the fill (so an SSD fill here is by
        definition below the threshold), and write faults never promote —
        the fill is about to be superseded by a flush-queue CoW."""
        sp = self._spill[owner]
        tier = self._residency(owner, store, pid)
        if tier == "pmem":
            data, _pvn = store.fill_page(pid)
            slot, _ = store.table[pid]
            sock = store.pmem.home_socket(store.layout.slot_off(slot))
            self._acct(owner, "pmem_fills")
            self._acct(owner, "pmem_fill_bytes", data.size)
            if sock != self.local_socket:
                self._acct(owner, "remote_fills")
                self._acct(owner, "remote_fill_bytes", data.size)
            return data, sock
        if tier == "ssd":
            data = np.asarray(sp.read_page(store, pid, promote=False))
            sock = sp.fill_socket(store, pid)
            self._acct(owner, "ssd_fills")
            self._acct(owner, "ssd_fill_bytes", data.size)
            if not for_write:
                self._acct(owner, "admissions_deferred")
            if sock != self.local_socket:
                self._acct(owner, "remote_fills")
                self._acct(owner, "remote_fill_bytes", data.size)
            return data, sock
        if pid < 0 or pid >= store.layout.npages:
            raise KeyError(pid)
        self._acct(owner, "fresh_pages")
        return (np.zeros(store.layout.page_size, dtype=np.uint8),
                self.local_socket)

    def _promote_if_due(self, owner: str, store, pid: int) -> None:
        """k-touch admission is a property of the *access stream*, not of
        frame residency: a DRAM hit on an SSD-resident page that crosses
        the threshold still promotes (identical PMem/SSD op sequence to
        a frameless run — the crash-parity invariant)."""
        sp = self._spill[owner]
        if sp is None or not self._admit(owner, pid):
            return
        if self._residency(owner, store, pid) == "ssd":
            sp.read_page(store, pid, promote=True)
            self._acct(owner, "promotions")

    # ------------------------------------------------------------ reads

    def get(self, pid: int, store=None, *, pin: bool = False) -> np.ndarray:
        """Read a page wherever it lives; returns a copy of its newest
        content (frame → flush-queue pending → resident tier, in that
        order). Counts the touch for LRU + admission; ``pin=True``
        additionally pins the frame (no-op at ``frames=0``)."""
        owner, store = self._resolve(store)
        pid = int(pid)
        key = (owner, pid)
        self._note_touch(key, self._spill[owner], store)
        self._promote_if_due(owner, store, pid)
        f = self._frames.get(key)
        if f is not None:
            f.ref = True
            f.protected = True   # 2Q: re-reference graduates the frame
            self._acct(owner, "dram_hits")
            self._acct(owner, "dram_hit_bytes", f.data.size)
            if pin:
                f.pins += 1
            return np.array(f.data, copy=True)
        pend = self._fq[owner].pending_image(pid)
        if pend is not None:
            if pin and self.capacity > 0:
                # the pin contract needs a frame (clock immunity + the
                # spill guard): re-adopt the parked image, dirty set intact
                f = self._adopt_or_install(owner, (owner, pid))
                f.ref = True
                f.pins += 1
                self._acct(owner, "dram_hits")
                self._acct(owner, "dram_hit_bytes", f.data.size)
                return np.array(f.data, copy=True)
            # parked by a dirty eviction (or frames=0 write): the queue's
            # pending set is DRAM — serve it as a hit, leave it queued
            self._acct(owner, "dram_hits")
            self._acct(owner, "dram_hit_bytes", pend[0].size)
            return np.array(pend[0], copy=True)
        data, sock = self._fill(owner, store, pid, for_write=False)
        if self.capacity == 0:
            return np.array(data, copy=True)
        f = self._install(key, np.array(data, copy=True), socket=sock)
        if pin:
            f.pins += 1
        return np.array(f.data, copy=True)

    def peek(self, pid: int, store=None) -> Optional[np.ndarray]:
        """The page's frame content, or ``None`` if not framed. No touch,
        no fill, no stats — the checkpoint manager's snapshot read."""
        owner, _ = self._resolve(store)
        f = self._frames.get((owner, int(pid)))
        return None if f is None else f.data

    # ----------------------------------------------------------- writes

    def put(self, pid: int, page: np.ndarray,
            dirty_lines: Optional[Sequence[int]] = None,
            store=None) -> None:
        """Write a full page image (``dirty_lines`` annotates which lines
        changed; ``None`` = all). Dirty data stays in DRAM — a frame, or
        the flush queue's pending set at ``frames=0`` — until the next
        write-back epoch, exactly like direct ``FlushQueue.enqueue``."""
        owner, store = self._resolve(store)
        pid = int(pid)
        key = (owner, pid)
        page = np.asarray(page, dtype=np.uint8).ravel()
        if page.size != store.layout.page_size:
            raise ValueError("page size mismatch")
        self._note_touch(key, self._spill[owner], store)
        if self.capacity == 0:
            self._fq[owner].enqueue(pid, page, dirty_lines, touch=False)
            return
        f = self._frames.get(key)
        if f is None:
            # a full image supersedes any parked pending copy ("latest
            # image wins", like the queue's own coalescing) — only the
            # parked dirty set carries over; no tier fill needed
            parked = self._fq[owner].pop_pending(pid)
            f = self._install(key, np.array(page, copy=True))
            if parked is not None:
                self._mark_dirty(key, f, None if parked[1] is None
                                 else sorted(parked[1]))
        else:
            f.data[:] = page
            f.protected = True   # 2Q: re-reference graduates the frame
        f.ref = True
        self._mark_dirty(key, f, dirty_lines)

    def write(self, pid: int, off: int, data: bytes, store=None) -> None:
        """Read-modify-write ``len(data)`` bytes at a page offset (the
        KV engine's put path). Faults the rest of the page in from its
        resident tier if needed (write faults never promote); the
        covered cache lines are marked dirty."""
        owner, store = self._resolve(store)
        pid = int(pid)
        key = (owner, pid)
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
        cl = store.layout.geometry.cache_line
        if off < 0 or off + buf.size > store.layout.page_size:
            raise ValueError("write outside page")
        lines = range(off // cl, (off + buf.size - 1) // cl + 1) \
            if buf.size else range(0)
        self._note_touch(key, self._spill[owner], store)
        if self.capacity == 0:
            fq = self._fq[owner]
            pend = fq.pending_image(pid)
            if pend is not None:
                img = pend[0]
                img[off : off + buf.size] = buf
                fq.enqueue(pid, img, list(lines), copy=False, touch=False)
                return
            img = np.array(
                self._fill(owner, store, pid, for_write=True)[0], copy=True)
            img[off : off + buf.size] = buf
            fq.enqueue(pid, img, list(lines), copy=False, touch=False)
            return
        f = self._frames.get(key)
        if f is None:
            f = self._adopt_or_install(owner, key)
        else:
            f.protected = True   # 2Q: re-reference graduates the frame
        f.data[off : off + buf.size] = buf
        f.ref = True
        self._mark_dirty(key, f, list(lines))

    def _adopt_or_install(self, owner: str, key: Tuple[str, int]) -> _Frame:
        """Frame a page whose current content must be preserved (partial
        writes, pins): re-adopt a parked pending image from the flush
        queue (its dirty set carries over), else fill from the resident
        tier (a write-style fault: never promotes)."""
        fq = self._fq[owner]
        store = self._stores[owner]
        parked = fq.pop_pending(key[1])
        if parked is not None:
            img, dirty = parked
            f = self._install(key, np.array(img, copy=True))
            self._mark_dirty(key, f,
                             None if dirty is None else sorted(dirty))
            return f
        data, sock = self._fill(owner, store, key[1], for_write=True)
        return self._install(key, np.array(data, copy=True), socket=sock)

    # ------------------------------------------------------ pin / unpin

    def pin(self, pid: int, store=None) -> None:
        """Pin a page's frame: immune to clock eviction, and its PMem
        slot is protected from spill eviction for the duration (the
        mid-flush guard). Faults the page in if unframed. No-op at
        ``frames=0``."""
        if self.capacity == 0:
            return
        owner, store = self._resolve(store)
        key = (owner, int(pid))
        f = self._frames.get(key)
        if f is None:
            self.get(pid, store, pin=True)
            return
        f.pins += 1

    def unpin(self, pid: int, store=None) -> None:
        """Release one pin."""
        if self.capacity == 0:
            return
        owner, _ = self._resolve(store)
        f = self._frames.get((owner, int(pid)))
        if f is None or f.pins <= 0:
            raise ValueError(f"page {pid} is not pinned")
        f.pins -= 1

    # -------------------------------------------------------- write-back

    def dirty_pages(self, store=None) -> List[int]:
        """Pids with un-flushed frame content, in first-dirtied order."""
        owner, _ = self._resolve(store)
        pids = [k[1] for k in self._dirty_order if k[0] == owner]
        fq = self._fq[owner]
        pids += [p for p in fq.pending_pids() if p not in set(pids)]
        return pids

    def writeback(self, store=None):
        """Drain every dirty frame through the region's flush queue in
        one lane-partitioned epoch (frames are pinned for the duration,
        so the epoch's own spill evictions cannot touch them). Frames
        stay resident and become clean — the next save's snapshots.
        Returns the :class:`~repro_torch.io.flushq.EpochReport`."""
        owner, _ = self._resolve(store)
        fq = self._fq[owner]
        keys = [k for k in self._dirty_order if k[0] == owner]
        pinned = []
        for key in keys:
            f = self._frames[key]
            f.pins += 1
            pinned.append(f)
            lines = None if f.dirty is None else sorted(f.dirty)
            # copy=False: the frame is pinned and nothing mutates it
            # between enqueue and the drain below — aliasing avoids a
            # second full copy of the epoch's page set (the spike the
            # queue's copy= knob exists to prevent)
            fq.enqueue(key[1], f.data, lines, copy=False, touch=False)
            self._acct(key[0], "writebacks")
        try:
            report = fq.flush_epoch()
        finally:
            for f in pinned:
                f.pins -= 1
        for key in keys:
            f = self._frames.get(key)
            if f is not None:
                f.dirty = set()
            self._dirty_order.pop(key, None)
        return report

    def invalidate(self, store=None) -> None:
        """Drop every DRAM image of a region — frames (and their dirty
        marking) *and* parked pending images in the flush queue — for
        restore paths that rewrite the page table out from under the
        cache. A surviving parked image would be flushed by the next
        epoch drain, resurrecting pre-restore bytes over the restored
        pages. Refuses to run while any of the region's frames is
        pinned (like :meth:`drop`): discarding a pinned frame would
        break the pin contract mid-epoch. Admission touch counts
        survive: they describe the access stream, not frame residency."""
        owner, _ = self._resolve(store)
        keys = [k for k in self._frames if k[0] == owner]
        pinned = [k[1] for k in keys if self._frames[k].pins > 0]
        if pinned:
            raise ValueError(
                f"cannot invalidate {owner!r}: pages {pinned} are pinned")
        for key in keys:
            self._frames.pop(key)
            idx = self._ring.index(key)
            del self._ring[idx]
            if idx < self._hand:
                self._hand -= 1
            self._dirty_order.pop(key, None)
            self._owner_frames[owner] -= 1
        fq = self._fq[owner]
        for pid in list(fq.pending_pids()):
            fq.pop_pending(pid)

    def drop(self, pid: int, store=None) -> None:
        """Discard one page's DRAM state without flushing it: its frame
        (clean *or* dirty) and any image parked in the flush queue's
        pending set. This is the cross-shard invalidation primitive
        (repro.cluster): by the time a range's source engine drops a
        page, the new owner already holds its content durably, so the
        dirty bytes die here on purpose. Unlike :meth:`invalidate` the
        admission touch count resets too — the page's access history
        moved with it. No-op if the page is unframed and unparked;
        refuses pinned frames."""
        owner, _ = self._resolve(store)
        key = (owner, int(pid))
        f = self._frames.get(key)
        if f is not None:
            if f.pins > 0:
                raise ValueError(f"page {pid} is pinned")
            self._frames.pop(key)
            idx = self._ring.index(key)
            del self._ring[idx]
            if idx < self._hand:
                self._hand -= 1
            self._dirty_order.pop(key, None)
            self._owner_frames[owner] -= 1
        self._fq[owner].pop_pending(int(pid))
        self._touches.pop(key, None)

    def install(self, pid: int, page: np.ndarray, store=None) -> None:
        """Install a *clean* frame holding ``page`` (restore/adopt paths
        seeding snapshots). No touch, no dirty marking. Supersedes any
        image parked in the flush queue's pending set, like :meth:`put`
        — a restore's content must win over a pre-restore parked copy,
        at ``frames=0`` too."""
        owner, store = self._resolve(store)
        page = np.asarray(page, dtype=np.uint8).ravel()
        if page.size != store.layout.page_size:
            raise ValueError("page size mismatch")
        key = (owner, int(pid))
        self._fq[owner].pop_pending(int(pid))
        if self.capacity == 0:
            return
        f = self._frames.get(key)
        if f is None:
            f = self._install(key, np.array(page, copy=True))
        else:
            f.data[:] = page
            f.dirty = set()
            self._dirty_order.pop(key, None)

    # ---------------------------------------------------------- metrics

    @property
    def frames_in_use(self) -> int:
        """Resident frames across all registered regions."""
        return len(self._frames)

    def modeled_read_ns(self, delta: Optional[CacheStats] = None) -> float:
        """Modeled read-path time of a :class:`CacheStats` delta (the
        whole window since construction when omitted) on the Fig. 3
        ladder — DRAM hits at DRAM latency/bandwidth, PMem fills at the
        3.2× rung, SSD fills per the flash model. Promotion *write*
        traffic is charged where it executes (PMem lane stats / SSD
        stats), not here."""
        return self.cost_model.readpath_time_ns(
            delta if delta is not None else self.stats, ssd=self.ssd_cost)
