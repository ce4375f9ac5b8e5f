"""Failure-atomic page flushing (paper §3.2): CoW(+pvn), µLog, Hybrid.

A *page store* is an array of slots on PMem, each slot = one cache line of
header (pid, pvn) + page_size bytes of data. ``nslots > npages`` so CoW
always finds a free slot. Logical pages are located by scanning slot
headers: for each pid the slot with the highest page-version-number (pvn)
holds the current contents — which is exactly why CoW needs no
"invalidate old slot" barrier (3 → 2 barriers, the paper's ≈10 % win).

  CoW (pvn)        — write new slot data (barrier 1), then persist the
                     header (pid, pvn+1) (barrier 2). Header fits one cache
                     line ⇒ it becomes durable atomically: recovery sees
                     either the old version (max pvn = old) or the complete
                     new one.
  CoW (invalidate) — the 3-barrier baseline: invalidate old header, write
                     data, validate. Kept for the ≈10 % comparison.
  µLog             — for small deltas: (1) invalidate µlog, (2) write the
                     dirty lines + target pvn into the µlog, (3) validate
                     µlog, (4) apply dirty lines in place to the page slot
                     — 4 barriers but only ~dirty bytes of traffic.
                     Recovery replays any valid µlog whose pvn is >= the
                     slot's pvn (idempotent; a torn in-place apply is
                     always repaired by the replay).
  Hybrid           — closed-form cost model picks µLog below the dirty-line
                     crossover, CoW above. The crossover *moves with thread
                     count* because multi-threaded small writes defeat the
                     device's write-combining buffer (Fig. 2), amplifying
                     every dirty line to a full 256 B block write:
                     ≈119 dirty lines at 1 thread → ≈31 at 7 threads for
                     16 KB pages, matching Fig. 5 (a)/(c).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blocks import BlockGeometry, PAPER_GEOMETRY, align_up
from repro_torch.core.costmodel import COST_MODEL, PMemCostModel
from repro_torch.core.persist import INVALID_PID, FlushKind
from repro_torch.core.pmem import PMem

__all__ = [
    "PageStoreLayout",
    "PageStore",
    "MicroLog",
    "HybridPolicy",
    "recover_page_table",
]

_SLOT_HDR = struct.Struct("<IQ")        # pid, pvn  (12 B, single cache line)
_ULOG_HDR = struct.Struct("<IQII")      # pid, pvn, target slot, nlines
#: target slot meaning "the page's current slot" (paper-faithful in-place µLog)
SLOT_CURRENT = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PageStoreLayout:
    """Byte layout of a slot array within a PMem region."""

    base: int
    page_size: int
    npages: int
    nslots: int
    geometry: BlockGeometry = PAPER_GEOMETRY
    #: ``nslots <= npages`` is normally an error (CoW must always find a
    #: free slot). A store *overcommits* when a spill tier stands behind
    #: it: the PMem slot array is a cache of a larger logical page space
    #: and the :class:`repro_torch.tier.SpillScheduler` evicts cold slots to SSD
    #: before CoW would run dry.
    overcommit: bool = False

    def __post_init__(self) -> None:
        if self.nslots <= self.npages and not self.overcommit:
            raise ValueError("CoW needs nslots > npages (or overcommit=True "
                             "with a spill tier attached)")
        if self.page_size % self.geometry.cache_line != 0:
            raise ValueError("page_size must be cache-line aligned")

    @property
    def lines_per_page(self) -> int:
        return self.page_size // self.geometry.cache_line

    @property
    def slot_stride(self) -> int:
        return align_up(self.geometry.cache_line + self.page_size, self.geometry.block)

    @property
    def total_bytes(self) -> int:
        return self.nslots * self.slot_stride

    def slot_off(self, slot: int) -> int:
        return self.base + slot * self.slot_stride

    def slot_data_off(self, slot: int) -> int:
        return self.slot_off(slot) + self.geometry.cache_line


def recover_page_table(pmem: PMem, layout: PageStoreLayout) -> Dict[int, Tuple[int, int]]:
    """Scan all slot headers in the durable image; return pid -> (slot, pvn)
    picking the highest pvn per pid (paper §3.2.1 recovery)."""
    img = pmem.durable_view()
    table: Dict[int, Tuple[int, int]] = {}
    for s in range(layout.nslots):
        pid, pvn = _SLOT_HDR.unpack_from(img, layout.slot_off(s))
        if pid == INVALID_PID or pvn == 0 or pid >= layout.npages:
            continue
        if pid not in table or pvn > table[pid][1]:
            table[pid] = (s, pvn)
    return table


class MicroLog:
    """One µLog area: header line + line-index array + line-data array."""

    def __init__(self, pmem: PMem, base: int, layout: PageStoreLayout) -> None:
        self.pmem = pmem
        self.base = base
        self.layout = layout
        g = layout.geometry
        self.idx_off = base + g.cache_line
        idx_bytes = align_up(4 * layout.lines_per_page, g.cache_line)
        self.data_off = self.idx_off + idx_bytes
        self.total_bytes = (self.data_off - base) + layout.lines_per_page * g.cache_line

    # Steps follow Listing 1 (right column) with the pvn + target-slot
    # extensions (the checkpoint layer applies deltas onto a *shadow* slot
    # so the previously committed snapshot stays intact).
    def invalidate(self) -> None:
        self.pmem.store(self.base, _ULOG_HDR.pack(INVALID_PID, 0, 0, 0), streaming=True)
        self.pmem.persist(self.base, _ULOG_HDR.size, kind=FlushKind.NT)   # barrier 1

    def write(self, pvn: int, lines: Sequence[int], line_data: np.ndarray,
              target_slot: int = SLOT_CURRENT) -> None:
        g = self.layout.geometry
        idx = np.asarray(lines, dtype=np.uint32)
        self.pmem.store(self.idx_off, idx.tobytes(), streaming=True)
        self.pmem.store(self.data_off, line_data.tobytes(), streaming=True)
        # header body (pvn, slot, nlines) shares the header line; pid stays
        # INVALID until validate()
        self.pmem.store(
            self.base,
            _ULOG_HDR.pack(INVALID_PID, pvn, target_slot, len(lines)),
            streaming=True,
        )
        self.pmem.sfence()                                                # barrier 2

    def validate(self, pid: int) -> None:
        hdr = self.pmem.load(self.base, _ULOG_HDR.size)
        _, pvn, slot, nlines = _ULOG_HDR.unpack(hdr.tobytes())
        self.pmem.store(self.base, _ULOG_HDR.pack(pid, pvn, slot, nlines), streaming=True)
        self.pmem.persist(self.base, _ULOG_HDR.size, kind=FlushKind.NT)   # barrier 3

    def read_durable(self) -> Optional[Tuple[int, int, int, np.ndarray, np.ndarray]]:
        """(pid, pvn, slot, line_idx[n], line_data[n, cl]) if durably valid."""
        img = self.pmem.durable_view()
        pid, pvn, slot, nlines = _ULOG_HDR.unpack_from(img, self.base)
        if pid == INVALID_PID or pid >= self.layout.npages or nlines == 0:
            return None
        if nlines > self.layout.lines_per_page:
            return None
        if slot != SLOT_CURRENT and slot >= self.layout.nslots:
            return None
        g = self.layout.geometry
        idx = np.frombuffer(
            img[self.idx_off : self.idx_off + 4 * nlines].tobytes(), dtype=np.uint32
        )
        data = np.frombuffer(
            img[self.data_off : self.data_off + nlines * g.cache_line].tobytes(),
            dtype=np.uint8,
        ).reshape(nlines, g.cache_line)
        if (idx >= self.layout.lines_per_page).any():
            return None
        return int(pid), int(pvn), int(slot), idx, data


class PageStore:
    """Failure-atomic page store over a PMem region (CoW / µLog / hybrid)."""

    def __init__(
        self,
        pmem: PMem,
        layout: PageStoreLayout,
        *,
        n_mulogs: int = 1,
        cost_model: PMemCostModel = COST_MODEL,
        threads: int = 1,
    ) -> None:
        self.pmem = pmem
        self.layout = layout
        self.cost_model = cost_model
        self.threads = threads
        g = layout.geometry
        mulog_base = align_up(layout.base + layout.total_bytes, g.block)
        self.mulogs = []
        off = mulog_base
        self.total_end = off
        for _ in range(n_mulogs):
            ml = MicroLog(pmem, off, layout)
            off = align_up(off + ml.total_bytes, g.block)
            self.total_end = off
            self.mulogs.append(ml)
        self._next_mulog = 0
        # Volatile state rebuilt on open: pid -> (slot, pvn); free slots.
        self.table: Dict[int, Tuple[int, int]] = {}
        self.free: List[int] = list(range(layout.nslots))
        # pid -> minimum pvn history (maintained by the spill tier): a
        # page whose version history continued on SSD must re-enter PMem
        # strictly above it, or recovery's max-pvn rule could resurrect a
        # stale durable header or a stale SSD copy.
        self.pvn_floor: Dict[int, int] = {}
        self.policy = HybridPolicy(layout, cost_model)

    # ------------------------------------------------------------ sizing

    @staticmethod
    def region_bytes(layout: PageStoreLayout, *, n_mulogs: int = 1) -> int:
        """Bytes from ``layout.base`` to ``total_end`` for a store with
        ``n_mulogs`` micro logs — the exact span ``__init__`` lays out,
        assuming ``layout.base`` is block-aligned."""
        g = layout.geometry
        mulog_hdr_idx = g.cache_line + align_up(4 * layout.lines_per_page,
                                                g.cache_line)
        mulog_total = mulog_hdr_idx + layout.lines_per_page * g.cache_line
        off = align_up(layout.base + layout.total_bytes, g.block)
        for _ in range(n_mulogs):
            off = align_up(off + mulog_total, g.block)
        return off - layout.base

    # ------------------------------------------------------------- open

    @classmethod
    def open(cls, pmem: PMem, layout: PageStoreLayout, **kw) -> "PageStore":
        """Recover: rebuild the page table from slot headers, then replay
        any valid µlog with pvn >= the slot's (torn-apply repair)."""
        store = cls(pmem, layout, **kw)
        store.table = recover_page_table(pmem, layout)
        for ml in store.mulogs:
            rec = ml.read_durable()
            if rec is None:
                continue
            pid, pvn, target, idx, data = rec
            if pid not in store.table:
                continue
            slot, slot_pvn = store.table[pid]
            if target != SLOT_CURRENT:
                # checkpoint-layer shadow-slot delta: apply onto the
                # recorded slot — but ONLY while that slot still belongs
                # to this page at a not-newer version. The slot may have
                # been freed (spill-tier eviction) and reused by another
                # page, or re-CoW'd by this page at a higher pvn; an
                # unconditional apply would corrupt the new occupant. A
                # torn apply (header at pvn, some data lines lost) still
                # replays: hdr_pid matches and hdr_pvn <= pvn.
                slot = target
                hdr_pid, hdr_pvn = _SLOT_HDR.unpack_from(
                    pmem.durable_view(), layout.slot_off(target))
                if hdr_pid != pid or hdr_pvn > pvn:
                    continue  # slot reused / superseded: µlog is stale
            elif pvn < slot_pvn:
                continue  # stale in-place µlog, superseded by a newer CoW
            g = layout.geometry
            doff = layout.slot_data_off(slot)
            for li, line in zip(idx.tolist(), data):
                pmem.store(doff + li * g.cache_line, line.tobytes(), streaming=True)
            pmem.store(layout.slot_off(slot), _SLOT_HDR.pack(pid, pvn), streaming=True)
            pmem.sfence()
            if pvn >= store.table.get(pid, (0, 0))[1]:
                store.table[pid] = (slot, pvn)
        used = {s for s, _ in store.table.values()}
        store.free = [s for s in range(layout.nslots) if s not in used]
        return store

    # ------------------------------------------------------------ flush

    def _alloc_slot(self) -> int:
        if not self.free:
            raise RuntimeError("no free slots")
        return self.free.pop()

    def flush_cow(
        self,
        pid: int,
        page: np.ndarray,
        *,
        dirty_lines: Optional[Sequence[int]] = None,
        invalidate_first: bool = False,
        retire_old: bool = True,
        pvn_floor: int = 0,
    ) -> None:
        """Copy-on-write flush. ``dirty_lines`` given ⇒ the ☆ variant of
        Fig. 5: only dirty lines are in DRAM, clean lines are read back
        from the old PMem slot (device reads). ``invalidate_first`` selects
        the legacy 3-barrier protocol (≈10 % slower, §3.2.1).
        ``retire_old=False`` leaves the superseded slot OUT of the free
        list — the caller owns it (checkpoint shadow slots). ``pvn_floor``
        forces the new version number past a given value — the spill
        tier's promotion path re-installs a page whose pvn history
        continued on SSD, and must stay above any stale durable slot."""
        layout, g = self.layout, self.layout.geometry
        page = np.asarray(page, dtype=np.uint8).ravel()
        if page.size != layout.page_size:
            raise ValueError("page size mismatch")
        old = self.table.get(pid)
        new_pvn = max((old[1] if old else 0) + 1, int(pvn_floor),
                      self.pvn_floor.get(pid, 0) + 1)
        slot = self._alloc_slot()

        if invalidate_first and old is not None:
            # legacy: explicitly invalidate the old slot header  (barrier 0)
            self.pmem.store(
                layout.slot_off(old[0]), _SLOT_HDR.pack(INVALID_PID, 0), streaming=True
            )
            self.pmem.persist(layout.slot_off(old[0]), _SLOT_HDR.size, kind=FlushKind.NT)

        data = page
        if dirty_lines is not None and old is not None:
            # merge: clean lines come from the old PMem slot (uncached read)
            merged = self.pmem.load(
                layout.slot_data_off(old[0]), layout.page_size, uncached=True
            )
            dirty = np.zeros(layout.lines_per_page, dtype=bool)
            dirty[np.asarray(list(dirty_lines), dtype=np.int64)] = True
            m2 = merged.reshape(layout.lines_per_page, g.cache_line).copy()
            p2 = page.reshape(layout.lines_per_page, g.cache_line)
            m2[dirty] = p2[dirty]
            data = m2.ravel()

        # 1. write data, persist                                  (barrier 1)
        self.pmem.store(layout.slot_data_off(slot), data.tobytes(), streaming=True)
        self.pmem.persist(layout.slot_data_off(slot), layout.page_size, kind=FlushKind.NT)
        # 2. make the slot valid: header fits one line ⇒ atomic   (barrier 2)
        self.pmem.store(layout.slot_off(slot), _SLOT_HDR.pack(pid, new_pvn), streaming=True)
        self.pmem.persist(layout.slot_off(slot), _SLOT_HDR.size, kind=FlushKind.NT)

        if old is not None and retire_old:
            self.free.append(old[0])  # implicitly invalid: lower pvn
        self.table[pid] = (slot, new_pvn)

    def flush_mulog(self, pid: int, page: np.ndarray, dirty_lines: Sequence[int],
                    *, target_slot: Optional[int] = None) -> None:
        """µLog flush: persist only the dirty lines through the micro log,
        then apply them (Listing 1 right; 4 barriers).

        Default (paper §3.2.2): apply *in place* to the page's current slot.
        ``target_slot`` (checkpoint layer): apply onto that slot instead —
        the shadow-slot delta that keeps the previous snapshot intact. The
        caller guarantees ``page`` restricted to ``dirty_lines`` turns the
        shadow slot's contents into the new version."""
        layout, g = self.layout, self.layout.geometry
        if pid not in self.table:
            # first flush of a page must materialize a slot → CoW
            self.flush_cow(pid, page)
            return
        slot, pvn = self.table[pid]
        new_pvn = pvn + 1
        apply_slot = slot if target_slot is None else target_slot
        page = np.asarray(page, dtype=np.uint8).reshape(
            layout.lines_per_page, g.cache_line
        )
        idx = sorted(int(i) for i in dirty_lines)
        data = page[np.asarray(idx, dtype=np.int64)]
        ml = self.mulogs[self._next_mulog]
        self._next_mulog = (self._next_mulog + 1) % len(self.mulogs)

        ml.invalidate()                       # barrier 1
        ml.write(new_pvn, idx, data,          # barrier 2
                 target_slot=SLOT_CURRENT if target_slot is None else target_slot)
        ml.validate(pid)                      # barrier 3
        # 4. apply + bump the target slot's pvn, one barrier      (barrier 4)
        doff = layout.slot_data_off(apply_slot)
        for li, line in zip(idx, data):
            self.pmem.store(doff + li * g.cache_line, line.tobytes(), streaming=True)
        self.pmem.store(layout.slot_off(apply_slot), _SLOT_HDR.pack(pid, new_pvn),
                        streaming=True)
        self.pmem.sfence()
        self.table[pid] = (apply_slot, new_pvn)

    def flush(self, pid: int, page: np.ndarray,
              dirty_lines: Optional[Sequence[int]] = None, *,
              threads: Optional[int] = None) -> str:
        """Hybrid flush: pick µLog vs CoW by the cost model. Returns the
        technique used ("mulog" / "cow").

        ``threads`` overrides the constructor's writer-thread count for the
        crossover decision — the repro_torch.io flush queue passes the *actual*
        number of concurrently-active lanes in the current epoch, which is
        what moves the Fig. 5 crossover (≈119 dirty lines at 1 lane → ≈31
        at 7) instead of a static constructor constant."""
        t = self.threads if threads is None else int(threads)
        if dirty_lines is None or pid not in self.table:
            self.flush_cow(pid, page, dirty_lines=None)
            return "cow"
        if self.policy.prefer_mulog(len(dirty_lines), t):
            self.flush_mulog(pid, page, dirty_lines)
            return "mulog"
        self.flush_cow(pid, page)
        return "cow"

    # ------------------------------------------------------------- evict

    def release(self, pid: int) -> int:
        """Give ``pid``'s PMem slot back: durably invalidate the slot
        header (one barrier) and return the slot to the free list.

        This is the *last* step of the spill tier's eviction — the caller
        must already have made the page bytes durable on the lower tier
        (SSD extent + map record), so a crash before this call leaves two
        identical copies, which recovery resolves by preferring the PMem
        version at equal-or-higher pvn. Returns the released pvn."""
        layout = self.layout
        if pid not in self.table:
            raise KeyError(pid)
        slot, pvn = self.table.pop(pid)
        self.pmem.store(layout.slot_off(slot),
                        _SLOT_HDR.pack(INVALID_PID, 0), streaming=True)
        self.pmem.persist(layout.slot_off(slot), _SLOT_HDR.size,
                          kind=FlushKind.NT)
        self.free.append(slot)
        return pvn

    # ------------------------------------------------------------- read

    def read_page(self, pid: int) -> np.ndarray:
        slot, _ = self.table[pid]
        return self.pmem.load(self.layout.slot_data_off(slot), self.layout.page_size)

    def fill_page(self, pid: int) -> Tuple[np.ndarray, int]:
        """Frame fill for the DRAM buffer manager (``repro_torch.cache``): an
        *uncached* device read of the page's current slot — the whole
        page crosses the memory bus into a DRAM frame, so the full size
        is charged as ``device_read_bytes`` (the Fig. 3 PMem rung),
        unlike :meth:`read_page`'s CPU-cache-modeled load. Returns
        ``(data, pvn)``."""
        slot, pvn = self.table[pid]
        data = self.pmem.load(self.layout.slot_data_off(slot),
                              self.layout.page_size, uncached=True)
        return data, pvn

    def durable_page(self, pid: int) -> Optional[np.ndarray]:
        table = recover_page_table(self.pmem, self.layout)
        if pid not in table:
            return None
        slot, _ = table[pid]
        img = self.pmem.durable_view()
        off = self.layout.slot_data_off(slot)
        return img[off : off + self.layout.page_size]


class HybridPolicy:
    """Closed-form µLog-vs-CoW cost model (paper §3.2.3: "a hybrid technique
    based on a simple cost model should be used").

    µLog cost = 4 barriers + (µlog content + in-place apply) block writes.
    CoW  cost = 2 barriers + full-page block writes.
    Past ≈4 concurrent writer threads the WC buffer stops combining small
    writes (Fig. 2) ⇒ every dirty line costs a whole 256 B block in both the
    µlog content and the apply, which moves the crossover from ≈119 dirty
    lines (1 thread) to ≈31 (7 threads) for 16 KB pages — Fig. 5 (a)/(c).
    """

    def __init__(self, layout: PageStoreLayout, cm: PMemCostModel = COST_MODEL) -> None:
        self.layout = layout
        self.cm = cm

    def _per_block_ns(self, threads: int) -> float:
        # page flushes are large sequential bursts → burst thread curve
        ts = self.cm.thread_scale_burst(threads)
        return self.cm.block_write_ns_single / (ts / max(threads, 1))

    def _barrier_ns(self) -> float:
        from repro_torch.core.persist import AccessPattern
        return (
            self.cm.persist_latency_ns(FlushKind.NT, AccessPattern.SEQUENTIAL)
            + self.cm.barrier_ns
        )

    def cow_cost_ns(self, threads: int) -> float:
        g = self.layout.geometry
        blocks = math.ceil(self.layout.page_size / g.block)
        return 2 * self._barrier_ns() + blocks * self._per_block_ns(threads)

    def mulog_cost_ns(self, dirty: int, threads: int) -> float:
        g = self.layout.geometry
        lpb = g.lines_per_block
        combining = threads <= 4
        rec_bytes = 4 + g.cache_line  # index + line payload
        if combining:
            content_blocks = math.ceil(dirty * rec_bytes / g.block)
            apply_blocks = math.ceil(dirty / lpb)  # adjacent lines combine
        else:
            content_blocks = dirty  # WC combining defeated (Fig. 2)
            apply_blocks = dirty
        return 4 * self._barrier_ns() + (content_blocks + apply_blocks) * self._per_block_ns(threads)

    def crossover(self, threads: int) -> int:
        """Smallest dirty-line count at which CoW becomes cheaper."""
        for d in range(1, self.layout.lines_per_page + 1):
            if self.mulog_cost_ns(d, threads) >= self.cow_cost_ns(threads):
                return d
        return self.layout.lines_per_page + 1

    def prefer_mulog(self, dirty: int, threads: int) -> bool:
        return self.mulog_cost_ns(dirty, threads) < self.cow_cost_ns(threads)
