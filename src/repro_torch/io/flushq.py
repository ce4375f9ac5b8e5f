"""Batched page flushing — the engine's page-side front end.

Callers no longer flush pages synchronously against the
:class:`~repro_torch.core.pageflush.PageStore`; they :meth:`~FlushQueue.enqueue`
dirty pages and the queue drains them once per *epoch*. The epoch drain

* coalesces: multiple enqueues of the same page merge (latest page image
  wins, dirty-line sets union), so a page written ten times between
  epochs is flushed once;
* partitions the batch round-robin over up to ``lanes`` flush lanes and
  runs each page's flush under :meth:`repro_torch.core.pmem.PMem.lane`, so the
  cost model sees the lanes as concurrent writers;
* drives the Hybrid µLog-vs-CoW crossover with the *actual* number of
  concurrently-active lanes in this epoch (``min(lanes, len(batch))``),
  not a constructor constant — the Fig. 5 crossover moves from ≈119
  dirty lines at 1 lane to ≈31 at 7 because concurrent small writes
  defeat the device's write-combining buffer (Fig. 2).

A custom ``flush_fn(pid, page, dirty_lines, active_lanes)`` replaces the
default ``store.flush`` for callers with their own protocol on top (the
checkpoint manager's shadow-slot deltas).

With a :class:`repro_torch.tier.SpillScheduler` attached (``spill=``), the
epoch drain is also where the SSD tier gets fed: before flushing, cold
PMem slots are evicted to SSD until the batch fits (the *low watermark*
keeps slack beyond the bare minimum), and a mid-batch ``no free slots``
condition evicts and retries instead of failing the epoch — an epoch
that misses the PMem capacity budget overflows asynchronously (off the
caller's critical path) instead of raising.

The queue is also the write-back path of the DRAM buffer manager
(:class:`repro_torch.cache.BufferManager`): dirty frames are enqueued here —
:meth:`BufferManager.writeback <repro_torch.cache.BufferManager.writeback>`
drains them as one epoch, and a clock-evicted dirty frame *parks* its
image in the pending set until that drain. The pending set is DRAM, so
reads may be served from it (:meth:`pending_image`) without adding a
durability point.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.costmodel import COST_MODEL, PMemCostModel

__all__ = ["FlushQueue", "EpochReport"]


@dataclasses.dataclass
class EpochReport:
    """Exact counts + modeled wall-clock for one epoch drain."""

    pages: int = 0
    active_lanes: int = 0
    cow: int = 0
    mulog: int = 0
    barriers: int = 0
    blocks_written: int = 0
    modeled_ns: float = 0.0
    #: cold pages evicted to the SSD tier during this epoch
    pages_spilled: int = 0
    #: modeled SSD time of those evictions (drained concurrently with the
    #: PMem lane work in a real system; reported separately, not summed)
    spill_ns: float = 0.0
    #: device (HBM) bytes the save-path scan kernels read to classify and
    #: pack this epoch's pages (noted via :meth:`FlushQueue.note_scan`;
    #: one live-buffer read with the fused flush_pack kernel, up to three
    #: with the staged chain)
    scan_read_bytes: int = 0
    #: modeled device time of that scan traffic (included in modeled_ns)
    scan_ns: float = 0.0


class FlushQueue:
    """Coalescing, lane-partitioned flush queue over a page store."""

    def __init__(self, pages, *, lanes: int = 4, lane_id_base: int = 0,
                 flush_fn: Optional[Callable[..., Optional[str]]] = None,
                 cost_model: PMemCostModel = COST_MODEL,
                 spill=None, placer=None) -> None:
        """Wrap a page store (or :class:`~repro_torch.pool.PagesHandle`).

        Args:
            pages: the store whose pages this queue flushes.
            lanes: maximum concurrent flush lanes per epoch.
            lane_id_base: first lane id for stats attribution.
            flush_fn: optional ``(pid, page, dirty_lines, active_lanes)``
                override of ``store.flush`` (checkpoint shadow slots).
            cost_model: converts the epoch's op-count delta to time.
            spill: optional :class:`repro_torch.tier.SpillScheduler`; evicts
                cold slots to SSD when an epoch outgrows the PMem budget.
            placer: optional :class:`~repro_torch.io.placer.LanePlacer`; each
                epoch's flush lanes then run on CPU sockets near the page
                region's home socket, overflowing to remote sockets only
                past the near capacity (remote lanes pay the Izraelevitz
                far-socket multipliers in ``engine_time_ns``).
        """
        # accepts a PageStore or anything exposing one (PagesHandle)
        self.store = getattr(pages, "store", pages)
        self.lanes = max(1, int(lanes))
        self.lane_id_base = int(lane_id_base)
        self.cost_model = cost_model
        self._flush_fn = flush_fn
        self.spill = spill
        self.placer = placer
        # pid -> (latest page image, dirty line set | None=all dirty)
        self._pending: Dict[int, Tuple[np.ndarray, Optional[Set[int]]]] = {}
        # HBM bytes the save-path scan read for the pages now pending
        self._scan_bytes = 0

    def __len__(self) -> int:
        return len(self._pending)

    def enqueue(self, pid: int, page: np.ndarray,
                dirty_lines: Optional[Sequence[int]] = None, *,
                copy: bool = True, touch: bool = True) -> None:
        """Queue a page for the next epoch; re-enqueueing merges (latest
        image wins, dirty sets union). The image is copied by default so
        the caller may keep mutating its buffer; ``copy=False`` hands
        ownership of ``page`` to the queue (the checkpoint path builds a
        throwaway array per page — the whole epoch's page set is held
        until the drain, so avoiding the extra copy halves that spike).
        ``touch=False`` suppresses the spill-LRU touch — the buffer
        manager counts each logical access exactly once itself, and its
        write-back enqueues must not disturb the recency order (a
        frameless run would not see them)."""
        page = (np.array(page, dtype=np.uint8, copy=True) if copy
                else np.asarray(page, dtype=np.uint8)).ravel()
        if self.spill is not None and touch:
            # enqueue = recent use (LRU signal, attributed to OUR store)
            self.spill.touch(int(pid), self.store)
        prev = self._pending.get(int(pid))
        if prev is not None and prev[1] is not None and dirty_lines is not None:
            dirty: Optional[Set[int]] = prev[1] | set(int(i) for i in dirty_lines)
        elif prev is not None and (prev[1] is None or dirty_lines is None):
            dirty = None
        else:
            dirty = set(int(i) for i in dirty_lines) if dirty_lines is not None else None
        self._pending[int(pid)] = (page, dirty)

    def note_scan(self, nbytes: int) -> None:
        """Record device (HBM) bytes the save-path scan kernels read on
        behalf of pages being enqueued for the next epoch. The next
        :meth:`flush_epoch` folds the accumulated traffic into its
        modeled time (``engine_time_ns(scan_read_bytes=…)``) and reports
        it on :class:`EpochReport` — the fused flush_pack pass notes each
        live buffer once, the staged chain notes every extra pass."""
        self._scan_bytes += int(nbytes)

    # ------------------------------------------------- buffer-manager hooks

    def pending_image(self, pid: int
                      ) -> Optional[Tuple[np.ndarray, Optional[Set[int]]]]:
        """The coalesced ``(page, dirty)`` queued for ``pid``, or ``None``.
        The pending set is DRAM, so the buffer manager serves reads from
        it (a parked dirty eviction is still the page's newest image)."""
        return self._pending.get(int(pid))

    def pop_pending(self, pid: int
                    ) -> Optional[Tuple[np.ndarray, Optional[Set[int]]]]:
        """Remove and return ``pid``'s queued entry — the buffer manager
        re-adopts a parked image into a frame before writing to it."""
        return self._pending.pop(int(pid), None)

    def pending_pids(self) -> List[int]:
        """Queued pids in first-enqueued (drain) order."""
        return list(self._pending)

    def flush_epoch(self) -> EpochReport:
        """Drain the queue: flush every pending page, lane-partitioned.

        Returns exact counts for the epoch plus the modeled wall-clock
        under ``engine_time_ns`` (burst curve — page flushes are large
        sequential writes, Fig. 5(b))."""
        scan_bytes, self._scan_bytes = self._scan_bytes, 0
        scan_ns = self.cost_model.scan_read_ns(scan_bytes)
        if not self._pending:
            # an all-clean save still paid the scan that proved it clean
            return EpochReport(scan_read_bytes=scan_bytes, scan_ns=scan_ns,
                               modeled_ns=scan_ns)
        items = list(self._pending.items())
        self._pending.clear()
        active = max(1, min(self.lanes, len(items)))
        pm = self.store.pmem
        # NUMA: run every flush lane near the page region's home socket,
        # overflowing to remote CPU sockets only past the near capacity
        home = pm.home_socket(self.store.layout.base)
        if self.placer is not None:
            lane_cpu = self.placer.place([home] * active)
        else:
            lane_cpu = [home] * active
        before = pm.stats.snapshot()
        ssd_before = (self.spill.ssd.stats.snapshot()
                      if self.spill is not None else None)
        rep = EpochReport(pages=len(items), active_lanes=active)
        protect = {pid for pid, _ in items}
        new_pages = sum(1 for pid in protect if pid not in self.store.table)
        if self.spill is not None and new_pages:
            # feed the SSD tier BEFORE touching PMem: evict cold slots so
            # the batch's NET slot demand fits (first-time pages consume a
            # slot permanently; a resident page's CoW is net zero and the
            # +1 covers its transient double-occupancy). An epoch of pure
            # re-flushes triggers no eviction at all.
            rep.pages_spilled += self.spill.ensure_slots(
                self.store, need=new_pages + 1, protect=protect)
        for j, (pid, (page, dirty)) in enumerate(items):
            lines = None if dirty is None else sorted(dirty)
            with pm.lane(self.lane_id_base + (j % active),
                         socket=lane_cpu[j % active]):
                try:
                    if self._flush_fn is not None:
                        tech = self._flush_fn(pid, page, lines, active)
                    else:
                        tech = self.store.flush(pid, page, dirty_lines=lines,
                                                threads=active)
                except RuntimeError:
                    if self.spill is None:
                        raise
                    # mid-batch slot exhaustion (CoW retiring slower than
                    # allocating): evict and retry once. Here eviction MAY
                    # take a batch member (already-flushed ones are cold
                    # and perfectly spillable) — a batch larger than the
                    # whole slot budget has to cycle through itself.
                    rep.pages_spilled += self.spill.ensure_slots(
                        self.store, need=1, protect=protect,
                        allow_protected=True)
                    if self._flush_fn is not None:
                        tech = self._flush_fn(pid, page, lines, active)
                    else:
                        tech = self.store.flush(pid, page, dirty_lines=lines,
                                                threads=active)
            if tech == "mulog":
                rep.mulog += 1
            elif tech is not None:
                rep.cow += 1
        if self.spill is not None:
            rep.spill_ns = self.spill.ssd_cost.time_ns(
                self.spill.ssd.stats.delta(ssd_before))
        delta = pm.stats.delta(before)
        rep.barriers = delta.barriers
        rep.blocks_written = delta.blocks_written
        rep.scan_read_bytes = scan_bytes
        rep.scan_ns = scan_ns
        rep.modeled_ns = self.cost_model.engine_time_ns(
            delta, active_lanes=active, burst=True,
            scan_read_bytes=scan_bytes)
        return rep
