"""IOEngine — the facade tying lanes, group commit and accounting together.

One engine per pool. It hands out the two concurrent front ends —
:class:`~repro_torch.io.multilog.MultiLog` (lane-striped group-commit logging)
and :class:`~repro_torch.io.flushq.FlushQueue` (batched, lane-partitioned page
flushing) — with non-overlapping lane-id ranges, so per-lane counts from
different components never collide in :class:`~repro_torch.core.pmem.PMemStats`,
and converts op-count deltas to modeled wall-clock with the lane-aware
``engine_time_ns`` (max-over-lanes + Fig. 2 concurrency curve + write-
combining-defeat penalty past ``wc_defeat_lanes``).

    pool = Pool.create(None, 1 << 24)
    eng  = IOEngine(pool, lanes=4, group_commit=8)
    wal  = eng.multilog("wal", capacity=1 << 20)      # 4 zero-log lanes
    for rec in records:
        wal.append(rec)                                # buffered
    wal.commit()                                       # ~lanes barriers total

    fq = eng.flush_queue(pool.pages("heap", npages=64, page_size=16384))
    for pid, page, dirty in updates:
        fq.enqueue(pid, page, dirty)                   # coalesces
    report = fq.flush_epoch()                          # lanes-aware hybrid
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.costmodel import COST_MODEL, PMemCostModel
from repro_torch.core.log import LogConfig
from repro_torch.core.persist import AccessPattern, FlushKind
from repro_torch.core.pmem import PMemStats
from repro_torch.io.flushq import FlushQueue
from repro_torch.io.multilog import DEFAULT_GROUP_COMMIT, MultiLog

__all__ = ["IOEngine"]


class IOEngine:
    """Lane-partitioned concurrent I/O engine over one pool."""

    def __init__(self, pool, *, lanes: int = 4,
                 group_commit: int = DEFAULT_GROUP_COMMIT,
                 cost_model: PMemCostModel = COST_MODEL,
                 placer=None) -> None:
        """One engine per pool: ``lanes`` and ``group_commit`` are the
        defaults handed to front ends; ``cost_model`` converts op-count
        deltas to modeled time. ``placer`` (a
        :class:`~repro_torch.io.placer.LanePlacer`) is handed to every front
        end so lanes run near their regions' NUMA home sockets; it
        defaults to the pool's placer on a multi-socket pool."""
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        self.pool = pool
        self.lanes = int(lanes)
        self.group_commit = int(group_commit)
        self.cost_model = cost_model
        if placer is None and getattr(pool, "sockets", 1) > 1:
            placer = pool.placer()
        self.placer = placer
        self._next_lane_id = 0

    def _alloc_lane_ids(self, n: int) -> int:
        base = self._next_lane_id
        self._next_lane_id += n
        return base

    # ---------------------------------------------------------- front ends

    def multilog(self, name: str, capacity: Optional[int] = None, *,
                 technique: Optional[str] = None,
                 lanes: Optional[int] = None,
                 group_commit: Optional[int] = None,
                 cfg: Optional[LogConfig] = None,
                 gen_sets: int = 1) -> MultiLog:
        """Open-or-create a lane-striped group-commit log (defaults to the
        engine's lane/group-commit configuration). ``gen_sets >= 2``
        creates it generational — sealable/rollable, with sealed
        generations retirable to the SSD tier."""
        n = lanes if lanes is not None else self.lanes
        ml = MultiLog(self.pool, name, lanes=n if capacity is not None else lanes,
                      capacity=capacity, technique=technique,
                      group_commit=group_commit if group_commit is not None
                      else self.group_commit,
                      cfg=cfg, lane_id_base=0, gen_sets=gen_sets,
                      placer=self.placer)
        ml.lane_id_base = self._alloc_lane_ids(ml.lanes)
        return ml

    def flush_queue(self, pages, *, lanes: Optional[int] = None,
                    flush_fn: Optional[Callable[..., Optional[str]]] = None,
                    spill=None) -> FlushQueue:
        """A batched flush queue over a pages handle / page store; pass
        ``spill=`` (a :class:`repro_torch.tier.SpillScheduler`) to let epochs
        overflow cold slots to the SSD tier instead of raising."""
        n = lanes if lanes is not None else self.lanes
        return FlushQueue(pages, lanes=n,
                          lane_id_base=self._alloc_lane_ids(n),
                          flush_fn=flush_fn, cost_model=self.cost_model,
                          spill=spill, placer=self.placer)

    def spill_scheduler(self, ssd=None, *, name: str = "spill", **kw):
        """The pool's :class:`repro_torch.tier.SpillScheduler` — the engine's
        third front end, feeding the SSD capacity tier at epoch
        boundaries. ``ssd`` attaches a device if the pool has none yet;
        remaining keywords pass through (watermarks, arena sizing)."""
        from repro_torch.tier import SpillScheduler
        return SpillScheduler(self.pool, ssd, name=name, **kw)

    def cache(self, frames: Optional[int] = None,
              admit_k: Optional[int] = None):
        """The pool's DRAM :class:`~repro_torch.cache.BufferManager`
        (``pool.cache``) — the engine's top rung: page reads served from
        bounded DRAM frames, dirty frames written back through this
        engine's flush-queue epochs, SSD→PMem promotion gated by
        k-touch admission."""
        return self.pool.cache(frames=frames, admit_k=admit_k)

    # ---------------------------------------------------------- accounting

    def modeled_ns(self, delta: PMemStats, *,
                   active_lanes: Optional[int] = None,
                   kind: FlushKind = FlushKind.NT,
                   pattern: AccessPattern = AccessPattern.SEQUENTIAL,
                   burst: bool = False, cache=None) -> float:
        """Lane-aware modeled wall-clock for an op-count delta; ``cache``
        (a :class:`~repro_torch.cache.CacheStats` delta) folds DRAM buffer
        hits into the same clock."""
        return self.cost_model.engine_time_ns(
            delta, active_lanes=active_lanes, kind=kind, pattern=pattern,
            burst=burst, cache=cache)
