"""``repro_torch.tier`` — the SSD capacity tier below PMem.

The paper positions PMem *between* DRAM and flash: fast enough to
absorb the I/O critical path, but capacity-constrained, with NAND flash
as the cheap cold tier underneath. This package completes that
hierarchy for the whole stack:

- :mod:`repro_torch.core.ssd`      — the modeled flash device (block-granular,
  write-buffered, crash-simulated) and its exact op counts.
- :class:`~repro_torch.core.costmodel.SSDCostModel` — counts → modeled time
  with the Fig. 1 latency/bandwidth gap and NAND's read/write asymmetry.
- :mod:`repro_torch.tier.spill`    — :class:`SpillScheduler`: evicts cold page
  slots and sealed WAL generations to SSD-backed directory regions
  (``KIND_SSD``), promotes pages back on access, and keeps everything
  reachable across crashes through a checksummed, double-buffered spill
  map.

Wiring: a :class:`~repro_torch.io.flushq.FlushQueue` takes ``spill=`` and
feeds the tier at epoch drains (an epoch that outgrows the PMem slot
budget evicts cold pages instead of failing allocation); a generational
:class:`~repro_torch.io.multilog.MultiLog` enqueues sealed generations at
:meth:`~repro_torch.io.multilog.MultiLog.roll`; and
:class:`repro.core.recovery.PersistentKV` (not ported yet) drives both from its
checkpoint path (``KVConfig(slot_budget=…, wal_lanes=…)``), which is
what lets it run a lane-striped redo log indefinitely in bounded PMem.

Above the scheduler sits the DRAM rung
(:class:`~repro_torch.cache.BufferManager`): it registers its k-touch counter
as the scheduler's ``admission`` policy (on-access promotion then fires
on the k-th touch, not the first), its pinned frames as the
``pin_guard`` honored by :meth:`SpillScheduler.ensure_slots`, and is
told about every slot eviction via ``on_page_evict``. On reopen the
scheduler rebuilds its SSD extent free-list from the durable spill map,
so holes a previous run tombstoned are reusable instead of leaked.
"""

from repro_torch.core.ssd import SSD, SSDStats  # noqa: F401
from repro_torch.tier.spill import SpillScheduler, SpillStats  # noqa: F401
