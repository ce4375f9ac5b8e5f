"""``repro_torch.io`` — lane-partitioned concurrent I/O engine.

The port's own copy of ``repro.io``.

The paper's headline results are concurrency results: bandwidth scales
with writer threads until the device's write-combining buffer is defeated
(Fig. 2), and both logging and page flushing are evaluated at 1-7 threads
(Figs. 5-6). This package refactors the write path from "caller touches
PMem directly" to "caller submits to an engine that schedules lanes,
batches and barriers":

- :mod:`repro_torch.io.multilog` — :class:`MultiLog`: appends striped over N
  per-lane Zero/Classic/Header logs with a global LSN, group-commit
  batching (k appends per barrier), merge-on-recovery reconstructing the
  exact durable global prefix across lanes; ``gen_sets >= 2`` adds the
  generation ring (``roll()`` seals, the spill tier retires to SSD).
- :mod:`repro_torch.io.flushq`   — :class:`FlushQueue`: coalescing flush queue
  in front of a :class:`~repro_torch.core.pageflush.PageStore`; each epoch is
  lane-partitioned and the Hybrid crossover uses the *actual* number of
  active lanes; with ``spill=`` attached, epochs that outgrow the PMem
  slot budget evict cold slots to the SSD tier instead of raising. It
  is also the sole write-back path of the DRAM buffer manager
  (:class:`~repro_torch.cache.BufferManager`): dirty frames drain as one
  epoch, clock-evicted dirty frames park in the pending set.
- :mod:`repro_torch.io.engine`   — :class:`IOEngine`: facade allocating
  non-overlapping lane ids and converting per-lane op counts to modeled
  wall-clock (``costmodel.engine_time_ns``: max over lanes, Fig. 2
  concurrency curve, write-combining-defeat penalty).
- :mod:`repro_torch.io.placer`   — :class:`LanePlacer`: NUMA-aware lane
  placement — spreads new lane regions over the sockets, runs each lane
  on a CPU socket near its region (falling back to remote sockets only
  under load), and adapts per-lane group-commit sizes to the observed
  submit rate and socket distance. Consulted automatically on any
  multi-socket pool.

Consumers: ``pool.multilog(...)`` / ``pool.wal(..., lanes=N)`` for the
training WAL, ``CheckpointManager`` (page flushes batched per save
epoch), ``PersistentKV`` (checkpoint flushing with ``flush_lanes``), and
``AsyncFlusher`` (one worker lane per checkpoint shard).
"""

from repro_torch.io.engine import IOEngine  # noqa: F401
from repro_torch.io.flushq import EpochReport, FlushQueue  # noqa: F401
from repro_torch.io.multilog import MultiLog, MultiLogRecovered  # noqa: F401
from repro_torch.io.placer import LanePlacer  # noqa: F401
