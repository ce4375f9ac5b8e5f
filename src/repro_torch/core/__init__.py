"""The paper's primary contribution: PMem I/O primitives.

The port's own copy of ``repro.core``.

The public entry point for *consuming* these primitives is
:class:`repro_torch.pool.Pool` — a PMDK-style pool with a durable region
directory and uniform named handles (``pool.log`` / ``pool.pages`` /
``pool.kv`` / ``pool.wal``). The modules below are the substrate:

- :mod:`repro_torch.core.pmem`      — functional PMem model (cache/WC semantics,
  crash simulation, exact op accounting)
- :mod:`repro_torch.core.directory` — durable region directory (single-line
  entry commits, pvn-style max-generation validity) under the pool
- :mod:`repro_torch.core.log`       — Classic / Header(±dancing) / Zero logging
- :mod:`repro_torch.core.pageflush` — CoW(+pvn) / µLog / Hybrid page flushing
- :mod:`repro_torch.core.recovery`  — minimal buffer-managed KV engine (YCSB
  validation target), built on the pool
- :mod:`repro_torch.core.costmodel` — counts → time, calibrated to the paper
  (incl. ``engine_time_ns``: lane-concurrent wall-clock for
  :mod:`repro_torch.io`, the lane-partitioned I/O engine built on all of this)
- :mod:`repro_torch.core.ssd`       — functional flash model (block-granular,
  write-buffered, crash-simulated) — the capacity tier below PMem that
  :mod:`repro_torch.tier` spills to, costed by ``SSDCostModel``
"""

from repro_torch.core.blocks import (  # noqa: F401
    BlockGeometry,
    CACHE_LINE,
    PAPER_GEOMETRY,
    PMEM_BLOCK,
    TPU_GEOMETRY,
    TPU_TILE,
)
from repro_torch.core.costmodel import (  # noqa: F401
    COST_MODEL,
    DRAMCostModel,
    PMemCostModel,
    SSD_COST_MODEL,
    SSDCostModel,
)
from repro_torch.core.directory import (  # noqa: F401
    KIND_LOG,
    KIND_PAGES,
    KIND_RAW,
    KIND_SSD,
    RegionDirectory,
    RegionRecord,
    directory_bytes,
)
from repro_torch.core.log import (  # noqa: F401
    ClassicLog,
    HeaderLog,
    LOG_TECHNIQUES,
    LogConfig,
    RecoveredLog,
    ZeroLog,
)
from repro_torch.core.pageflush import (  # noqa: F401
    HybridPolicy,
    MicroLog,
    PageStore,
    PageStoreLayout,
    recover_page_table,
)
from repro_torch.core.persist import AccessPattern, FlushKind, INVALID_PID  # noqa: F401
from repro_torch.core.pmem import CrashImage, PMem, PMemStats  # noqa: F401
from repro_torch.core.recovery import KVConfig, PersistentKV  # noqa: F401
from repro_torch.core.ssd import SSD, SSDStats  # noqa: F401
