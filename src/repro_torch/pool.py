"""``repro_torch.pool`` — a PMDK-style pool/handle API over the PMem primitives.

This is the single entry point every PMem consumer goes through. A *pool*
is one PMem region (optionally file-backed) whose head holds a durable
:class:`~repro_torch.core.directory.RegionDirectory`: a table of named, typed,
geometry-tagged regions, each allocated failure-atomically (single-cache-
line entry commit, pvn-style max-generation validity). On top of the
directory sit uniform *handles*, all sharing one lifecycle protocol —
open-or-create by name, recover automatically, ``close()`` when done, and
a ``stats()`` delta view windowing the pool's exact op counts from the
moment the handle was opened (pool-wide counters: concurrent handles on
one pool see each other's traffic):

    pool = Pool.create("/dev/shm/app.pmem", 1 << 24)
    wal  = pool.log("wal", capacity=1 << 20, technique="zero")
    wal.append(b"record")                       # ONE barrier (paper §3.3.1)

    pages = pool.pages("heap", npages=64, page_size=16384)
    pages.flush(0, page, dirty_lines=[3, 4])    # hybrid CoW/µLog (§3.2.3)

    kv = pool.kv("store", KVConfig())           # buffer pool + WAL + root
    train_wal = pool.wal("steps", capacity_steps=10_000)
    cache = pool.cache(frames=64, admit_k=2)    # DRAM rung (repro_torch.cache)

    pool2 = Pool.open("/dev/shm/app.pmem")      # after crash: same names,
    wal2  = pool2.log("wal")                    # recovered to the tail

Geometry is a pool-level property (paper 64 B/256 B or TPU 4 KiB/16 KiB
tiles) recorded in the superblock, so ``Pool.open`` needs no out-of-band
configuration. Handles never hand out raw byte offsets; all layout math
lives behind the directory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blocks import BlockGeometry, PAPER_GEOMETRY, align_up
from repro_torch.core.directory import (
    KIND_LOG,
    KIND_PAGES,
    KIND_RAW,
    KIND_SSD,
    RegionDirectory,
    RegionRecord,
    directory_bytes,
    probe_file,
)
from repro_torch.core.log import LOG_TECHNIQUES, LogConfig, RecoveredLog
from repro_torch.core.pageflush import PageStore, PageStoreLayout
from repro_torch.core.persist import FlushKind
from repro_torch.core.pmem import PMem, PMemStats
from repro_torch.core.ssd import SSD

__all__ = [
    "Pool",
    "Handle",
    "LogHandle",
    "PagesHandle",
    "RawHandle",
    "SSDRegionHandle",
    "DEFAULT_MAX_REGIONS",
]

DEFAULT_MAX_REGIONS = 64

_TECH_ID = {"classic": 0, "header": 1, "zero": 2}
_TECH_NAME = {v: k for k, v in _TECH_ID.items()}
_FLAG_PAD_LINE = 1
_FLAG_PAD_BLOCK = 2


def _log_meta(technique: str, cfg: LogConfig) -> Tuple[int, int, int, int]:
    flags = (_FLAG_PAD_LINE if cfg.pad_to_line else 0) | (
        _FLAG_PAD_BLOCK if cfg.pad_to_block else 0)
    return (_TECH_ID[technique], flags, cfg.dancing, 0)


def _log_cfg_from_meta(meta: Sequence[int], geometry: BlockGeometry,
                       flush_kind: FlushKind) -> Tuple[str, LogConfig]:
    technique = _TECH_NAME[meta[0]]
    cfg = LogConfig(
        geometry=geometry,
        pad_to_line=bool(meta[1] & _FLAG_PAD_LINE),
        pad_to_block=bool(meta[1] & _FLAG_PAD_BLOCK),
        dancing=int(meta[2]) or 1,
        flush_kind=flush_kind,
    )
    return technique, cfg


class Handle:
    """Base of every pool handle: name/record access and a stats window."""

    def __init__(self, pool: "Pool", record: RegionRecord) -> None:
        """Bind to ``record`` in ``pool`` and open a stats window."""
        self.pool = pool
        self.record = record
        self._stats0 = pool.pmem.stats.snapshot()
        self._closed = False

    # -- identity ---------------------------------------------------------
    @property
    def name(self) -> str:
        """The region's directory name."""
        return self.record.name

    @property
    def base(self) -> int:
        """First byte of the region (pool-absolute; SSD-space for
        ``KIND_SSD`` records)."""
        return self.record.base

    @property
    def length(self) -> int:
        """Region size in bytes."""
        return self.record.length

    # -- lifecycle --------------------------------------------------------
    def stats(self) -> PMemStats:
        """Exact op counts accrued on the pool since this handle was opened
        (or since :meth:`reset_stats`)."""
        return self.pool.pmem.stats.delta(self._stats0)

    def reset_stats(self) -> None:
        """Restart the stats window at the current pool counters."""
        self._stats0 = self.pool.pmem.stats.snapshot()

    def close(self) -> None:
        """Drop volatile state. The durable region stays; reopen by name."""
        self._closed = True

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(f"handle {self.name!r} is closed")


class LogHandle(Handle):
    """One interface over the three log techniques, recovery included.

    Created by :meth:`Pool.log`. ``append()`` costs exactly
    ``barriers_per_append`` persistency barriers (1 for Zero, 2 for
    Header/Classic); ``recovered`` holds what recovery found at open time
    (empty for a fresh region)."""

    def __init__(self, pool: "Pool", record: RegionRecord, technique: str,
                 cfg: LogConfig, writer, recovered: RecoveredLog) -> None:
        """Wrap an opened per-technique writer (built by :meth:`Pool.log`)
        together with what recovery found at open time."""
        super().__init__(pool, record)
        self.technique = technique
        self.cfg = cfg
        self._writer = writer
        self.recovered = recovered

    # -- append path ------------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Durably append one entry; returns its LSN."""
        self._check_open()
        return self._writer.append(payload)

    def append_batch(self, payloads: Sequence[bytes]) -> list:
        """Group commit: durably append many entries, amortizing the
        technique's barriers over the batch (repro_torch.io engine path)."""
        self._check_open()
        return self._writer.append_batch(list(payloads))

    @property
    def tail(self) -> int:
        """Byte offset (region-relative) where the next entry goes."""
        return self._writer.tail

    @property
    def next_lsn(self) -> int:
        """LSN the next append will receive."""
        return self._writer.next_lsn

    @property
    def barriers_per_append(self) -> int:
        """Persistency barriers per append (1 Zero, 2 Header/Classic)."""
        return self._writer.BARRIERS_PER_APPEND

    @property
    def capacity(self) -> int:
        """Region bytes available to the log."""
        return self.record.length

    # -- recovery ---------------------------------------------------------
    def recover(self) -> RecoveredLog:
        """Re-run recovery against the current *durable* image (what a
        restart would see right now)."""
        cls = LOG_TECHNIQUES[self.technique]
        return cls.recover(self.pool.pmem, self.base, self.length, self.cfg)

    def reset(self) -> None:
        """Start a new log generation: durably re-zero the region (Zero
        logging requires it; the others tolerate it) and restart the writer
        at LSN 1. Bulk streaming traffic, not barrier-bound."""
        self._check_open()
        pm = self.pool.pmem
        off, end = self.base, self.base + self.length
        while off < end:
            n = min(1 << 20, end - off)
            pm.store(off, np.zeros(n, dtype=np.uint8), streaming=True)
            off += n
        pm.sfence()
        cls = LOG_TECHNIQUES[self.technique]
        self._writer = cls(pm, self.base, self.length, self.cfg)
        self.recovered = RecoveredLog([], [], self._writer.tail, 1)


class PagesHandle(Handle):
    """Failure-atomic page region: CoW(+pvn) / µLog / hybrid flushing.

    Wraps a :class:`PageStore` (and its :class:`HybridPolicy`) whose layout
    — slot array plus µlogs — lives entirely inside this region."""

    def __init__(self, pool: "Pool", record: RegionRecord,
                 store: PageStore) -> None:
        """Wrap an opened :class:`PageStore` (built by :meth:`Pool.pages`)."""
        super().__init__(pool, record)
        self.store = store

    # layout / policy passthroughs ---------------------------------------
    @property
    def layout(self) -> PageStoreLayout:
        """The store's byte layout (slots, µlogs, geometry)."""
        return self.store.layout

    @property
    def policy(self):
        """The µLog-vs-CoW :class:`~repro_torch.core.pageflush.HybridPolicy`."""
        return self.store.policy

    @property
    def table(self) -> Dict[int, Tuple[int, int]]:
        """Volatile page table: pid -> (slot, pvn)."""
        return self.store.table

    @property
    def npages(self) -> int:
        """Logical pages the region addresses."""
        return self.store.layout.npages

    @property
    def page_size(self) -> int:
        """Bytes per page."""
        return self.store.layout.page_size

    # flush / read --------------------------------------------------------
    def flush(self, pid: int, page: np.ndarray,
              dirty_lines: Optional[Sequence[int]] = None, *,
              threads: Optional[int] = None) -> str:
        """Hybrid flush (µLog vs CoW by the cost model); returns the
        technique used. See :meth:`PageStore.flush`."""
        self._check_open()
        return self.store.flush(pid, page, dirty_lines=dirty_lines,
                                threads=threads)

    def flush_queue(self, *, lanes: int = 4, lane_id_base: int = 0,
                    flush_fn=None, spill=None, placer=None):
        """A :class:`repro_torch.io.FlushQueue` over this region: enqueue dirty
        pages, drain once per epoch with lane-partitioned, batched flushing
        (the Hybrid crossover then follows the actual active-lane count).
        ``spill`` attaches a :class:`repro_torch.tier.SpillScheduler` so epochs
        that outgrow the slot budget evict to SSD instead of raising;
        ``placer`` defaults to the pool's lane placer on a multi-socket
        pool (flush lanes then run near this region's home socket)."""
        from repro_torch.io.flushq import FlushQueue
        if placer is None and self.pool.sockets > 1:
            placer = self.pool.placer()
        return FlushQueue(self, lanes=lanes, lane_id_base=lane_id_base,
                          flush_fn=flush_fn, spill=spill, placer=placer)

    def flush_cow(self, pid: int, page: np.ndarray, **kw) -> None:
        """Force a CoW(+pvn) flush. See :meth:`PageStore.flush_cow`."""
        self._check_open()
        self.store.flush_cow(pid, page, **kw)

    def flush_mulog(self, pid: int, page: np.ndarray,
                    dirty_lines: Sequence[int], **kw) -> None:
        """Force a µLog delta flush. See :meth:`PageStore.flush_mulog`."""
        self._check_open()
        self.store.flush_mulog(pid, page, dirty_lines, **kw)

    def read_page(self, pid: int) -> np.ndarray:
        """Program-order read of the page's current slot."""
        return self.store.read_page(pid)

    def durable_page(self, pid: int) -> Optional[np.ndarray]:
        """The page's durable image (what recovery would see), or
        ``None`` if no valid slot holds it."""
        return self.store.durable_page(pid)


class RawHandle(Handle):
    """An untyped byte range with handle-relative addressing — for small
    fixed structures (roots, superblock-like records) that a consumer
    commits with its own protocol."""

    def _span(self, off: int, size: int) -> None:
        if off < 0 or size < 0 or off + size > self.length:
            raise ValueError(
                f"access [{off}, {off + size}) outside region "
                f"{self.name!r} of {self.length} B")

    def store(self, off: int, data: bytes | np.ndarray, *,
              streaming: bool = False) -> None:
        """Store bytes at a handle-relative offset (bounds-checked)."""
        self._check_open()
        data = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        self._span(off, data.size)
        self.pool.pmem.store(self.base + off, data, streaming=streaming)

    def load(self, off: int, size: int, **kw) -> np.ndarray:
        """Program-order read at a handle-relative offset."""
        self._span(off, size)
        return self.pool.pmem.load(self.base + off, size, **kw)

    def persist(self, off: int, size: int,
                kind: FlushKind = FlushKind.CLWB) -> None:
        """persist() a handle-relative range (flush covering lines +
        fence; ``kind=NT`` fences streaming stores)."""
        self._span(off, size)
        self.pool.pmem.persist(self.base + off, size, kind=kind)

    def durable_view(self) -> np.ndarray:
        """The region's durable image (what recovery would see)."""
        return self.pool.pmem.durable_slice(self.base, self.length)


class SSDRegionHandle(Handle):
    """A named range of the pool's attached SSD device (``KIND_SSD``).

    The *binding* (name → SSD byte range) is a durable single-line entry
    in the pool's PMem directory; the *bytes* live on the SSD attached
    via :meth:`Pool.attach_ssd`. Reads/writes are bounds-checked against
    the record and routed to the device; durability requires
    :meth:`flush` (the device's FLUSH CACHE), mirroring how PMem stores
    require a fence. Content validity across crashes is the consumer's
    protocol — the spill tier gates every read on a checksummed map
    record committed in PMem *after* the SSD flush."""

    def __init__(self, pool: "Pool", record: RegionRecord, ssd: SSD) -> None:
        """Bind a ``KIND_SSD`` record to the attached flash device."""
        super().__init__(pool, record)
        self.ssd = ssd

    def _span(self, off: int, size: int) -> None:
        if off < 0 or size < 0 or off + size > self.length:
            raise ValueError(
                f"access [{off}, {off + size}) outside SSD region "
                f"{self.name!r} of {self.length} B")

    def pwrite(self, off: int, data) -> None:
        """Write into the region (device write cache; durable at
        :meth:`flush`)."""
        self._check_open()
        data = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        self._span(off, data.size)
        self.ssd.pwrite(self.base + off, data)

    def pread(self, off: int, size: int) -> np.ndarray:
        """Read from the region (sees unflushed writes)."""
        self._span(off, size)
        return self.ssd.pread(self.base + off, size)

    def flush(self) -> None:
        """Make every buffered write of the *device* durable (FLUSH
        CACHE is device-wide, like sfence is core-wide)."""
        self.ssd.flush()

    def durable_read(self, off: int, size: int) -> np.ndarray:
        """The durable image of a range (what recovery would see)."""
        self._span(off, size)
        return self.ssd.durable_read(self.base + off, size)


class Pool:
    """One PMem region + durable directory + uniform handles."""

    def __init__(self, pmem: PMem, directory: RegionDirectory) -> None:
        """Bind a PMem to its loaded directory (prefer :meth:`create` /
        :meth:`open` / :meth:`attach`)."""
        self.pmem = pmem
        self.directory = directory
        #: SSD device backing ``KIND_SSD`` regions (see :meth:`attach_ssd`)
        self.ssd_dev: Optional[SSD] = None
        self._placer = None
        self._cache = None

    # ------------------------------------------------------------ basics

    @property
    def geometry(self) -> BlockGeometry:
        """The pool's block geometry (from the superblock)."""
        return self.pmem.geometry

    @property
    def path(self) -> Optional[str]:
        """Backing file path, or ``None`` for an in-memory pool."""
        return self.pmem.path

    @property
    def size(self) -> int:
        """Pool size in bytes."""
        return self.pmem.size

    @property
    def free_bytes(self) -> int:
        """PMem bytes not yet claimed by any directory region."""
        return self.directory.free_bytes

    @property
    def sockets(self) -> int:
        """NUMA socket count the pool was formatted for (superblock)."""
        return self.pmem.sockets

    def placer(self):
        """The pool's default :class:`~repro_torch.io.placer.LanePlacer` (cached):
        assigns lane CPU sockets near the lanes' home-socket regions,
        falling back to remote sockets only when near capacity is
        exhausted, and adapts per-lane group-commit sizes. MultiLog /
        FlushQueue consult it automatically on a multi-socket pool."""
        if self._placer is None:
            from repro_torch.io.placer import LanePlacer
            self._placer = LanePlacer(self.pmem)
        return self._placer

    def cache(self, frames: Optional[int] = None,
              admit_k: Optional[int] = None,
              scan_frac: Optional[float] = None):
        """The pool's DRAM :class:`~repro_torch.cache.BufferManager` (cached,
        like :meth:`placer`): one bounded frame pool fronting every page
        region that registers with it
        (:meth:`~repro_torch.cache.BufferManager.attach_pages`) — the single
        read/write path across DRAM frames, PMem slots and the SSD
        spill tier. ``frames`` bounds the pool (0 disables caching;
        reads/writes pass straight through to the tiers); ``admit_k``
        is the k-touch SSD→PMem promotion threshold; ``scan_frac`` is
        the 2Q probationary fraction of a quota'd owner's budget (1.0
        disables scan resistance; per-owner overrides via
        :meth:`~repro_torch.cache.BufferManager.set_scan_frac`). Defaults on
        first construction: 64 frames, ``admit_k=2``, ``scan_frac=1.0``.
        The first call fixes the configuration; a later call with a
        *different* explicit value raises (consumers sharing the pool
        share the cache)."""
        if self._cache is None:
            from repro_torch.cache import BufferManager
            self._cache = BufferManager(
                self,
                frames=64 if frames is None else int(frames),
                admit_k=2 if admit_k is None else int(admit_k),
                scan_frac=1.0 if scan_frac is None else float(scan_frac))
            return self._cache
        if frames is not None and int(frames) != self._cache.capacity:
            raise ValueError(
                f"pool cache holds {self._cache.capacity} frames, caller "
                f"asked for {frames} — the frame pool is fixed at first "
                f"construction")
        if admit_k is not None and int(admit_k) != self._cache.admit_k:
            raise ValueError(
                f"pool cache admits at k={self._cache.admit_k}, caller "
                f"asked for {admit_k} — the admission policy is fixed at "
                f"first construction")
        if scan_frac is not None and float(scan_frac) != self._cache.scan_frac:
            raise ValueError(
                f"pool cache runs scan_frac={self._cache.scan_frac}, caller "
                f"asked for {scan_frac} — the 2Q split is fixed at first "
                f"construction (override per owner via set_scan_frac)")
        return self._cache

    def regions(self) -> Dict[str, RegionRecord]:
        """Snapshot of every committed directory record, by name."""
        return dict(self.directory.records)

    def fsync(self) -> None:
        """Push a file-backed pool's durable image to stable media."""
        self.pmem.fsync()

    @property
    def stats(self) -> PMemStats:
        """The pool's exact PMem op counters (pool-wide)."""
        return self.pmem.stats

    @staticmethod
    def overhead_bytes(geometry: BlockGeometry = PAPER_GEOMETRY,
                       max_regions: int = DEFAULT_MAX_REGIONS) -> int:
        """Directory bytes at the head of a pool — add this when sizing a
        region for a known payload."""
        return directory_bytes(geometry, max_regions)

    # --------------------------------------------------------- lifecycle

    @classmethod
    def create(cls, path: Optional[str], size: int, *,
               geometry: BlockGeometry = PAPER_GEOMETRY,
               max_regions: int = DEFAULT_MAX_REGIONS,
               sockets: int = 1) -> "Pool":
        """Format a fresh pool (``path=None`` → volatile in-memory region,
        used by simulations and benchmarks). ``sockets`` records the NUMA
        topology in the superblock; region creation then accepts
        ``socket=`` home tags and the lane placer prefers near-socket
        lanes (see ``docs/architecture.md``)."""
        pmem = PMem(size, path=path, geometry=geometry, sockets=sockets)
        pmem.memset_zero()
        directory = RegionDirectory.format(pmem, max_regions=max_regions)
        return cls(pmem, directory)

    @classmethod
    def open(cls, path: Optional[str] = None, *,
             pmem: Optional[PMem] = None) -> "Pool":
        """Open an existing pool from a file (geometry and size come from
        the superblock) or attach to a live :class:`PMem` (crash tests)."""
        if pmem is None:
            if path is None:
                raise ValueError("Pool.open needs a path or a pmem")
            sb = probe_file(path)
            if sb is None:
                if not os.path.exists(path):
                    raise FileNotFoundError(path)
                # existing-but-unreadable is corruption, not absence — a
                # try/except FileNotFoundError → create() fallback must
                # never format over a damaged pool
                raise ValueError(f"{path} exists but is not a formatted "
                                 f"pool (bad or torn superblock)")
            cache_line, block, _max_regions, size, sockets = sb
            actual = os.path.getsize(path)
            if actual != size:
                # never let PMem's size-mismatch branch recreate (truncate)
                # the file on what must be a read path
                raise ValueError(
                    f"{path}: superblock says {size} B but file is "
                    f"{actual} B — refusing to open a truncated/grown pool")
            pmem = PMem(size, path=path,
                        geometry=BlockGeometry(cache_line=cache_line,
                                               block=block),
                        sockets=sockets)
        return cls(pmem, RegionDirectory.load(pmem))

    @classmethod
    def open_or_create(cls, path: str, size: int, *,
                       geometry: BlockGeometry = PAPER_GEOMETRY,
                       max_regions: int = DEFAULT_MAX_REGIONS,
                       sockets: int = 1) -> "Pool":
        """Open ``path`` if it is a formatted pool, else create one there
        (refusing to overwrite a non-pool file). On open, the superblock's
        recorded socket topology wins over ``sockets``."""
        if probe_file(path) is not None:
            return cls.open(path)
        if os.path.exists(path) and os.path.getsize(path) > 0:
            # an existing non-pool file is someone's data, not ours to format
            raise ValueError(
                f"{path} exists but is not a formatted pool; refusing to "
                f"overwrite it (delete it or pick another path)")
        return cls.create(path, size, geometry=geometry,
                          max_regions=max_regions, sockets=sockets)

    @classmethod
    def attach(cls, pmem: PMem,
               max_regions: int = DEFAULT_MAX_REGIONS) -> "Pool":
        """Adopt a caller-owned PMem: open the directory if one is present,
        else format in place (the legacy-constructor shim path).

        Formatting is refused if the would-be directory span holds any
        nonzero durable byte — that is somebody's pre-pool data (e.g. a
        pre-directory legacy image), and formatting would zero it."""
        if RegionDirectory.is_formatted(pmem):
            return cls(pmem, RegionDirectory.load(pmem))
        span = directory_bytes(pmem.geometry, max_regions)
        if pmem.durable_slice(0, min(span, pmem.size)).any():
            raise ValueError(
                "region head holds durable data but no pool directory — "
                "refusing to format over it (zero the region explicitly to "
                "adopt it as a pool)")
        return cls(pmem, RegionDirectory.format(pmem, max_regions=max_regions))

    # ------------------------------------------------------------ handles

    def log(self, name: str, capacity: Optional[int] = None,
            technique: Optional[str] = None,
            cfg: Optional[LogConfig] = None, *,
            socket: Optional[int] = None) -> LogHandle:
        """Open-or-create a named log region.

        Create path (region absent): ``capacity`` is required; ``technique``
        defaults to ``"zero"``; ``socket`` tags the region's NUMA home
        socket (default 0). Open path: layout-relevant parameters come
        from the durable directory record; passing a conflicting
        ``technique``/``cfg``/``socket`` raises. ``cfg.flush_kind`` is
        volatile and honored either way."""
        rec = self.directory.lookup(name)
        flush_kind = cfg.flush_kind if cfg is not None else FlushKind.NT
        if rec is None:
            if capacity is None:
                raise ValueError(f"creating log {name!r} requires capacity=")
            technique = technique or "zero"
            if technique not in LOG_TECHNIQUES:
                raise ValueError(f"unknown log technique {technique!r}")
            cfg = dataclasses.replace(cfg or LogConfig(),
                                      geometry=self.geometry)
            rec = self.directory.allocate(name, KIND_LOG, int(capacity),
                                          _log_meta(technique, cfg),
                                          socket=socket or 0)
            cls = LOG_TECHNIQUES[technique]
            writer = cls(self.pmem, rec.base, rec.length, cfg)
            recovered = RecoveredLog([], [], writer.tail, 1)
            return LogHandle(self, rec, technique, cfg, writer, recovered)

        rec = self.directory.require(name, KIND_LOG)
        if capacity is not None and rec.length < capacity:
            raise ValueError(
                f"log {name!r} holds {rec.length} B, caller asked for "
                f"{capacity} B — the durable region cannot grow")
        if socket is not None and socket != rec.socket:
            raise ValueError(f"log {name!r} lives on socket {rec.socket}, "
                             f"caller asked for {socket} — home sockets "
                             f"are fixed at creation")
        stored_tech, stored_cfg = _log_cfg_from_meta(rec.meta, self.geometry,
                                                     flush_kind)
        if technique is not None and technique != stored_tech:
            raise ValueError(
                f"log {name!r} was created with technique "
                f"{stored_tech!r}, not {technique!r}")
        if cfg is not None and (
            (cfg.pad_to_line, cfg.pad_to_block, cfg.dancing)
            != (stored_cfg.pad_to_line, stored_cfg.pad_to_block,
                stored_cfg.dancing)
        ):
            raise ValueError(f"log {name!r}: cfg conflicts with the durable "
                             f"directory record")
        cls = LOG_TECHNIQUES[stored_tech]
        writer, recovered = cls.open_for_append(self.pmem, rec.base,
                                                rec.length, stored_cfg)
        return LogHandle(self, rec, stored_tech, stored_cfg, writer, recovered)

    def pages(self, name: str, npages: Optional[int] = None,
              page_size: Optional[int] = None, *,
              nslots: Optional[int] = None, n_mulogs: int = 1,
              threads: int = 1, socket: Optional[int] = None) -> PagesHandle:
        """Open-or-create a named failure-atomic page region (slot array +
        µlogs). Geometry-tagged via the pool; on open, the slot table is
        rebuilt from slot headers and valid µlogs are replayed.

        Passing ``nslots <= npages`` creates an *overcommitted* region:
        the PMem slot array holds fewer slots than logical pages and a
        :class:`repro_torch.tier.SpillScheduler` must stand behind it to evict
        cold slots to SSD before CoW runs out (on reopen, overcommit is
        inferred from the durable geometry)."""
        rec = self.directory.lookup(name)
        if rec is None:
            if npages is None or page_size is None:
                raise ValueError(
                    f"creating pages {name!r} requires npages= and page_size=")
            nslots = nslots if nslots is not None else npages + max(2, npages // 4)
            layout = PageStoreLayout(base=0, page_size=page_size,
                                     npages=npages, nslots=nslots,
                                     geometry=self.geometry,
                                     overcommit=nslots <= npages)
            length = PageStore.region_bytes(layout, n_mulogs=n_mulogs)
            rec = self.directory.allocate(
                name, KIND_PAGES, length,
                (page_size, npages, nslots, n_mulogs),
                socket=socket or 0)
            layout = dataclasses.replace(layout, base=rec.base)
            store = PageStore(self.pmem, layout, n_mulogs=n_mulogs,
                              threads=threads)
            return PagesHandle(self, rec, store)

        rec = self.directory.require(name, KIND_PAGES)
        m_page, m_npages, m_nslots, m_mulogs = rec.meta
        m_mulogs &= 0xFFFF            # high bits carry the socket tag
        for arg, stored, what in ((npages, m_npages, "npages"),
                                  (page_size, m_page, "page_size"),
                                  (nslots, m_nslots, "nslots"),
                                  (socket, rec.socket, "socket")):
            if arg is not None and arg != stored:
                raise ValueError(f"pages {name!r}: {what}={arg} conflicts "
                                 f"with durable record ({stored})")
        layout = PageStoreLayout(base=rec.base, page_size=m_page,
                                 npages=m_npages, nslots=m_nslots,
                                 geometry=self.geometry,
                                 overcommit=m_nslots <= m_npages)
        store = PageStore.open(self.pmem, layout, n_mulogs=m_mulogs,
                               threads=threads)
        return PagesHandle(self, rec, store)

    def pages_layout(self, name: str) -> PageStoreLayout:
        """The durable layout of an existing pages region, without opening
        it (opening replays µlogs; verification passes may need the image
        untouched first)."""
        rec = self.directory.require(name, KIND_PAGES)
        m_page, m_npages, m_nslots, _ = rec.meta
        return PageStoreLayout(base=rec.base, page_size=m_page,
                               npages=m_npages, nslots=m_nslots,
                               geometry=self.geometry,
                               overcommit=m_nslots <= m_npages)

    def raw(self, name: str, nbytes: Optional[int] = None, *,
            socket: Optional[int] = None) -> RawHandle:
        """Open-or-create a named untyped region (``socket`` tags its NUMA
        home when creating; on open, a conflicting value raises — like
        :meth:`log` and :meth:`pages`, home sockets are fixed at
        creation)."""
        rec = self.directory.lookup(name)
        if rec is None:
            if nbytes is None:
                raise ValueError(f"creating raw {name!r} requires nbytes=")
            rec = self.directory.allocate(
                name, KIND_RAW, align_up(nbytes, self.geometry.block),
                socket=socket or 0)
        else:
            rec = self.directory.require(name, KIND_RAW)
            if nbytes is not None and nbytes > rec.length:
                raise ValueError(f"raw {name!r} holds {rec.length} B, "
                                 f"wanted {nbytes}")
            if socket is not None and socket != rec.socket:
                raise ValueError(
                    f"raw {name!r} lives on socket {rec.socket}, caller "
                    f"asked for {socket} — home sockets are fixed at "
                    f"creation")
        return RawHandle(self, rec)

    # ------------------------------------------------------- SSD tier

    def attach_ssd(self, ssd: SSD) -> SSD:
        """Attach the flash device backing this pool's ``KIND_SSD`` regions.

        The attachment is volatile (like the PMem object itself): on
        reopen after a crash, attach the device again before opening any
        SSD region handle. Returns the device for chaining."""
        if self.ssd_dev is not None and self.ssd_dev is not ssd:
            raise ValueError("pool already has an attached SSD device")
        end = self.directory.ssd_data_end
        if end > ssd.size:
            raise ValueError(
                f"directory has {end} B of committed SSD regions but the "
                f"attached device holds only {ssd.size} B")
        self.ssd_dev = ssd
        return ssd

    def ssd_region(self, name: str, nbytes: Optional[int] = None,
                   socket: Optional[int] = None) -> SSDRegionHandle:
        """Open-or-create a named SSD-backed region (``KIND_SSD``).

        Requires an attached device (:meth:`attach_ssd`). Creation
        bump-allocates ``nbytes`` of the SSD address space and commits the
        binding as a single-line directory entry; the SSD bytes are not
        zeroed (consumers gate reads on their own validity metadata).
        ``socket`` tags the region's NUMA home (the socket whose I/O
        complex the device hangs off — the cache's fill-socket
        accounting reads it back); like :meth:`log` and :meth:`pages`,
        home sockets are fixed at creation and a conflicting open
        raises."""
        if self.ssd_dev is None:
            raise RuntimeError(
                f"SSD region {name!r} needs a device: call "
                f"pool.attach_ssd(SSD(...)) first")
        rec = self.directory.lookup(name)
        if rec is None:
            if nbytes is None:
                raise ValueError(f"creating SSD region {name!r} requires "
                                 f"nbytes=")
            rec = self.directory.allocate_ssd(name, int(nbytes),
                                              self.ssd_dev.size,
                                              socket=socket or 0)
        else:
            rec = self.directory.require(name, KIND_SSD)
            if nbytes is not None and nbytes > rec.length:
                raise ValueError(f"SSD region {name!r} holds {rec.length} B, "
                                 f"wanted {nbytes}")
            if socket is not None and socket != rec.socket:
                raise ValueError(
                    f"SSD region {name!r} lives on socket {rec.socket}, "
                    f"caller asked for {socket} — home sockets are fixed "
                    f"at creation")
        return SSDRegionHandle(self, rec, self.ssd_dev)

    # --------------------------------------------------- typed consumers

    def kv(self, name: str, cfg=None):
        """The KV engine (``repro.core.recovery.PersistentKV``) is not
        ported yet (ROADMAP.md, queue 1, item 1)."""
        raise NotImplementedError(
            "Pool.kv: PersistentKV is not ported to repro_torch yet "
            "(ROADMAP.md, queue 1, item 1)")

    def wal(self, name: str = "train_wal", *,
            capacity_steps: Optional[int] = None,
            technique: Optional[str] = None,
            lanes: int = 1, group_commit: int = 1,
            gen_sets: int = 1):
        """Open-or-create a training step WAL
        (:class:`~repro_torch.persistence.wal.TrainWAL`) on this pool.
        ``technique`` defaults to "zero" when creating; on open the durable
        record decides (passing one verifies it). ``lanes > 1`` runs the
        WAL on a lane-striped group-commit :class:`~repro_torch.io.MultiLog`;
        ``gen_sets >= 2`` additionally makes that MultiLog generational
        (a ring of lane sets that :meth:`TrainWAL.roll` seals, so the
        step WAL can be truncated at checkpoints instead of only at
        restart)."""
        from repro_torch.persistence.wal import TrainWAL
        return TrainWAL.on_pool(self, name, capacity_steps=capacity_steps,
                                technique=technique, lanes=lanes,
                                group_commit=group_commit,
                                gen_sets=gen_sets)

    def multilog(self, name: str, capacity: Optional[int] = None, *,
                 lanes: Optional[int] = None,
                 technique: Optional[str] = None,
                 group_commit: int = 8,
                 cfg: Optional[LogConfig] = None,
                 gen_sets: int = 1,
                 lane_sockets: Optional[Sequence[int]] = None,
                 placer=None):
        """Open-or-create a lane-striped group-commit log
        (:class:`~repro_torch.io.MultiLog`) over regions ``<name>.lane<i>``.
        Creating requires ``capacity`` (total, split over ``lanes``);
        opening discovers the lanes from the directory and runs merged
        recovery automatically. ``lane_sockets`` pins each lane region's
        NUMA home socket at creation (default: the placer spreads them);
        ``placer`` overrides the pool's default lane placer."""
        from repro_torch.io.multilog import MultiLog
        return MultiLog(self, name, lanes=lanes, capacity=capacity,
                        technique=technique, group_commit=group_commit,
                        cfg=cfg, gen_sets=gen_sets,
                        lane_sockets=lane_sockets, placer=placer)
