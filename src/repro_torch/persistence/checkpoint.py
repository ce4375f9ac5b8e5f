"""Sharded, failure-atomic, delta-capable checkpoint manager.

Every host writes its own shard region (no cross-device funnel — at 1000+
nodes the durable tier must be written in parallel). Within a shard:

  state leaf  →  fixed-size *pages*  →  PageStore slots (CoW + pvn)
                                     ↘  µLog shadow-slot deltas when sparse
  manifest    →  Zero log            (ONE barrier commits the checkpoint)

Consistency story (the non-trivial part):

* Every page keeps **two** slots once it has been flushed twice: *current*
  (version v) and *shadow* (v-1). A full flush CoWs into a free slot; a
  delta flush µLogs the changed blocks **onto the shadow slot** — never in
  place — so the page set referenced by the last *committed* manifest stays
  physically intact no matter where a crash lands. (The paper's in-place
  µLog is correct for a buffer manager, where only the newest page version
  matters; a checkpoint must restore a *consistent cut*, hence the shadow
  variant. Recorded in DESIGN.md §7.)
* The manifest entry (step, page→(slot, pvn), checksums) is appended to a
  Zero log: the checkpoint becomes durable with a single persistency
  barrier, and recovery picks the last manifest whose pages still verify
  (slot pvn match + popcount checksum — the same validity argument as
  Zero logging, at page scale).
* Dirtiness is *computed*, not intercepted: the fused ``flush_pack``
  CUDA kernel compares the live tensor, in place on the card, against the
  last-flushed snapshot in 4 KiB blocks and, in the same device pass,
  emits the per-block popcount checksums and the prefix-sum-compacted
  dirty block ids (``kernel_impl="staged"`` keeps the pre-fusion
  dirty_diff → popcnt → compaction chain for A/B runs and crash-parity
  checks). Only the snapshot moves host→device, and the live bytes move
  device→host once, for the page build.
  ``HybridPolicy`` (threads-aware, §3.2.3) picks CoW vs µLog per page.
  A delta onto the shadow slot must cover the change since v-1, so the
  dirty set is the union of the last two saves' dirty blocks.
* The last-flushed snapshot lives in the pool's DRAM buffer manager
  (``pool.cache``), one clean frame per page, written through
  :meth:`~repro_torch.cache.BufferManager.writeback` — the save epoch leaves
  each frame holding exactly the bytes it flushed. Bounding the frame
  pool (``CheckpointConfig.cache_frames``) bounds the manager's DRAM
  footprint: a leaf whose snapshot frames were evicted degrades to a
  full-page rewrite on its next save (correct, merely conservative).

The port of ``repro.persistence.checkpoint``: the same pool layout,
manifests and reports, byte for byte, so either package restores the
other's checkpoints. State is a flat ``{name: torch.Tensor}`` dict on the
manager's device; restore returns tensors there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import BlockGeometry, TPU_TILE, align_up
from repro_torch.core.costmodel import PMemCostModel
from repro_torch.core.log import LogConfig
from repro_torch.core.pageflush import HybridPolicy, PageStore, PageStoreLayout
from repro_torch.core.persist import AccessPattern, FlushKind
from repro_torch.core.pmem import PMem, PMemStats
from repro_torch.pool import LogHandle, PagesHandle, Pool
from repro_torch.kernels.apply_unpack import apply_unpack
from repro_torch.kernels.dirty_diff import dirty_blocks
from repro_torch.kernels.flush_pack import compact_index, flush_pack
from repro_torch.kernels.popcnt_checksum import popcount_blocks
from repro_torch.persistence.state import dtype_name, torch_dtype

__all__ = ["CheckpointConfig", "CheckpointManager", "RestoreReport",
           "SaveReport"]

#: checkpoint geometry: dirty unit = 4 KiB TPU tile, write granule = 16 KiB
#: (kept on the card: the pool superblock records it, so the two packages'
#: checkpoints stay interchangeable)
CKPT_GEOMETRY = BlockGeometry(cache_line=TPU_TILE, block=4 * TPU_TILE)

#: spill-map log capacity per buffer for a tiered shard — 4 KiB lines pad
#: each map record to a line, so the maps need real capacity; referenced by
#: the pool sizing AND every SpillScheduler construction, which must agree
_SPILL_MAP_CAPACITY = 1 << 20


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    page_size: int = 256 * 1024
    manifest_capacity: int = 1 << 20
    delta: bool = True               # enable µLog shadow-slot deltas
    threads: int = 1                 # writer threads (G4: bounded; feeds policy)
    #: scan-kernel dispatch, BOTH directions. Save:
    #: "auto"/"fused"/"pallas" run the one-pass flush_pack CUDA kernel on
    #: a CUDA device (the plain version on the CPU), "ref" the plain
    #: version anywhere; "staged" keeps the
    #: pre-fusion dirty_diff → popcnt → compaction chain (three
    #: live-buffer reads) for A/B benchmarks and the crash corpus'
    #: byte-parity case. Restore: the same values route the one-pass
    #: apply_unpack kernel (verify+scatter+apply, one read of the
    #: restored image) vs the staged popcount-verify → copy chain (two
    #: reads) — staged and fused recover bit-identical state.
    kernel_impl: str = "auto"
    extra_slots: int = 4             # beyond the 2-per-page steady state
    #: PMem page-slot budget for the shard. None = classic sizing (two
    #: slots per page: current + shadow). A smaller budget makes the
    #: save epoch *spill*: cold slots overflow to the shard's SSD device
    #: instead of the pool allocation failing, and manifests record the
    #: spilled pages' SSD residence so restore still verifies end-to-end.
    pmem_slot_budget: Optional[int] = None
    #: SSD device size auto-created per shard when a budget is set and no
    #: device is passed to the manager
    ssd_bytes: int = 1 << 28
    #: NUMA sockets of the host this shard's pool models (recorded in the
    #: pool superblock; the flush epoch's lanes then run near the shard's
    #: home socket via the pool's LanePlacer)
    sockets: int = 1
    #: home socket of this shard's regions. None = ``shard_id % sockets``
    #: (AsyncFlusher interleaves its shards across the sockets)
    socket: Optional[int] = None
    #: DRAM buffer-manager frames holding the last-flushed snapshots.
    #: None = one frame per page (full snapshot set — every delta save
    #: diffs against DRAM, the classic behavior). A smaller value bounds
    #: the shard's DRAM footprint; evicted snapshots degrade that leaf's
    #: next save to a full rewrite.
    cache_frames: Optional[int] = None
    #: k-touch SSD→PMem promotion threshold for the shard's pages
    cache_admit_k: int = 2

    @property
    def geometry(self) -> BlockGeometry:
        return CKPT_GEOMETRY

    @property
    def blocks_per_page(self) -> int:
        return self.page_size // self.geometry.cache_line


@dataclasses.dataclass
class SaveReport:
    step: int
    pages_total: int = 0
    pages_cow: int = 0
    pages_mulog: int = 0
    pages_clean: int = 0
    bytes_logical: int = 0          # checkpoint state size
    barriers: int = 0
    blocks_written: int = 0
    modeled_ns: float = 0.0
    #: flush lanes actually active in this save's epoch drain
    active_lanes: int = 1
    #: cold PMem slots evicted to SSD during this save's epoch
    pages_spilled: int = 0
    #: modeled SSD time of those evictions (overlappable with PMem work)
    spill_ns: float = 0.0
    #: device (HBM) bytes the save's scan kernels read — one live-buffer
    #: pass with the fused flush_pack kernel, up to three when staged
    scan_read_bytes: int = 0
    #: modeled device time of that scan traffic (included in modeled_ns)
    scan_ns: float = 0.0

    @property
    def bytes_device(self) -> int:
        return self.blocks_written * CKPT_GEOMETRY.block


@dataclasses.dataclass
class RestoreReport:
    """What one :meth:`CheckpointManager.restore` did — the read-side
    mirror of :class:`SaveReport`. ``restore_read_bytes`` is the device
    bytes the restore scan read over every attempted manifest entry: one
    pass over the packed page images with the fused ``apply_unpack``
    kernel, two (verify + copy) when staged. ``scan_ns`` prices that
    traffic alone; ``modeled_ns`` folds it into the pool's full delta
    via ``engine_time_ns(scan_read_bytes=)``."""

    step: int = -1
    #: manifest entries walked (newest-first) before one verified
    entries_tried: int = 0
    pages_total: int = 0
    #: pages read back through the SSD spill map rather than PMem slots
    pages_spilled: int = 0
    restore_read_bytes: int = 0
    scan_ns: float = 0.0
    modeled_ns: float = 0.0
    kernel_impl: str = "auto"


class CheckpointManager:
    """Checkpoint manager for one shard (one host's slice of the state).

    State is a flat ``{name: torch.Tensor}`` dict with a stable key set,
    on the manager's device. The scans run there, on the live tensors in
    place; the page build and the PMem model run on the host (guideline
    G5 — the device-side dirty computation is the only on-device work).
    """

    def __init__(self, path: Optional[str], cfg: CheckpointConfig = CheckpointConfig(),
                 *, shard_id: int = 0, ssd=None, device="cuda",
                 cost_model: PMemCostModel) -> None:
        """``path`` backs the shard's pool file (``None`` = in-memory);
        ``ssd`` is the shard's flash device when ``cfg.pmem_slot_budget``
        turns on the spill tier (auto-created in memory if omitted).
        ``device`` is where saved tensors lie and restored ones go: a CUDA
        device unless the caller asks for the CPU; without a card,
        ``"cuda"`` raises. ``cost_model`` prices the reports, and its
        ``hbm_read_bw_gbps`` is the device's read rate (no default: the
        caller states the card's figure)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CheckpointManager(device='cuda'): no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        self.cost_model = cost_model
        self.cfg = cfg
        self.path = path
        self.shard_id = shard_id
        #: NUMA home socket of this shard's regions (settable until the
        #: first save builds the pool — AsyncFlusher interleaves shards)
        self.home_socket = (cfg.socket if cfg.socket is not None
                            else shard_id % max(1, cfg.sockets))
        self._ssd = ssd
        self._spill = None
        self._spilled_pvn: Dict[int, int] = {}   # evicted pid -> pvn on SSD
        self.pool: Optional[Pool] = None
        self.pmem: Optional[PMem] = None
        self.store: Optional[PageStore] = None
        self.manifest: Optional[LogHandle] = None
        self._pages: Optional[PagesHandle] = None
        self._flushq = None                           # repro_torch.io.FlushQueue
        self._epoch_report: Optional[SaveReport] = None
        self._epoch_prev_dirty: Dict[int, set] = {}
        self._layout: Optional[PageStoreLayout] = None
        self._cache = None                            # pool's BufferManager
        self._leaf_pages: Dict[str, List[int]] = {}
        self._leaf_meta: Dict[str, Dict[str, Any]] = {}
        self._prev_dirty: Dict[int, set] = {}         # page -> dirty lines of last save
        self._shadow: Dict[int, int] = {}             # page -> shadow slot
        self._manifest_base = 0
        self._saves = 0
        #: accounting of the most recent :meth:`restore` (None before one)
        self.last_restore: Optional[RestoreReport] = None
        self._restore_read_bytes = 0
        self._restore_pages_spilled = 0

    # ----------------------------------------------------------- layout

    @staticmethod
    def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
        """Flat uint8 view of a leaf's bytes where it lies (no copy for a
        contiguous tensor)."""
        return t.contiguous().reshape(-1).view(torch.uint8)

    def _check_state(self, state: Dict[str, torch.Tensor]) -> None:
        for name, t in state.items():
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"leaf {name!r}: expected a torch.Tensor, "
                                f"got {type(t).__name__}")
            if t.device.type != self.device.type:
                raise ValueError(f"leaf {name!r} lies on {t.device}; this "
                                 f"manager runs on {self.device}")

    def _build(self, state: Dict[str, torch.Tensor]) -> None:
        cfg, g = self.cfg, self.cfg.geometry
        pid = 0
        for name in sorted(state):
            t = state[name]
            nbytes = t.numel() * t.element_size()
            npages = max(1, -(-nbytes // cfg.page_size))
            self._leaf_pages[name] = list(range(pid, pid + npages))
            self._leaf_meta[name] = {
                "shape": list(t.shape),
                "dtype": dtype_name(t.dtype),
                "nbytes": int(nbytes),
            }
            pid += npages
        npages = pid
        if cfg.pmem_slot_budget is not None:
            nslots = int(cfg.pmem_slot_budget)
        else:
            nslots = 2 * npages + cfg.extra_slots
        tiered = nslots <= 2 * npages and cfg.pmem_slot_budget is not None
        sizing = PageStoreLayout(base=0, page_size=cfg.page_size,
                                 npages=npages, nslots=nslots, geometry=g,
                                 overcommit=nslots <= npages)
        spill_bytes = 0
        if tiered:
            # spill map double buffer + ping-pong head (4 KiB lines pad
            # each map record to a line, so the maps need real capacity)
            spill_bytes = 2 * (_SPILL_MAP_CAPACITY + g.block) \
                + align_up(2 * g.cache_line, g.block)
        total = (Pool.overhead_bytes(g, max_regions=16)
                 + align_up(cfg.manifest_capacity, g.block)
                 + PageStore.region_bytes(sizing, n_mulogs=cfg.threads)
                 + spill_bytes + 2 * g.block)
        self.pool = Pool.create(self.path, total, geometry=g, max_regions=16,
                                sockets=cfg.sockets)
        self.pmem = self.pool.pmem
        home = min(self.home_socket, max(1, cfg.sockets) - 1)
        self.manifest = self.pool.log(
            "manifest", capacity=cfg.manifest_capacity, technique="zero",
            cfg=LogConfig(geometry=g, pad_to_line=True), socket=home)
        self._pages = self.pool.pages(
            "pages", npages=npages, page_size=cfg.page_size, nslots=nslots,
            n_mulogs=cfg.threads, threads=cfg.threads, socket=home)
        self.store = self._pages.store
        self._layout = self._pages.layout
        if tiered:
            self._spill = self._make_spill()
        self._flushq = self._pages.flush_queue(
            lanes=cfg.threads, flush_fn=self._engine_flush_page)
        self._flushq.spill = self._spill
        self._flushq.cost_model = self.cost_model
        self._cache = self._pool_cache(npages)
        self._cache.attach_pages(self._pages, flushq=self._flushq,
                                 spill=self._spill)

    def _pool_cache(self, npages: int):
        """The shard pool's buffer manager: explicit ``cache_frames`` /
        ``cache_admit_k`` are verified against any pre-existing pool
        cache (conflict raises); default-configured shards reuse one
        quietly, or create the full snapshot set (a frame per page)."""
        from repro_torch.cache import BufferManager
        cfg = self.cfg
        return BufferManager.for_pool(
            self.pool, frames=cfg.cache_frames,
            admit_k=None
            if cfg.cache_admit_k == CheckpointConfig.cache_admit_k
            else cfg.cache_admit_k,
            default_frames=npages, default_admit_k=cfg.cache_admit_k)

    def _make_spill(self):
        """The shard's spill scheduler (creates the SSD device if none
        was passed) — the save epoch feeds it, restore reads through it."""
        from repro_torch.core.ssd import SSD
        from repro_torch.tier import SpillScheduler
        if self._ssd is None:
            self._ssd = SSD(self.cfg.ssd_bytes)
        self.pool.attach_ssd(self._ssd)
        spill = SpillScheduler(self.pool, name="sp", map_capacity=_SPILL_MAP_CAPACITY)
        spill.attach_pages(self._pages, on_evict=self._on_page_evicted)
        return spill

    def _on_page_evicted(self, pid: int) -> None:
        """Spill-tier callback: a pid's *current* slot left PMem. Drop
        the shadow bookkeeping that referenced PMem slots (the shadow
        slot is freed — its stale durable header loses the cross-tier
        max-pvn rule) and pin the SSD-resident version for the next
        manifest."""
        self._spilled_pvn[pid] = self.store.pvn_floor.get(pid, 0)
        shadow = self._shadow.pop(pid, None)
        if shadow is not None:
            self.store.free.append(shadow)
        self._prev_dirty.pop(pid, None)

    # ------------------------------------------------------------- save

    def _note_scan(self, nbytes: int) -> None:
        """Attribute save-scan HBM traffic to the epoch being built (the
        flush queue folds it into the epoch's modeled time)."""
        if self._flushq is not None:
            self._flushq.note_scan(nbytes)

    def _dirty_lines_per_page(
        self, name: str, cur: torch.Tensor,
    ) -> Tuple[Optional[Dict[int, set]], np.ndarray, np.ndarray]:
        """One fused device pass (flush_pack kernel) over the live tensor
        where it lies: dirty (page → line set) vs the snapshot (None =
        everything dirty) AND per-block popcounts for the page checksums.
        Only the snapshot moves to the device; only ``index[:total]`` and
        ``counts`` come back (never ``packed``), plus the live bytes
        once for the page build. ``kernel_impl="staged"`` runs the
        pre-fusion chain instead (dirty_diff + popcnt + the shared
        compaction), reading the live buffer thrice."""
        dbuf = self._leaf_bytes(cur)
        snap = self._leaf_snapshot(name)
        cl = self.cfg.geometry.cache_line
        impl = self.cfg.kernel_impl
        if snap is None or not self.cfg.delta:
            counts = popcount_blocks(
                dbuf, block_bytes=cl,
                impl="auto" if impl in ("fused", "staged") else impl)
            buf = dbuf.cpu().numpy()
            self._note_scan(buf.size)   # full rewrite: one pass, no diff
            return None, buf, counts.cpu().numpy()
        dsnap = torch.from_numpy(snap).to(self.device)
        if impl == "staged":
            flags = dirty_blocks(dbuf, dsnap, block_bytes=cl)
            counts = popcount_blocks(dbuf, block_bytes=cl)
            index, k = compact_index(flags)
            dirty_idx = index[:k].cpu().numpy()
            # dirty_diff read the live bytes, popcnt read them again, and
            # the delta gather re-reads each dirty block
            self._note_scan(2 * dbuf.numel() + k * cl)
        else:
            fp = flush_pack(dbuf, dsnap, block_bytes=cl, impl=impl)
            dirty_idx = fp.index[: fp.total].cpu().numpy()
            counts = fp.counts
            self._note_scan(dbuf.numel())   # the whole point: one pass
        per_page: Dict[int, set] = {}
        lpp = self.cfg.blocks_per_page
        for b in dirty_idx.tolist():
            per_page.setdefault(b // lpp, set()).add(b % lpp)
        return per_page, dbuf.cpu().numpy(), counts.cpu().numpy()

    def _leaf_snapshot(self, name: str) -> Optional[np.ndarray]:
        """Last-flushed bytes of a leaf, reassembled from the buffer
        manager's frames (one clean frame per page after each save's
        write-back). ``None`` — the full-rewrite path — when any page's
        snapshot frame was evicted, or before the leaf's first save."""
        if self._cache is None:
            return None
        cfg = self.cfg
        pids = self._leaf_pages[name]
        out = np.empty(len(pids) * cfg.page_size, dtype=np.uint8)
        for i, pid in enumerate(pids):
            frame = self._cache.peek(pid, self.store)
            if frame is None:
                return None
            out[i * cfg.page_size : (i + 1) * cfg.page_size] = frame
        return out[: self._leaf_meta[name]["nbytes"]]

    def save(self, step: int, state: Dict[str, torch.Tensor]) -> SaveReport:
        self._check_state(state)
        if self.pmem is None:
            self._build(state)
        assert self.store is not None and self.manifest is not None
        if set(state) != set(self._leaf_pages):
            raise ValueError("state keys changed between saves")
        cfg = self.cfg
        before: PMemStats = self.pmem.stats.snapshot()
        report = SaveReport(step=step)
        entry: Dict[str, Any] = {"step": step, "shard": self.shard_id, "leaves": {}}

        # Pass 1 — dirty scan + page build: clean pages keep their slot,
        # dirty pages are enqueued on the engine's flush queue.
        self._epoch_report = report
        self._epoch_prev_dirty = {}
        leaf_checks: Dict[str, List[int]] = {}
        for name in sorted(state):
            per_page, buf, counts = self._dirty_lines_per_page(name, state[name])
            report.bytes_logical += buf.size
            pages = self._leaf_pages[name]
            lpp = cfg.blocks_per_page
            checks = []
            for i, pid in enumerate(pages):
                lo = i * cfg.page_size
                page = np.zeros(cfg.page_size, dtype=np.uint8)
                chunk = buf[lo : lo + cfg.page_size]
                page[: chunk.size] = chunk
                report.pages_total += 1
                # page checksum from the fused scan's per-block popcounts
                # (zero padding beyond the leaf contributes 0 bits)
                blk = counts[i * lpp : (i + 1) * lpp]
                checks.append(int((int(blk.sum(dtype=np.uint64)) + 1) & 0xFFFFFFFF))
                if per_page is None:
                    # first save / no delta: full rewrite, forced CoW
                    self._cache.put(pid, page, None, store=self.store)
                    continue
                dirty = per_page.get(i, set())
                if not dirty:
                    report.pages_clean += 1   # previous version still valid
                    continue
                self._cache.put(pid, page, sorted(dirty), store=self.store)
            leaf_checks[name] = checks

        # Pass 2 — the buffer manager's write-back: one lane-partitioned
        # epoch drains every dirty frame (pinned for the duration); the
        # Hybrid µLog-vs-CoW decision sees the epoch's ACTUAL active-lane
        # count, not the constructor's thread constant. The frames stay
        # resident holding exactly the flushed bytes — the next save's
        # dirty-diff snapshots.
        epoch = self._cache.writeback(self.store)
        report.active_lanes = max(1, epoch.active_lanes)
        report.pages_spilled = epoch.pages_spilled
        report.spill_ns = epoch.spill_ns
        report.scan_read_bytes = epoch.scan_read_bytes
        report.scan_ns = epoch.scan_ns
        self._prev_dirty.update(self._epoch_prev_dirty)

        # Pass 3 — manifest records from the post-epoch page table. A
        # page whose slot spilled during the epoch is recorded with
        # slot -1 and its SSD-resident pvn: restore reads it back through
        # the spill map (same checksum verification, different tier).
        for name in sorted(state):
            page_records = [self._page_record(pid)
                            for pid in self._leaf_pages[name]]
            entry["leaves"][name] = dict(
                self._leaf_meta[name], pages=page_records,
                checksums=leaf_checks[name])

        # commit: one Zero-log barrier makes the whole checkpoint durable
        self.manifest.append(json.dumps(entry).encode())
        self.pmem.fsync()
        self._saves += 1
        delta = self.pmem.stats.delta(before)
        report.barriers = delta.barriers
        report.blocks_written = delta.blocks_written
        report.modeled_ns = self.cost_model.engine_time_ns(
            delta, active_lanes=report.active_lanes, kind=FlushKind.NT,
            pattern=AccessPattern.SEQUENTIAL, burst=True,
            scan_read_bytes=report.scan_read_bytes)
        return report

    def _page_record(self, pid: int) -> List[int]:
        """Manifest record for one page: ``[pid, slot, pvn]`` when PMem-
        resident, ``[pid, -1, pvn]`` when its current version lives on
        the shard's SSD tier."""
        rec = self.store.table.get(pid)
        if rec is not None:
            return [pid, rec[0], rec[1]]
        return [pid, -1, self._spilled_pvn[pid]]

    def _engine_flush_page(self, pid: int, page: np.ndarray,
                           dirty: Optional[List[int]], active: int) -> str:
        """``flush_fn`` for the save epoch's flush queue: the shadow-slot
        protocol of :meth:`_flush_page` with the Hybrid decision taken at
        the epoch's actual active-lane count."""
        force_cow = dirty is None
        lines = list(range(self.cfg.blocks_per_page)) if force_cow else list(dirty)
        tech = self._flush_page(pid, page, lines, force_cow,
                                self._epoch_report, threads=active)
        self._epoch_prev_dirty[pid] = set(lines)
        return tech

    def _flush_page(self, pid: int, page: np.ndarray, dirty: List[int],
                    force_cow: bool, report: SaveReport, *,
                    threads: Optional[int] = None) -> str:
        store = self.store
        t = self.cfg.threads if threads is None else threads
        shadow = self._shadow.get(pid)
        use_mulog = (
            not force_cow
            and self.cfg.delta
            and shadow is not None
            and pid in store.table
            and store.policy.prefer_mulog(
                len(set(dirty) | self._prev_dirty.get(pid, set())), t)
        )
        if use_mulog:
            # shadow-slot delta must cover change since v-1 = union of the
            # last two saves' dirty sets
            lines = sorted(set(dirty) | self._prev_dirty.get(pid, set()))
            old_current = store.table[pid][0]
            store.flush_mulog(pid, page, lines, target_slot=shadow)
            self._shadow[pid] = old_current
            report.pages_mulog += 1
            return "mulog"
        old = store.table.get(pid)
        store.flush_cow(pid, page, retire_old=False)
        if old is not None:
            prev_shadow = self._shadow.get(pid)
            if prev_shadow is not None:
                store.free.append(prev_shadow)   # v-2 slot is released
            self._shadow[pid] = old[0]
        report.pages_cow += 1
        return "cow"

    # ---------------------------------------------------------- restore

    def restore(self, *, path: Optional[str] = None,
                verify: bool = True) -> Tuple[int, Dict[str, torch.Tensor]]:
        """Recover the newest committed checkpoint that verifies.

        Walks manifest entries newest-first; for each, checks every page's
        slot header still carries the recorded (pid, pvn) and the page data
        matches the recorded popcount checksum. Falls back to older
        manifests if a newer one was partially overwritten (can only happen
        beyond the double-buffer guarantee, but verification is cheap
        insurance at restore time).

        Checksum verification and image assembly run as ONE device pass
        per leaf through the fused ``apply_unpack`` kernel (the inverse
        of the save scan's ``flush_pack``): the packed pages move to the
        device once and the assembled leaf stays there.
        ``cfg.kernel_impl="staged"`` keeps the pre-fusion
        verify-then-copy chain, which reads the restored bytes twice.
        Either way the read traffic and modeled
        time land in :attr:`last_restore` (a :class:`RestoreReport`)."""
        path = path or self.path
        cfg = self.cfg
        if self.pool is None:
            if path is None:
                raise ValueError("nothing to restore from")
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            self.pool = Pool.open(path)
            self.pmem = self.pool.pmem
            self.manifest = self.pool.log("manifest")
        if cfg.pmem_slot_budget is not None and self._spill is None:
            from repro_torch.tier import SpillScheduler
            if self._ssd is None:
                raise ValueError(
                    "this shard was saved with a PMem slot budget — its "
                    "cold pages live on SSD; pass the shard's SSD device "
                    "to CheckpointManager(ssd=...) before restoring")
            self.pool.attach_ssd(self._ssd)
            self._spill = SpillScheduler(self.pool, name="sp",
                                         map_capacity=_SPILL_MAP_CAPACITY)
        rec = self.manifest.recover()
        if not rec.entries:
            raise FileNotFoundError("no committed checkpoint manifest")
        # layout from the durable directory record — deliberately without
        # opening the page store (that would replay µlogs before the
        # manifests are verified against the untouched image)
        self._layout = self.pool.pages_layout("pages")
        img = self.pmem.durable_view()
        before: PMemStats = self.pmem.stats.snapshot()
        report = RestoreReport(kernel_impl=cfg.kernel_impl)
        self._restore_read_bytes = 0
        self._restore_pages_spilled = 0
        for raw in reversed(rec.entries):
            entry = json.loads(raw.decode())
            report.entries_tried += 1
            state = self._try_restore_entry(entry, img, verify)
            if state is not None:
                self._adopt(entry, state)
                report.step = entry["step"]
                report.pages_total = sum(
                    len(meta["pages"]) for meta in entry["leaves"].values())
                report.pages_spilled = self._restore_pages_spilled
                report.restore_read_bytes = self._restore_read_bytes
                report.scan_ns = self.cost_model.scan_read_ns(
                    report.restore_read_bytes)
                report.modeled_ns = self.cost_model.engine_time_ns(
                    self.pmem.stats.delta(before),
                    active_lanes=max(1, cfg.threads),
                    scan_read_bytes=report.restore_read_bytes)
                self.last_restore = report
                return entry["step"], state
        raise RuntimeError("no manifest entry verifies — checkpoint corrupt")

    def _try_restore_entry(self, entry: Dict[str, Any], img: np.ndarray,
                           verify: bool) -> Optional[Dict[str, torch.Tensor]]:
        """One manifest entry → recovered state, or None if it no longer
        verifies. The slot-header checks are host-side (a 12-byte unpack
        per page); the data work — checksum verification + image
        assembly — is one fused ``apply_unpack`` pass per leaf, or the
        staged verify-then-copy chain under ``kernel_impl="staged"``."""
        import struct as _s
        cfg = self.cfg
        state: Dict[str, torch.Tensor] = {}
        layout = self._layout
        # ``page_size % 128`` is the TPU's lane-layout rule (a page must be
        # whole rows of 128 lanes for the Pallas kernel); it means nothing
        # on the card and stays only so the RestoreReport matches the JAX
        # package's
        staged = cfg.kernel_impl == "staged" or cfg.page_size % 128 != 0
        for name, meta in entry["leaves"].items():
            pages: List[Optional[np.ndarray]] = []
            spilled: List[Tuple[int, int, int]] = []   # (pos, pid, pvn)
            for i, (pid, slot, pvn) in enumerate(meta["pages"]):
                if slot == -1:
                    # SSD-resident page: the manifest pinned its pvn; the
                    # spill map must still hold exactly that version
                    if self._spill is None:
                        return None
                    spilled.append((i, pid, pvn))
                    pages.append(None)
                    continue
                hdr_pid, hdr_pvn = _s.unpack_from("<IQ", img,
                                                  layout.slot_off(slot))
                if hdr_pid != pid or hdr_pvn != pvn:
                    return None   # slot was reused; not restorable
                off = layout.slot_data_off(slot)
                pages.append(img[off : off + cfg.page_size])
            if spilled:
                try:
                    got = self._spill.read_spilled_many(
                        "pages", [(pid, pvn) for _, pid, pvn in spilled])
                except (KeyError, RuntimeError):
                    return None
                for (pos, _, _), page in zip(spilled, got):
                    pages[pos] = page
                self._restore_pages_spilled += len(spilled)
            csums = meta["checksums"]
            if staged:
                buf = self._staged_assemble(pages, csums, verify)
            else:
                buf = self._fused_assemble(pages, csums, verify)
            if buf is None:
                return None
            arr = buf[: meta["nbytes"]].view(torch_dtype(meta["dtype"]))
            state[name] = arr.reshape(meta["shape"])
        return state

    def _upload_pages(self, pages: Sequence[np.ndarray]) -> torch.Tensor:
        """The leaf's page images, concatenated on the host and copied to
        the device once."""
        packed = (np.concatenate([np.asarray(p, dtype=np.uint8)
                                  for p in pages])
                  if pages else np.zeros(0, dtype=np.uint8))
        return torch.from_numpy(packed).to(self.device)

    def _staged_assemble(self, pages: Sequence[np.ndarray],
                         csums: Sequence[int],
                         verify: bool) -> Optional[torch.Tensor]:
        """Pre-fusion restore chain: a popcount pass over every page to
        verify it, then a second pass copying it into the leaf image —
        the restored bytes cross the device twice."""
        cfg = self.cfg
        packed = self._upload_pages(pages)
        counts = (popcount_blocks(packed, block_bytes=cfg.page_size)
                  .cpu().numpy() if verify and pages else None)
        for i, csum in enumerate(csums):
            self._restore_read_bytes += (2 if verify else 1) * cfg.page_size
            if verify and csum and (int(counts[i]) + 1) & 0xFFFFFFFF != csum:
                return None
        return packed   # the pages in order are the leaf image

    def _fused_assemble(self, pages: Sequence[np.ndarray],
                        csums: Sequence[int],
                        verify: bool) -> Optional[torch.Tensor]:
        """Fused restore: ONE ``apply_unpack`` device pass verifies every
        page's popcount against its manifest checksum AND scatters it to
        its offset of the leaf image, which stays on the device. A
        manifest checksum of 0 means "never recorded" and is skipped,
        like the staged chain does."""
        cfg = self.cfg
        k = len(pages)
        packed = self._upload_pages(pages)
        base = torch.zeros(k * cfg.page_size, dtype=torch.uint8,
                           device=self.device)
        # manifest stores popcount+1 (the Zero-log cnt==0 convention)
        expected = (np.asarray(csums, dtype=np.int64) - 1) & 0xFFFFFFFF
        res = apply_unpack(base, packed,
                           np.arange(k, dtype=np.int32), expected,
                           block_bytes=cfg.page_size,
                           impl=cfg.kernel_impl)
        self._restore_read_bytes += k * cfg.page_size   # one pass, fused
        if verify and res.nbad:
            skip = np.asarray(csums, dtype=np.int64) == 0
            if np.any((res.ok.cpu().numpy() == 0) & ~skip):
                return None
        return res.out

    def _adopt(self, entry: Dict[str, Any],
               state: Dict[str, torch.Tensor]) -> None:
        """Rebuild volatile metadata so saving can continue after restore."""
        cfg = self.cfg
        self._leaf_pages = {}
        self._leaf_meta = {}
        # open the pages region now (µlog replay is safe post-verification)
        self._pages = self.pool.pages("pages", threads=cfg.threads)
        self.store = self._pages.store
        self._layout = self._pages.layout
        if self._spill is not None:
            self._spill.attach_pages(self._pages,
                                     on_evict=self._on_page_evicted)
        self._flushq = self._pages.flush_queue(
            lanes=cfg.threads, flush_fn=self._engine_flush_page,
            spill=self._spill)
        self._flushq.cost_model = self.cost_model
        self._cache = self._pool_cache(self._layout.npages)
        self._cache.attach_pages(self._pages, flushq=self._flushq,
                                 spill=self._spill)
        self._cache.invalidate(self.store)
        referenced = set()
        self._spilled_pvn = {}
        for name, meta in entry["leaves"].items():
            self._leaf_pages[name] = [p[0] for p in meta["pages"]]
            self._leaf_meta[name] = {k: meta[k] for k in ("shape", "dtype", "nbytes")}
            for pid, slot, pvn in meta["pages"]:
                if slot == -1:
                    # SSD-resident: stays with the spill map; keep any
                    # stale PMem header out of the table (lower pvn loses
                    # the cross-tier rule anyway)
                    self._spilled_pvn[pid] = pvn
                    self.store.table.pop(pid, None)
                    continue
                referenced.add(slot)
                # trust the committed manifest over µlog-advanced versions
                self.store.table[pid] = (slot, pvn)
            # seed the snapshot frames from the restored bytes, so the
            # next save delta-diffs instead of rewriting every page
            buf = self._leaf_bytes(state[name]).cpu().numpy()
            for i, pid in enumerate(self._leaf_pages[name]):
                page = np.zeros(cfg.page_size, dtype=np.uint8)
                chunk = buf[i * cfg.page_size : (i + 1) * cfg.page_size]
                page[: chunk.size] = chunk
                self._cache.install(pid, page, store=self.store)
        self.store.free = [s for s in range(self._layout.nslots)
                           if s not in referenced]
        self._shadow = {}
        self._prev_dirty = {}
