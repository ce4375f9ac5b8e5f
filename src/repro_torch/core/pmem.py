"""Functional PMem model: region + CPU-cache/WC-buffer semantics + crash sim.

This is the substrate the paper's primitives (log writers, page flushers) run
on. Two concerns are deliberately separated:

1. **Functional semantics** (this module) — which bytes are durable when.
   Stores land in a modeled CPU cache; they reach the persistent domain only
   via (a) an explicit flush (``clflush``/``clflushopt``/``clwb``) followed by
   an ``sfence``, (b) a non-temporal store drained by an ``sfence``, or (c)
   *spontaneous eviction*, which the hardware may perform AT ANY TIME
   (paper §3.1: "programs cannot prevent the eviction"). Crash simulation
   therefore makes an *arbitrary subset* of unflushed dirty lines durable —
   failure-atomic algorithms must be correct for every such subset, which is
   exactly what the hypothesis property tests assert.

2. **Cost accounting** — exact counts of barriers, flushed lines, device
   block writes (after write combining), same-line rewrites, and bytes moved.
   ``core.costmodel`` converts these counts into modeled time using constants
   calibrated to the paper's measured ratios. The counts themselves are
   ground truth of the algorithms (e.g. "Zero logging issues exactly one
   barrier per entry") and are asserted in unit tests.

The region is optionally file-backed (``np.memmap``) so the training
checkpoint/WAL layer gets real on-disk persistence; crash simulation then
operates on the in-memory cache layers only.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import os
from typing import Callable, Dict, Iterable, Iterator, Optional, Set

import numpy as np

from repro_torch.core.blocks import BlockGeometry, PAPER_GEOMETRY
from repro_torch.core.persist import FlushKind

__all__ = ["PMem", "PMemStats", "CrashImage"]

#: How many most-recently-flushed lines count as "temporally close" for the
#: same-line-rewrite penalty (paper §2.3 / Fig. 4 "same cache line" group).
_RECENCY_WINDOW = 8


@dataclasses.dataclass
class PMemStats:
    """Exact operation counts. All fields are monotonic counters."""

    stores: int = 0
    store_bytes: int = 0
    nt_stores: int = 0
    nt_store_bytes: int = 0
    loads: int = 0
    load_bytes: int = 0
    device_read_bytes: int = 0  # loads that bypass the cache (cold page reads)

    flushes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k.value: 0 for k in FlushKind}
    )
    lines_flushed: int = 0
    sfences: int = 0
    barriers: int = 0  # sfences that actually had pending persistent work

    blocks_written: int = 0       # 256 B device writes after WC combining
    partial_block_writes: int = 0  # device writes covering < lines_per_block
    same_line_flushes: int = 0    # flush of a line flushed very recently
    same_line_nt: int = 0         # nt store to a line nt-stored very recently

    # Per-lane accounting (repro_torch.io engine): work performed inside a
    # ``PMem.lane(i)`` context is additionally attributed to lane ``i``.
    # Lanes model concurrently-executing writers; ``costmodel.engine_time_ns``
    # takes the max over lanes instead of summing (lane work overlaps).
    lane_barriers: Dict[int, int] = dataclasses.field(default_factory=dict)
    lane_lines: Dict[int, int] = dataclasses.field(default_factory=dict)
    lane_blocks_written: Dict[int, int] = dataclasses.field(default_factory=dict)
    lane_partial_blocks: Dict[int, int] = dataclasses.field(default_factory=dict)

    # NUMA accounting: persistent work performed by a lane whose CPU socket
    # (``PMem.lane(i, socket=s)``) differs from the *home* socket of the
    # touched bytes (``PMem.set_home``). Far-socket PMem access costs
    # ~2-3x near-socket (Izraelevitz et al.); ``engine_time_ns`` charges
    # these counts the remote multipliers. Remote counts are always a
    # subset of the corresponding totals above.
    remote_barriers: int = 0
    remote_blocks_written: int = 0
    lane_remote_barriers: Dict[int, int] = dataclasses.field(default_factory=dict)
    lane_remote_blocks_written: Dict[int, int] = dataclasses.field(default_factory=dict)
    lane_remote_partial_blocks: Dict[int, int] = dataclasses.field(default_factory=dict)

    def snapshot(self) -> "PMemStats":
        d = dataclasses.replace(self)
        for f in dataclasses.fields(PMemStats):
            v = getattr(d, f.name)
            if isinstance(v, dict):
                setattr(d, f.name, dict(v))
        return d

    def delta(self, since: "PMemStats") -> "PMemStats":
        d = PMemStats()
        for f in dataclasses.fields(PMemStats):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                sv = getattr(since, f.name)
                setattr(d, f.name, {k: v[k] - sv.get(k, 0) for k in v})
            else:
                setattr(d, f.name, v - getattr(since, f.name))
        return d

    def active_lanes(self) -> int:
        """Number of lanes that performed any persistent work."""
        lanes = set()
        for field in (self.lane_barriers, self.lane_lines,
                      self.lane_blocks_written, self.lane_partial_blocks):
            lanes.update(k for k, v in field.items() if v)
        return len(lanes)


@dataclasses.dataclass
class CrashImage:
    """The durable bytes after a simulated crash, plus what got evicted."""

    durable: np.ndarray
    evicted_lines: Set[int]
    dropped_lines: Set[int]


class PMem:
    """A byte-addressable persistent region with modeled cache semantics."""

    def __init__(
        self,
        size: int,
        *,
        path: Optional[str] = None,
        geometry: BlockGeometry = PAPER_GEOMETRY,
        sockets: int = 1,
    ) -> None:
        self.size = int(size)
        self.geometry = geometry
        #: socket topology: byte ranges have a *home* socket (set_home) and
        #: lanes an executing CPU socket (lane(i, socket=s)); a mismatch is
        #: a remote access and is counted in the ``remote_*`` stats.
        self.sockets = max(1, int(sockets))
        if path is not None:
            exists = os.path.exists(path) and os.path.getsize(path) == self.size
            mode = "r+" if exists else "w+"
            self._durable = np.memmap(path, dtype=np.uint8, mode=mode, shape=(self.size,))
        else:
            self._durable = np.zeros(self.size, dtype=np.uint8)
        self.path = path
        # Program-visible contents (cache + durable merged).
        self._logical = np.array(self._durable, dtype=np.uint8, copy=True)
        # Dirty cache lines: line index -> None (data lives in _logical).
        self._dirty: Set[int] = set()
        # Lines flushed (clwb/clflush/clflushopt) but not yet fenced. The
        # *data at flush time* is what the fence makes durable — a store
        # after the flush but before the fence is NOT covered (§3.1).
        self._staged: Dict[int, np.ndarray] = {}
        # Non-temporal stores buffered in the WC buffer, awaiting sfence.
        self._wc: Dict[int, np.ndarray] = {}
        # Lines resident in the CPU cache in *clean* state: written back by
        # clwb (which keeps the line valid) or brought in by a load. A
        # clflush/clflushopt removes the line; a later load of it is a
        # device read (``device_read_bytes``).
        self._clean: Set[int] = set()
        # Recently flushed / nt-stored lines for the same-line penalty.
        self._recent_flushed: collections.deque = collections.deque(maxlen=_RECENCY_WINDOW)
        self._recent_nt: collections.deque = collections.deque(maxlen=_RECENCY_WINDOW)
        #: lane currently executing (repro_torch.io engine); None = unattributed.
        self._lane: Optional[int] = None
        #: CPU socket of the executing lane; None = topology-agnostic work
        #: (never counted remote).
        self._lane_socket: Optional[int] = None
        # home-socket interval map: parallel sorted arrays (base, end, socket)
        self._home_bases: list = []
        self._home_ends: list = []
        self._home_sockets: list = []
        self.stats = PMemStats()

    # ----------------------------------------------------------------- lanes

    @contextlib.contextmanager
    def lane(self, lane_id: int, *, socket: Optional[int] = None) -> Iterator[None]:
        """Attribute all persistent work inside the block to ``lane_id``.

        Lanes model *concurrently executing* writers (the sim itself runs
        them sequentially): each lane's barrier / line / block counts are
        recorded separately so ``costmodel.engine_time_ns`` can take the
        wall-clock max over lanes and apply the Fig. 2 concurrency curve
        for the number of simultaneously-active lanes.

        ``socket`` names the CPU socket the lane executes on: persistent
        work it performs against bytes whose home socket (:meth:`set_home`)
        differs is *remote* and additionally counted in the
        ``remote_*`` / ``lane_remote_*`` stats, which the cost model
        charges the Izraelevitz far-socket multipliers."""
        prev, prev_socket = self._lane, self._lane_socket
        self._lane = int(lane_id)
        self._lane_socket = None if socket is None else int(socket)
        try:
            yield
        finally:
            self._lane, self._lane_socket = prev, prev_socket

    def _lane_add(self, field: Dict[int, int], n: int = 1) -> None:
        if self._lane is not None and n:
            field[self._lane] = field.get(self._lane, 0) + n

    # --------------------------------------------------------------- sockets

    def set_home(self, off: int, size: int, socket: int) -> None:
        """Declare the home socket of byte range ``[off, off+size)`` —
        which socket's DIMMs back it. Unregistered bytes default to
        socket 0. Re-registering a base replaces its span (pool regions
        re-register on every open). Sockets beyond the topology clamp to
        the last socket (defensive: a durable tag from a wider machine)."""
        if size <= 0:
            return
        socket = min(max(0, int(socket)), self.sockets - 1)
        i = bisect.bisect_left(self._home_bases, off)
        if i < len(self._home_bases) and self._home_bases[i] == off:
            self._home_ends[i] = off + size
            self._home_sockets[i] = socket
        else:
            self._home_bases.insert(i, off)
            self._home_ends.insert(i, off + size)
            self._home_sockets.insert(i, socket)

    def home_socket(self, off: int) -> int:
        """Home socket of byte ``off`` (0 when unregistered)."""
        i = bisect.bisect_right(self._home_bases, off) - 1
        if i >= 0 and off < self._home_ends[i]:
            return self._home_sockets[i]
        return 0

    def _is_remote(self, line: int) -> bool:
        """Whether touching cache line ``line`` from the executing lane's
        CPU socket crosses a socket boundary."""
        if self._lane_socket is None:
            return False
        return self.home_socket(line * self.geometry.cache_line) != self._lane_socket

    # ------------------------------------------------------------------ io

    def _check(self, off: int, size: int) -> None:
        if off < 0 or size < 0 or off + size > self.size:
            raise ValueError(f"access [{off}, {off + size}) outside region of {self.size} B")

    def _lines(self, off: int, size: int) -> range:
        """Cache-line indices covering [off, off+size) under this region's
        geometry (64 B in paper mode, 4 KiB in checkpoint/TPU mode)."""
        cl = self.geometry.cache_line
        if size <= 0:
            return range(0)
        return range(off // cl, (off + size - 1) // cl + 1)

    def store(self, off: int, data: bytes | np.ndarray, *, streaming: bool = False) -> None:
        """Store bytes at ``off``. Regular stores dirty cache lines;
        streaming (non-temporal) stores go to the WC buffer and become
        durable at the next ``sfence`` without a flush instruction."""
        buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data.astype(np.uint8, copy=False).ravel()
        n = buf.size
        self._check(off, n)
        if n == 0:
            return
        self._logical[off : off + n] = buf
        lines = self._lines(off, n)
        if streaming:
            self.stats.nt_stores += 1
            self.stats.nt_store_bytes += n
            self._lane_add(self.stats.lane_lines, len(lines))
            for li in lines:
                if li in self._recent_nt:
                    self.stats.same_line_nt += 1
                self._recent_nt.append(li)
                lo = li * self.geometry.cache_line
                hi = min(lo + self.geometry.cache_line, self.size)
                self._wc[li] = self._logical[lo:hi].copy()
                self._dirty.discard(li)
                self._clean.discard(li)  # nt stores bypass (and evict) the cache
        else:
            self.stats.stores += 1
            self.stats.store_bytes += n
            self._dirty.update(lines)
            self._clean.difference_update(lines)  # cached, but dirty now

    def load(self, off: int, size: int, *, uncached: bool = False) -> np.ndarray:
        """Read bytes (program order — sees un-persisted stores).

        Lines that are neither dirty- nor clean-cached (nor sitting in the
        WC buffer) come from the device and count as ``device_read_bytes``;
        the read then installs them in the cache, clean. ``uncached=True``
        marks a read that deliberately bypasses the cache (e.g. CoW reading
        the old page version non-temporally): the full size is a device
        read and nothing is cached."""
        self._check(off, size)
        self.stats.loads += 1
        self.stats.load_bytes += size
        if uncached:
            self.stats.device_read_bytes += size
        elif size > 0:
            cl = self.geometry.cache_line
            for li in self._lines(off, size):
                if li in self._dirty or li in self._clean or li in self._wc:
                    continue
                lo, hi = li * cl, min((li + 1) * cl, self.size)
                self.stats.device_read_bytes += min(hi, off + size) - max(lo, off)
                self._clean.add(li)
        return self._logical[off : off + size].copy()

    # --------------------------------------------------------------- flush

    def flush(self, off: int, size: int, kind: FlushKind = FlushKind.CLWB) -> None:
        """Issue a flush instruction for every cache line covering the range.
        Data is *staged*; durability requires a subsequent ``sfence``."""
        if kind == FlushKind.NT:
            raise ValueError("NT is a store attribute, not a flush instruction")
        self._check(off, size)
        self.stats.flushes[kind.value] += 1
        self._lane_add(self.stats.lane_lines, len(self._lines(off, size)))
        for li in self._lines(off, size):
            self.stats.lines_flushed += 1
            if li in self._recent_flushed:
                self.stats.same_line_flushes += 1
            self._recent_flushed.append(li)
            lo = li * self.geometry.cache_line
            hi = min(lo + self.geometry.cache_line, self.size)
            self._staged[li] = self._logical[lo:hi].copy()
            self._dirty.discard(li)
            if kind in (FlushKind.FLUSH, FlushKind.FLUSHOPT):
                # clflush/clflushopt invalidate: a later load is a device read
                self._clean.discard(li)
            else:
                # clwb keeps the line cached (clean)
                self._clean.add(li)

    def sfence(self) -> None:
        """Commit all staged flushes and WC-buffered streaming stores to the
        durable domain. Counts as a *barrier* iff there was pending work."""
        self.stats.sfences += 1
        pending = {}
        pending.update(self._staged)
        pending.update(self._wc)  # nt data wins for lines in both (later store)
        if pending:
            self.stats.barriers += 1
            self._lane_add(self.stats.lane_barriers)
            if self._lane_socket is not None and any(
                    self._is_remote(li) for li in pending):
                # the fence waits for the far socket's ADR domain to ack
                self.stats.remote_barriers += 1
                self._lane_add(self.stats.lane_remote_barriers)
            self._commit(pending)
        self._staged.clear()
        self._wc.clear()

    def persist(self, off: int, size: int, kind: FlushKind = FlushKind.CLWB) -> None:
        """The paper's ``persist()``: flush covering lines, then sfence.
        For data written with streaming stores pass ``kind=FlushKind.NT``:
        no flush instruction is needed, only the fence."""
        if kind != FlushKind.NT:
            self.flush(off, size, kind)
        self.sfence()

    # -------------------------------------------------------------- commit

    def _commit(self, lines: Dict[int, np.ndarray]) -> None:
        """Write staged lines into the durable image, accounting device
        block writes after write combining: lines committed *together* that
        fall in the same 256 B block combine into one block write."""
        blocks: Dict[int, int] = {}
        lpb = self.geometry.lines_per_block
        for li, data in lines.items():
            lo = li * self.geometry.cache_line
            self._durable[lo : lo + data.size] = data
            blocks[li // lpb] = blocks.get(li // lpb, 0) + 1
        for blk, nlines in blocks.items():
            self.stats.blocks_written += 1
            self._lane_add(self.stats.lane_blocks_written)
            remote = self._is_remote(blk * lpb)
            if remote:
                self.stats.remote_blocks_written += 1
                self._lane_add(self.stats.lane_remote_blocks_written)
            if nlines < lpb:
                self.stats.partial_block_writes += 1
                self._lane_add(self.stats.lane_partial_blocks)
                if remote:
                    self._lane_add(self.stats.lane_remote_partial_blocks)

    # --------------------------------------------------------------- crash

    def crash(
        self,
        *,
        evict: Optional[Callable[[int], bool]] = None,
        rng: Optional[np.random.Generator] = None,
        evict_prob: float = 0.5,
    ) -> CrashImage:
        """Simulate a power failure.

        Every line that was dirty, staged-but-not-fenced, or WC-buffered may
        or may not have reached the durable domain (spontaneous eviction is
        legal at any time; a fence was never issued so nothing is promised).
        ``evict`` (or Bernoulli(evict_prob) under ``rng``) decides per line.
        Returns the durable image; the region object itself is reset to it.
        """
        if evict is None:
            gen = rng or np.random.default_rng(0)
            evict = lambda li: bool(gen.random() < evict_prob)  # noqa: E731
        candidates: Dict[int, np.ndarray] = {}
        for li in self._dirty:
            lo = li * self.geometry.cache_line
            hi = min(lo + self.geometry.cache_line, self.size)
            candidates[li] = self._logical[lo:hi].copy()
        candidates.update(self._staged)
        candidates.update(self._wc)
        evicted: Set[int] = set()
        dropped: Set[int] = set()
        survivors: Dict[int, np.ndarray] = {}
        for li, data in sorted(candidates.items()):
            if evict(li):
                evicted.add(li)
                survivors[li] = data
            else:
                dropped.add(li)
        if survivors:
            self._commit(survivors)
        self._dirty.clear()
        self._staged.clear()
        self._wc.clear()
        self._clean.clear()
        self._logical = np.array(self._durable, dtype=np.uint8, copy=True)
        return CrashImage(
            durable=np.array(self._durable, copy=True),
            evicted_lines=evicted,
            dropped_lines=dropped,
        )

    # ---------------------------------------------------------------- misc

    def durable_view(self) -> np.ndarray:
        """The current durable image (what recovery would see)."""
        return np.array(self._durable, copy=True)

    def durable_slice(self, off: int, size: int) -> np.ndarray:
        """Copy of one byte range of the durable image — recovery reads of
        small structures (roots, directory tables) without paying an
        O(region) copy."""
        self._check(off, size)
        return np.array(self._durable[off : off + size], copy=True)

    def fsync(self) -> None:
        """For file-backed regions: push the durable image to stable media."""
        if isinstance(self._durable, np.memmap):
            self._durable.flush()

    def memset_zero(self) -> None:
        """Pre-zero the region (Zero logging requires a zeroed file; the
        paper notes DBs do this anyway to force file-system allocation)."""
        self._logical[:] = 0
        self._durable[:] = 0
        self._dirty.clear()
        self._staged.clear()
        self._wc.clear()
        self._clean.clear()

    def reset_stats(self) -> PMemStats:
        old = self.stats
        self.stats = PMemStats()
        return old
