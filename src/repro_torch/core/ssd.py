"""Modeled flash (SSD) device — the capacity tier below PMem.

The paper positions PMem *between* DRAM and flash: a three-tier
hierarchy in which PMem is fast but capacity-constrained, and cold data
overflows to block-addressed NAND. This module is the flash analogue of
:class:`repro_torch.core.pmem.PMem`: a *functional* device model (which bytes
are durable when) plus *exact operation counts* that
:class:`repro_torch.core.costmodel.SSDCostModel` converts to modeled time.

Differences from the PMem model, mirroring the real device gap:

* **Block granularity.** The device services whole 4 KiB blocks. A read
  touches every covering block; a write that covers only part of a block
  is a read-modify-write (``rmw_blocks``) — flash cannot update bytes in
  place, so sub-block writes pay a block read plus a block program.
* **Write-buffered durability.** Writes land in the device's volatile
  write cache and become durable only at :meth:`flush` (fsync /
  FLUSH CACHE). A crash may keep an *arbitrary subset* of unflushed
  block writes — exactly the discipline the PMem model applies to
  unfenced cache lines, and what the crash-during-spill property tests
  exercise.
* **Read/write asymmetry.** Reads and writes are counted separately
  (``blocks_read`` / ``blocks_written``) because the cost model charges
  them asymmetrically: NAND page reads are device-latency bound while
  programs are bandwidth/erase bound (the Fig. 1 gap between Optane and
  flash — PMem sits orders of magnitude closer to DRAM than the SSD on
  both axes, but the SSD's *write* side is the farther of its two).

The device is deliberately address-space separate from PMem: pool
directory records of kind ``KIND_SSD`` name ranges of *this* device
(see :meth:`repro_torch.pool.Pool.ssd_region`), so PMem byte offsets and SSD
byte offsets can never be confused.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Set

import numpy as np

__all__ = ["SSD", "SSDStats", "SSD_BLOCK"]

#: default flash block (logical-block/page) size in bytes
SSD_BLOCK = 4096


@dataclasses.dataclass
class SSDStats:
    """Exact SSD operation counts. All fields are monotonic counters."""

    reads: int = 0
    read_bytes: int = 0
    writes: int = 0
    write_bytes: int = 0
    blocks_read: int = 0      # device blocks touched by reads
    blocks_written: int = 0   # device blocks programmed (after coalescing)
    rmw_blocks: int = 0       # programs covering < a full block (read-modify-write)
    flushes: int = 0          # FLUSH CACHE / fsync commands

    def snapshot(self) -> "SSDStats":
        """A frozen copy, for windowed deltas."""
        return dataclasses.replace(self)

    def delta(self, since: "SSDStats") -> "SSDStats":
        """Counts accrued since ``since`` (an earlier :meth:`snapshot`)."""
        d = SSDStats()
        for f in dataclasses.fields(SSDStats):
            setattr(d, f.name, getattr(self, f.name) - getattr(since, f.name))
        return d


class SSD:
    """A block-addressed flash device with a volatile write cache.

    ``pwrite``/``pread`` move bytes; durability requires :meth:`flush`.
    Like :class:`~repro_torch.core.pmem.PMem`, the model separates functional
    semantics (durable vs cached bytes, crash simulation) from cost
    accounting (:class:`SSDStats`, converted to time by
    :class:`~repro_torch.core.costmodel.SSDCostModel`).
    """

    def __init__(self, size: int, *, path: Optional[str] = None,
                 block: int = SSD_BLOCK) -> None:
        """Create a device of ``size`` bytes.

        Args:
            size: device capacity in bytes.
            path: optional backing file (``np.memmap``); ``None`` keeps
                the device in memory (simulations and benchmarks).
            block: device block size in bytes (default 4 KiB).
        """
        self.size = int(size)
        self.block = int(block)
        if self.block <= 0:
            raise ValueError("block must be positive")
        if path is not None:
            exists = os.path.exists(path) and os.path.getsize(path) == self.size
            mode = "r+" if exists else "w+"
            self._durable = np.memmap(path, dtype=np.uint8, mode=mode,
                                      shape=(self.size,))
        else:
            self._durable = np.zeros(self.size, dtype=np.uint8)
        self.path = path
        #: unflushed block writes: block index -> block image (write cache)
        self._cache: Dict[int, np.ndarray] = {}
        self.stats = SSDStats()

    # ------------------------------------------------------------------ io

    def _check(self, off: int, size: int) -> None:
        if off < 0 or size < 0 or off + size > self.size:
            raise ValueError(
                f"SSD access [{off}, {off + size}) outside device of "
                f"{self.size} B")

    def _blocks(self, off: int, size: int) -> range:
        if size <= 0:
            return range(0)
        return range(off // self.block, (off + size - 1) // self.block + 1)

    def _block_image(self, b: int) -> np.ndarray:
        """Current (cache-merged) contents of block ``b``."""
        if b in self._cache:
            return self._cache[b]
        lo = b * self.block
        hi = min(lo + self.block, self.size)
        img = np.zeros(self.block, dtype=np.uint8)
        img[: hi - lo] = self._durable[lo:hi]
        return img

    def pwrite(self, off: int, data: bytes | np.ndarray) -> None:
        """Write bytes at ``off`` into the device's write cache.

        The data is NOT durable until :meth:`flush`. Writes covering only
        part of a block count as read-modify-writes (``rmw_blocks``).
        """
        buf = (np.frombuffer(bytes(data), dtype=np.uint8)
               if not isinstance(data, np.ndarray)
               else data.astype(np.uint8, copy=False).ravel())
        n = buf.size
        self._check(off, n)
        if n == 0:
            return
        self.stats.writes += 1
        self.stats.write_bytes += n
        for b in self._blocks(off, n):
            lo = b * self.block
            img = self._block_image(b)
            s = max(off, lo) - lo
            e = min(off + n, lo + self.block) - lo
            img[s:e] = buf[max(off, lo) - off : min(off + n, lo + self.block) - off]
            covered = e - s
            if covered < min(self.block, self.size - lo) and b not in self._cache:
                self.stats.rmw_blocks += 1
            self._cache[b] = img

    def pread(self, off: int, size: int) -> np.ndarray:
        """Read bytes (sees unflushed cached writes). Counts the covering
        device blocks as reads."""
        self._check(off, size)
        self.stats.reads += 1
        self.stats.read_bytes += size
        out = np.zeros(size, dtype=np.uint8)
        for b in self._blocks(off, size):
            self.stats.blocks_read += 1
            lo = b * self.block
            img = self._block_image(b)
            s = max(off, lo)
            e = min(off + size, lo + self.block)
            out[s - off : e - off] = img[s - lo : e - lo]
        return out

    # ----------------------------------------------------------- durability

    def flush(self) -> None:
        """FLUSH CACHE: commit every cached block write to durable media.
        Each committed block counts as one programmed block."""
        self.stats.flushes += 1
        self._commit(set(self._cache))
        self._cache.clear()

    def _commit(self, blocks: Set[int]) -> None:
        for b in sorted(blocks):
            img = self._cache.get(b)
            if img is None:
                continue
            lo = b * self.block
            hi = min(lo + self.block, self.size)
            self._durable[lo:hi] = img[: hi - lo]
            self.stats.blocks_written += 1

    def durable_read(self, off: int, size: int) -> np.ndarray:
        """The durable image of a range (what recovery would see), without
        touching the read counters — a recovery-inspection primitive, the
        analogue of :meth:`PMem.durable_slice`."""
        self._check(off, size)
        return np.array(self._durable[off : off + size], copy=True)

    def crash(self, *, keep: Optional[Callable[[int], bool]] = None,
              rng: Optional[np.random.Generator] = None,
              keep_prob: float = 0.5) -> Set[int]:
        """Simulate power failure: each unflushed cached block write may or
        may not have reached media (``keep`` per block index, or
        Bernoulli(``keep_prob``) under ``rng``). Returns the block indices
        that survived; the cache is dropped."""
        if keep is None:
            gen = rng or np.random.default_rng(0)
            keep = lambda b: bool(gen.random() < keep_prob)  # noqa: E731
        survivors = {b for b in self._cache if keep(b)}
        self._commit(survivors)
        self._cache.clear()
        return survivors

    def fsync(self) -> None:
        """Push the durable image to the backing file (file-backed devices).
        Device-cache durability is :meth:`flush`; this is host-side."""
        if isinstance(self._durable, np.memmap):
            self._durable.flush()

    @property
    def pending_blocks(self) -> int:
        """Unflushed block writes sitting in the device write cache."""
        return len(self._cache)

    def reset_stats(self) -> SSDStats:
        """Swap in fresh counters; returns the old ones."""
        old = self.stats
        self.stats = SSDStats()
        return old
