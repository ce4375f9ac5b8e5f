"""Durable region directory — the allocation substrate of :mod:`repro_torch.pool`.

A *pool* region starts with a small table of named, typed, geometry-tagged
region records. The table is built from the repo's own primitives and is
failure-atomic by the same arguments the paper makes for page headers and
the ping-pong root:

* The **superblock** (line 0) records magic, format version, geometry and
  table capacity. It is written once at format time, behind a persistency
  barrier.
* Each **entry** occupies exactly one cache line (64 B in paper geometry;
  a 4 KiB tile in checkpoint geometry), so its commit is atomic: after a
  crash the durable image holds either the whole record or none of it
  (lines are never torn, §3.1).
* Validity is *pvn-style*: ``generation == 0`` means "slot never written";
  among duplicate names the highest generation wins (monotonic counter,
  same max-rule as the page-version number of §3.2.1).

Allocation protocol (failure-atomic):

1. *place* — pick the byte range (bump pointer over committed entries) and
   a free entry slot; nothing durable changes.
2. *initialize* — zero the claimed data range (streaming stores + sfence).
   Zero logging requires a zeroed region; page stores read zeroed slot
   headers as invalid, so zero-init is universally safe.
3. *commit* — store the entry line and persist it. One barrier.

A crash before step 3 leaves the directory untouched: the claimed space is
invisible and will be re-claimed (and re-zeroed) by the next allocation.
A spontaneous eviction of the entry line during step 3 is also safe — the
data range was already durably zeroed, so the region appears committed and
empty, which is a valid state. Existing regions are never written by an
allocation, so they survive any crash bit-exact.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.blocks import BlockGeometry, align_up
from repro_torch.core.persist import FlushKind
from repro_torch.core.pmem import PMem

__all__ = [
    "DIRECTORY_MAGIC",
    "KIND_RAW",
    "KIND_LOG",
    "KIND_PAGES",
    "KIND_SSD",
    "RegionRecord",
    "RegionDirectory",
    "directory_bytes",
    "probe_file",
]

DIRECTORY_MAGIC = b"RPMPOOL\x01"
_FORMAT_VERSION = 1

#: region kinds (the ``kind`` field of an entry)
KIND_RAW = 1    # untyped byte range
KIND_LOG = 2    # Classic/Header/Zero log; meta = (technique, flags, dancing, 0)
KIND_PAGES = 3  # PageStore slot array + µlogs; meta = (page_size, npages,
                #                                       nslots, n_mulogs)
KIND_SSD = 4    # SSD-backed range: ``base`` is an offset in the pool's
                # attached SSD device's address space, NOT in PMem. The
                # entry itself (the name → range binding) lives durably in
                # this PMem table; the range's *content* validity is the
                # consumer's problem (the spill tier gates reads with
                # checksummed map records).

# magic, version, cache_line, block, max_regions, pool_size, sockets
# (sockets == 0 in a pre-NUMA superblock and is read as 1)
_SUPER = struct.Struct("<8sIIIIQI")
# name, kind, generation, base, length, meta[4]  — exactly 64 bytes.
# meta[3]'s high 16 bits carry the region's NUMA home socket for every
# kind (consumers own only the low 16 bits); see RegionRecord.socket.
_ENTRY = struct.Struct("<20sIQQQ4I")
_NAME_BYTES = 20
_SOCKET_SHIFT = 16

assert _ENTRY.size == 64


@dataclasses.dataclass(frozen=True)
class RegionRecord:
    """One committed directory entry."""

    name: str
    kind: int
    generation: int
    base: int
    length: int
    meta: Tuple[int, int, int, int] = (0, 0, 0, 0)

    @property
    def end(self) -> int:
        return self.base + self.length

    @property
    def socket(self) -> int:
        """NUMA home socket of the region's bytes (high 16 bits of
        ``meta[3]``; 0 for regions created socket-unaware). A placement
        hint for the cost model and the lane placer — never a durability
        input: recovery is byte-identical under any socket tag."""
        return (self.meta[3] >> _SOCKET_SHIFT) & 0xFFFF


def directory_bytes(geometry: BlockGeometry, max_regions: int) -> int:
    """Bytes the directory occupies at the head of a pool region
    (superblock line + one line per entry, block-aligned)."""
    return align_up((1 + max_regions) * geometry.cache_line, geometry.block)


class RegionDirectory:
    """Durable name → (base, length, type, params) table over a PMem."""

    def __init__(self, pmem: PMem, max_regions: int) -> None:
        self.pmem = pmem
        self.max_regions = int(max_regions)
        self.records: Dict[str, RegionRecord] = {}
        self._slot_of: Dict[str, int] = {}
        self._next_gen = 1

    # ---------------------------------------------------------- lifecycle

    @classmethod
    def format(cls, pmem: PMem, *, max_regions: int = 64) -> "RegionDirectory":
        """Write a fresh superblock (one barrier). Entry lines are expected
        to be zero (``Pool.create`` zeroes the whole region)."""
        if max_regions < 1:
            raise ValueError("max_regions must be >= 1")
        d = cls(pmem, max_regions)
        table_bytes = directory_bytes(pmem.geometry, max_regions)
        if table_bytes > pmem.size:
            raise ValueError("region too small for the directory table")
        g = pmem.geometry
        # Zero the whole table first so stale bytes can never parse as
        # committed entries, then commit the superblock.
        pmem.store(0, np.zeros(table_bytes, dtype=np.uint8), streaming=True)
        sb = _SUPER.pack(DIRECTORY_MAGIC, _FORMAT_VERSION, g.cache_line,
                         g.block, max_regions, pmem.size, pmem.sockets)
        pmem.store(0, sb, streaming=True)
        pmem.persist(0, table_bytes, kind=FlushKind.NT)
        return d

    @classmethod
    def load(cls, pmem: PMem) -> "RegionDirectory":
        """Open an existing directory from the *durable* image, applying the
        max-generation rule to duplicate names."""
        sb = pmem.durable_slice(0, min(_SUPER.size, pmem.size))
        if sb.size < _SUPER.size:
            raise ValueError("region too small to hold a pool superblock")
        magic, version, cl, blk, max_regions, size, sockets = \
            _SUPER.unpack_from(sb, 0)
        if magic != DIRECTORY_MAGIC:
            raise ValueError("not a pool region (bad directory magic)")
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported pool format version {version}")
        g = pmem.geometry
        if (cl, blk) != (g.cache_line, g.block):
            raise ValueError(
                f"pool geometry ({cl}, {blk}) != PMem geometry "
                f"({g.cache_line}, {g.block})")
        if size != pmem.size:
            raise ValueError(f"pool was formatted for {size} B, region is "
                             f"{pmem.size} B")
        # the superblock records the socket topology the pool was
        # formatted for; adopt it (sockets affect accounting only, never
        # layout — unlike geometry, a mismatch cannot corrupt anything)
        if sockets:
            pmem.sockets = max(pmem.sockets, int(sockets))
        d = cls(pmem, max_regions)
        # the table is tiny — read just it, not the whole durable image
        img = pmem.durable_slice(0, (1 + max_regions) * g.cache_line)
        for slot in range(max_regions):
            rec = d._read_entry(img, slot)
            if rec is None:
                continue
            prev = d.records.get(rec.name)
            if prev is None or rec.generation > prev.generation:
                d.records[rec.name] = rec
                d._slot_of[rec.name] = slot
            d._next_gen = max(d._next_gen, rec.generation + 1)
        for rec in d.records.values():
            if rec.kind != KIND_SSD:
                pmem.set_home(rec.base, rec.length, rec.socket)
        return d

    @staticmethod
    def is_formatted(pmem: PMem) -> bool:
        n = min(len(DIRECTORY_MAGIC), pmem.size)
        return bytes(pmem.durable_slice(0, n)) == DIRECTORY_MAGIC

    # ------------------------------------------------------------- layout

    def _entry_off(self, slot: int) -> int:
        return (1 + slot) * self.pmem.geometry.cache_line

    @property
    def data_start(self) -> int:
        """First byte after the entry table."""
        return directory_bytes(self.pmem.geometry, self.max_regions)

    @property
    def data_end(self) -> int:
        """Current PMem bump pointer: first byte past every committed
        PMem-resident region (``KIND_SSD`` records address the SSD device's
        space and do not consume PMem bytes)."""
        end = self.data_start
        for rec in self.records.values():
            if rec.kind != KIND_SSD:
                end = max(end, rec.end)
        return align_up(end, self.pmem.geometry.block)

    @property
    def free_bytes(self) -> int:
        return self.pmem.size - self.data_end

    @property
    def ssd_data_end(self) -> int:
        """Bump pointer over the SSD address space: first SSD byte past
        every committed ``KIND_SSD`` region."""
        end = 0
        for rec in self.records.values():
            if rec.kind == KIND_SSD:
                end = max(end, rec.end)
        return end

    def _read_entry(self, img: np.ndarray, slot: int) -> Optional[RegionRecord]:
        raw_name, kind, gen, base, length, *meta = _ENTRY.unpack_from(
            img, self._entry_off(slot))
        if gen == 0:
            return None
        # defensive sanity — a record that fails these is ignored, never
        # fatal. KIND_SSD bases live in the SSD device's address space, so
        # the PMem bounds do not apply to them.
        if length <= 0:
            return None
        if kind != KIND_SSD and (
                base < self.data_start or base + length > self.pmem.size):
            return None
        try:
            name = raw_name.rstrip(b"\x00").decode("utf-8")
        except UnicodeDecodeError:
            return None
        if not name:
            return None
        return RegionRecord(name, kind, gen, base, length,
                            tuple(int(m) for m in meta))

    # --------------------------------------------------------------- read

    def lookup(self, name: str) -> Optional[RegionRecord]:
        return self.records.get(name)

    def require(self, name: str, kind: int) -> RegionRecord:
        rec = self.records.get(name)
        if rec is None:
            raise KeyError(f"no region named {name!r} in pool")
        if rec.kind != kind:
            raise TypeError(f"region {name!r} has kind {rec.kind}, wanted {kind}")
        return rec

    # ---------------------------------------------------------- allocate

    def allocate(self, name: str, kind: int, length: int,
                 meta: Tuple[int, int, int, int] = (0, 0, 0, 0),
                 socket: int = 0) -> RegionRecord:
        """Failure-atomically allocate a named region: place → zero-init →
        single-line entry commit. See the module docstring for the crash
        argument. ``socket`` tags the region's NUMA home socket (stored in
        the high 16 bits of ``meta[4]``'s last word; a pure performance
        hint — see :attr:`RegionRecord.socket`)."""
        socket = int(socket)
        if not 0 <= socket < max(1, self.pmem.sockets):
            raise ValueError(
                f"socket {socket} outside the pool's {self.pmem.sockets}"
                f"-socket topology")
        if meta[3] >> _SOCKET_SHIFT:
            raise ValueError("meta[3] high bits are reserved for the socket tag")
        meta = (meta[0], meta[1], meta[2],
                (meta[3] & 0xFFFF) | (socket << _SOCKET_SHIFT))
        rec, slot = self._place(name, kind, length, meta)
        self._initialize(rec)
        self._commit(rec, slot)
        return rec

    def allocate_ssd(self, name: str, length: int, ssd_size: int,
                     meta: Tuple[int, int, int, int] = (0, 0, 0, 0),
                     socket: int = 0) -> RegionRecord:
        """Allocate a named range of the pool's SSD address space.

        The binding (name → SSD byte range) is committed in this PMem
        table with the same single-line atomic entry commit as a PMem
        region; the SSD bytes themselves are NOT zero-initialized (the
        directory does not own the device — consumers must gate reads on
        their own validity metadata, e.g. the spill tier's checksummed
        map records).

        Args:
            name: region name (≤ 20 bytes UTF-8, unique in the pool).
            length: SSD bytes to claim.
            ssd_size: capacity of the attached SSD device — the bump
                allocation is bounds-checked against it.
            meta: four consumer-defined ints stored in the entry.
            socket: the region's NUMA home (the socket whose I/O complex
                the device hangs off) — same meta[3] packing as
                :meth:`allocate`; a performance hint only. No
                ``set_home`` mapping: SSD bases are device-space offsets,
                not PMem addresses.
        """
        socket = int(socket)
        if not 0 <= socket < max(1, self.pmem.sockets):
            raise ValueError(
                f"socket {socket} outside the pool's {self.pmem.sockets}"
                f"-socket topology")
        if meta[3] >> _SOCKET_SHIFT:
            raise ValueError("meta[3] high bits are reserved for the socket tag")
        meta = (meta[0], meta[1], meta[2],
                (meta[3] & 0xFFFF) | (socket << _SOCKET_SHIFT))
        slot = self._claim_slot(name, length)
        base = self.ssd_data_end
        if base + length > ssd_size:
            raise RuntimeError(
                f"SSD full: need {length} B at {base}, device is "
                f"{ssd_size} B")
        rec = RegionRecord(name, KIND_SSD, self._next_gen, base, int(length),
                           tuple(int(m) for m in meta))
        self._commit(rec, slot)
        return rec

    def _claim_slot(self, name: str, length: int) -> int:
        """Shared entry admission: validate the name/length and pick a
        free entry slot (purely volatile). One source of truth for both
        the PMem and SSD allocation paths."""
        if name in self.records:
            raise ValueError(f"region {name!r} already exists")
        if len(name.encode("utf-8")) > _NAME_BYTES:
            raise ValueError(f"region name {name!r} longer than {_NAME_BYTES} B")
        if length <= 0:
            raise ValueError("region length must be positive")
        used = set(self._slot_of.values())
        slot = next((s for s in range(self.max_regions) if s not in used), None)
        if slot is None:
            raise RuntimeError(f"directory full ({self.max_regions} regions)")
        return slot

    def _place(self, name: str, kind: int, length: int,
               meta: Tuple[int, int, int, int]) -> Tuple[RegionRecord, int]:
        """Pick the byte range and entry slot. Purely volatile."""
        slot = self._claim_slot(name, length)
        base = self.data_end
        if base + length > self.pmem.size:
            raise RuntimeError(
                f"pool full: need {length} B at {base}, region is "
                f"{self.pmem.size} B")
        rec = RegionRecord(name, kind, self._next_gen, base, int(length),
                           tuple(int(m) for m in meta))
        return rec, slot

    def _initialize(self, rec: RegionRecord, chunk: int = 1 << 20) -> None:
        """Durably zero the claimed range (bulk streaming traffic, fenced
        once). Must complete before the entry commit: a spontaneously
        evicted entry line must only ever expose initialized data."""
        off, end = rec.base, rec.end
        while off < end:
            n = min(chunk, end - off)
            self.pmem.store(off, np.zeros(n, dtype=np.uint8), streaming=True)
            off += n
        self.pmem.sfence()

    def _commit(self, rec: RegionRecord, slot: int) -> None:
        """Atomic commit: the entry fits a single cache line."""
        entry = _ENTRY.pack(rec.name.encode("utf-8"), rec.kind, rec.generation,
                            rec.base, rec.length, *rec.meta)
        off = self._entry_off(slot)
        self.pmem.store(off, entry, streaming=True)
        self.pmem.persist(off, _ENTRY.size, kind=FlushKind.NT)
        self.records[rec.name] = rec
        self._slot_of[rec.name] = slot
        self._next_gen += 1
        if rec.kind != KIND_SSD:
            self.pmem.set_home(rec.base, rec.length, rec.socket)


def probe_file(path: str) -> Optional[Tuple[int, int, int, int, int]]:
    """Read a pool file's superblock without mapping the region.
    Returns ``(cache_line, block, max_regions, size, sockets)`` or
    ``None`` if the file is missing or not a formatted pool (``sockets``
    is 1 for a pre-NUMA superblock)."""
    try:
        with open(path, "rb") as f:
            buf = f.read(_SUPER.size)
    except OSError:
        return None
    if len(buf) < _SUPER.size:
        return None
    magic, version, cl, blk, max_regions, size, sockets = _SUPER.unpack(buf)
    if magic != DIRECTORY_MAGIC or version != _FORMAT_VERSION:
        return None
    return cl, blk, max_regions, size, max(1, sockets)
