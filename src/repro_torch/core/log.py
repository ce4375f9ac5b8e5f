"""Log-writing primitives (paper §3.3): Classic, Header(±dancing), Zero.

All three append variable-size entries to a pre-allocated, pre-zeroed PMem
region and guarantee *failure atomicity*: after a crash, recovery returns
exactly a prefix of the appended entries, containing at least every entry
whose ``append()`` call had completed.

  Classic  — entry = [header(len,lsn) | payload | footer(lsn)].
             persist(header+payload); persist(footer)      → 2 barriers.
             Valid iff footer.lsn == header.lsn (footer is only *written*
             after the first barrier made the payload durable).
  Header   — PMDK libpmemlog scheme: entry = [header(len,lsn) | payload],
             file head holds a size field.
             persist(entry); size += n; persist(size)      → 2 barriers,
             plus a same-cache-line rewrite of the size field on EVERY
             append — the pathology of §2.3. ``dancing`` size fields
             (round-robin, one per cache line) remove the same-line
             rewrites; recovery takes the max over the slots.
  Zero     — the paper's contribution: file is pre-zeroed; entry =
             [header(len, lsn, cnt) | payload] where cnt = popcount of the
             entry's other bits + 1 (the +1 keeps cnt nonzero even for
             all-zero payloads; cnt==0 ⇒ slot never written).
             persist(entry)                                → 1 barrier.
             Valid iff stored cnt matches the recomputed popcount: every
             cache line is either fully durable (evicted/flushed) or still
             all-zero, so a dropped line changes the popcount — unless the
             dropped line was all-zero, in which case the recovered bytes
             are identical anyway and the entry is trivially valid.

Entry *padding* (``pad_to_line``) aligns each entry start to a cache-line
boundary so consecutive appends never re-persist the boundary line of the
previous entry — the ≈8× effect of Fig. 6. ``pad_to_block`` aligns to the
256 B device block (guideline G1).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.blocks import BlockGeometry, PAPER_GEOMETRY, align_up
from repro_torch.core.persist import FlushKind
from repro_torch.core.pmem import PMem

__all__ = [
    "LogConfig",
    "RecoveredLog",
    "ClassicLog",
    "HeaderLog",
    "ZeroLog",
    "LOG_TECHNIQUES",
]


def popcount(buf: np.ndarray) -> int:
    """Bit population count of a uint8 buffer (x86 ``popcnt`` analogue)."""
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(buf).sum())
    return int(np.unpackbits(buf).sum())


@dataclasses.dataclass(frozen=True)
class LogConfig:
    geometry: BlockGeometry = PAPER_GEOMETRY
    pad_to_line: bool = True    # Fig. 6 right: align entries to cache lines
    pad_to_block: bool = False  # guideline G1: align to 256 B device blocks
    dancing: int = 1            # HeaderLog only: number of size slots
    flush_kind: FlushKind = FlushKind.NT

    def pad(self, size: int) -> int:
        if self.pad_to_block:
            return align_up(size, self.geometry.block)
        if self.pad_to_line:
            return align_up(size, self.geometry.cache_line)
        return size


@dataclasses.dataclass
class RecoveredLog:
    entries: List[bytes]
    lsns: List[int]
    tail: int       # byte offset where the next entry would go
    next_lsn: int
    #: byte offset where each recovered entry starts (same order as
    #: ``entries``) — lets a caller truncate a log back to a chosen prefix
    #: (MultiLog merge-on-recovery discards beyond-gap tail entries).
    offsets: List[int] = dataclasses.field(default_factory=list)


class _LogBase:
    """Common machinery: region window, tail tracking, store+persist."""

    #: barriers issued per append() — asserted in tests per the paper.
    BARRIERS_PER_APPEND: int = -1

    def __init__(self, pmem: PMem, base: int, capacity: int,
                 cfg: Optional[LogConfig] = None) -> None:
        self.pmem = pmem
        self.base = base
        self.capacity = capacity
        self.cfg = cfg or LogConfig()
        self.tail = self._data_start()
        self.next_lsn = 1

    # -- layout -----------------------------------------------------------
    def _data_start(self) -> int:
        return 0

    def _remaining(self) -> int:
        return self.capacity - self.tail

    # -- io ---------------------------------------------------------------
    def _store(self, off: int, data: bytes) -> None:
        streaming = self.cfg.flush_kind == FlushKind.NT
        self.pmem.store(self.base + off, data, streaming=streaming)

    def _persist(self, off: int, size: int) -> None:
        self.pmem.persist(self.base + off, size, kind=self.cfg.flush_kind)

    def _persist_many(self, spans: List[Tuple[int, int]]) -> None:
        """Flush many ranges, then ONE sfence — a single persistency barrier
        covering all of them (clwb/clflushopt allow batching flushes before
        the fence; NT stores need no flush instruction at all)."""
        if self.cfg.flush_kind != FlushKind.NT:
            for off, size in spans:
                self.pmem.flush(self.base + off, size, self.cfg.flush_kind)
        self.pmem.sfence()

    def append(self, payload: bytes) -> int:
        raise NotImplementedError

    def stride(self, payload_len: int) -> int:
        """Region bytes one appended entry of this payload size occupies
        (technique framing + padding included) — lets a batching caller
        (MultiLog) reserve capacity at submit time, so a buffered batch
        can never fail its later commit with "log full"."""
        raise NotImplementedError

    def append_batch(self, payloads: "List[bytes]") -> List[int]:
        """Group commit: append many entries amortizing the technique's
        barriers over the whole batch (k entries cost what one append
        costs in barriers).

        Every shipped technique overrides this with an implementation
        that is also all-or-nothing capacity-wise (the whole batch fits
        or nothing is written — MultiLog relies on that to retry safely).
        This base fallback is a plain unbatched loop with NEITHER
        property; a new technique must override it before being used for
        group commit."""
        return [self.append(p) for p in payloads]

    # -- recovery ---------------------------------------------------------
    @classmethod
    def recover(cls, pmem: PMem, base: int, capacity: int,
                cfg: Optional[LogConfig] = None) -> RecoveredLog:
        raise NotImplementedError

    @classmethod
    def open_for_append(cls, pmem: PMem, base: int, capacity: int,
                        cfg: Optional[LogConfig] = None):
        """Recover, then return (writer positioned at the tail, recovered)."""
        rec = cls.recover(pmem, base, capacity, cfg)
        w = cls(pmem, base, capacity, cfg)
        w.tail = rec.tail
        w.next_lsn = rec.next_lsn
        if isinstance(w, HeaderLog):
            w._size = rec.tail - w._data_start()
        return w, rec


# =========================================================================
# Classic
# =========================================================================

_CL_HDR = struct.Struct("<IQ")   # len, lsn
_CL_FTR = struct.Struct("<Q")    # lsn copy


class ClassicLog(_LogBase):
    """Header+payload persisted, then footer persisted (2 barriers).

    In padded mode the footer sits on its *own* cache line — otherwise the
    footer persist would rewrite the just-persisted tail line of the
    payload (the §2.3 stall). This is why the paper's footnote says Classic
    pads "up to 2 cache lines" per entry vs 1 for Header/Zero.
    """

    BARRIERS_PER_APPEND = 2

    def _footer_off(self, n: int) -> int:
        head_len = _CL_HDR.size + n
        if self.cfg.pad_to_line or self.cfg.pad_to_block:
            return self.cfg.geometry.pad_to_line(head_len)
        return head_len

    def stride(self, payload_len: int) -> int:
        """See :meth:`_LogBase.stride`: header + payload + own-line footer."""
        return self.cfg.pad(self._footer_off(payload_len) + _CL_FTR.size)

    def append(self, payload: bytes) -> int:
        n = len(payload)
        ftr_off = self._footer_off(n)
        stride = self.cfg.pad(ftr_off + _CL_FTR.size)
        if stride > self._remaining():
            raise RuntimeError("log full")
        head_len = _CL_HDR.size + n
        # 1. header + payload, persist (barrier 1)
        self._store(self.tail, _CL_HDR.pack(n, self.next_lsn) + payload)
        self._persist(self.tail, head_len)
        # 2. footer (own line when padded), persist (barrier 2)
        self._store(self.tail + ftr_off, _CL_FTR.pack(self.next_lsn))
        self._persist(self.tail + ftr_off, _CL_FTR.size)
        lsn = self.next_lsn
        self.tail += stride
        self.next_lsn += 1
        return lsn

    def append_batch(self, payloads: List[bytes]) -> List[int]:
        """Group commit: all headers+payloads behind barrier 1, all footers
        behind barrier 2 — 2 barriers for the whole batch. A footer is only
        stored after barrier 1 made every payload durable, so the per-entry
        validity argument is unchanged."""
        if not payloads:
            return []
        heads: List[Tuple[int, bytes]] = []
        footers: List[Tuple[int, bytes]] = []
        off, lsn = self.tail, self.next_lsn
        for payload in payloads:
            n = len(payload)
            fo = self._footer_off(n)
            heads.append((off, _CL_HDR.pack(n, lsn) + payload))
            footers.append((off + fo, _CL_FTR.pack(lsn)))
            off += self.cfg.pad(fo + _CL_FTR.size)
            lsn += 1
        if off - self.tail > self._remaining():
            raise RuntimeError("log full")
        for o, b in heads:
            self._store(o, b)
        self._persist_many([(o, len(b)) for o, b in heads])      # barrier 1
        for o, b in footers:
            self._store(o, b)
        self._persist_many([(o, len(b)) for o, b in footers])    # barrier 2
        lsns = list(range(self.next_lsn, lsn))
        self.tail, self.next_lsn = off, lsn
        return lsns

    @classmethod
    def recover(cls, pmem: PMem, base: int, capacity: int,
                cfg: Optional[LogConfig] = None) -> RecoveredLog:
        cfg = cfg or LogConfig()
        img = pmem.durable_view()[base : base + capacity]
        entries: List[bytes] = []
        lsns: List[int] = []
        offsets: List[int] = []
        off, lsn = 0, 1

        def footer_off(n: int) -> int:
            head_len = _CL_HDR.size + n
            if cfg.pad_to_line or cfg.pad_to_block:
                return cfg.geometry.pad_to_line(head_len)
            return head_len

        while off + _CL_HDR.size <= capacity:
            n, got_lsn = _CL_HDR.unpack_from(img, off)
            fo = footer_off(n)
            end = off + fo + _CL_FTR.size
            if n == 0 or got_lsn != lsn or end > capacity:
                break
            (ftr_lsn,) = _CL_FTR.unpack_from(img, off + fo)
            if ftr_lsn != got_lsn:
                break
            entries.append(bytes(img[off + _CL_HDR.size : off + _CL_HDR.size + n]))
            lsns.append(got_lsn)
            offsets.append(off)
            off += cfg.pad(fo + _CL_FTR.size)
            lsn += 1
        return RecoveredLog(entries, lsns, off, lsn, offsets)


# =========================================================================
# Header (libpmemlog)
# =========================================================================

_HD_HDR = struct.Struct("<IQ")  # len, lsn
_HD_SIZE = struct.Struct("<Q")  # used-bytes slot


class HeaderLog(_LogBase):
    """PMDK libpmemlog scheme: append entry, then update the size field.

    ``cfg.dancing`` > 1 spreads the size field over that many cache lines,
    written round-robin, eliminating the same-line rewrite on every append
    (§3.3.2 "dancing size field"; 64 slots recovers Classic throughput).
    Recovery size = max over slots (sizes are monotonic).
    """

    BARRIERS_PER_APPEND = 2

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self._size = 0          # bytes used in the data area
        self._next_slot = 0

    def _data_start(self) -> int:
        cfg = self.cfg  # always set by _LogBase.__init__ before _data_start()
        return align_up(cfg.dancing * cfg.geometry.cache_line, cfg.geometry.block)

    def stride(self, payload_len: int) -> int:
        """See :meth:`_LogBase.stride`: (len, lsn) header + payload."""
        return self.cfg.pad(_HD_HDR.size + payload_len)

    def append(self, payload: bytes) -> int:
        n = len(payload)
        entry = _HD_HDR.pack(n, self.next_lsn) + payload
        stride = self.cfg.pad(len(entry))
        if stride > self._remaining():
            raise RuntimeError("log full")
        # 1. entry, persist (barrier 1)
        self._store(self.tail, entry)
        self._persist(self.tail, len(entry))
        # 2. size slot, persist (barrier 2). With dancing=1 this re-persists
        #    the same cache line on every append — the §2.3 pathology.
        self._size += stride
        slot_off = self._next_slot * self.cfg.geometry.cache_line
        self._next_slot = (self._next_slot + 1) % self.cfg.dancing
        self._store(slot_off, _HD_SIZE.pack(self._size))
        self._persist(slot_off, _HD_SIZE.size)
        lsn = self.next_lsn
        self.tail += stride
        self.next_lsn += 1
        return lsn

    def append_batch(self, payloads: List[bytes]) -> List[int]:
        """Group commit: all entries behind barrier 1, then ONE size-field
        update covering the whole batch behind barrier 2 — 2 barriers per
        batch, and the size field is rewritten once per batch instead of
        once per append (group commit also amortizes the §2.3 pathology)."""
        if not payloads:
            return []
        entries: List[Tuple[int, bytes]] = []
        off, lsn, added = self.tail, self.next_lsn, 0
        for payload in payloads:
            e = _HD_HDR.pack(len(payload), lsn) + payload
            entries.append((off, e))
            stride = self.cfg.pad(len(e))
            off += stride
            added += stride
            lsn += 1
        if off - self.tail > self._remaining():
            raise RuntimeError("log full")
        for o, e in entries:
            self._store(o, e)
        self._persist_many([(o, len(e)) for o, e in entries])    # barrier 1
        self._size += added
        slot_off = self._next_slot * self.cfg.geometry.cache_line
        self._next_slot = (self._next_slot + 1) % self.cfg.dancing
        self._store(slot_off, _HD_SIZE.pack(self._size))
        self._persist(slot_off, _HD_SIZE.size)                   # barrier 2
        lsns = list(range(self.next_lsn, lsn))
        self.tail, self.next_lsn = off, lsn
        return lsns

    @classmethod
    def recover(cls, pmem: PMem, base: int, capacity: int,
                cfg: Optional[LogConfig] = None) -> RecoveredLog:
        cfg = cfg or LogConfig()
        img = pmem.durable_view()[base : base + capacity]
        data_start = align_up(cfg.dancing * cfg.geometry.cache_line, cfg.geometry.block)
        size = 0
        for slot in range(cfg.dancing):
            (s,) = _HD_SIZE.unpack_from(img, slot * cfg.geometry.cache_line)
            size = max(size, s)
        entries: List[bytes] = []
        lsns: List[int] = []
        offsets: List[int] = []
        off, lsn = data_start, 1
        end_valid = data_start + size
        while off + _HD_HDR.size <= end_valid:
            n, got_lsn = _HD_HDR.unpack_from(img, off)
            if n == 0 or got_lsn != lsn or off + _HD_HDR.size + n > end_valid:
                break
            entries.append(bytes(img[off + _HD_HDR.size : off + _HD_HDR.size + n]))
            lsns.append(got_lsn)
            offsets.append(off)
            off += cfg.pad(_HD_HDR.size + n)
            lsn += 1
        return RecoveredLog(entries, lsns, off, lsn, offsets)


# =========================================================================
# Zero — the paper's single-barrier technique
# =========================================================================

_ZR_HDR = struct.Struct("<IQQ")  # len, lsn, cnt


class ZeroLog(_LogBase):
    """One persistency barrier per entry; validity via popcount over a
    pre-zeroed file (paper §3.3.1 "Zero")."""

    BARRIERS_PER_APPEND = 1

    def stride(self, payload_len: int) -> int:
        """See :meth:`_LogBase.stride`: (len, lsn, cnt) header + payload."""
        return self.cfg.pad(_ZR_HDR.size + payload_len)

    def append(self, payload: bytes) -> int:
        n = len(payload)
        body = _ZR_HDR.pack(n, self.next_lsn, 0)[: _ZR_HDR.size - 8] + payload
        # cnt counts every bit of the entry EXCEPT the cnt field itself;
        # +1 keeps it nonzero (cnt==0 must mean "never written").
        cnt = popcount(np.frombuffer(body, dtype=np.uint8)) + 1
        entry = _ZR_HDR.pack(n, self.next_lsn, cnt) + payload
        stride = self.cfg.pad(len(entry))
        if stride > self._remaining():
            raise RuntimeError("log full")
        # header + cnt + payload persisted together (single barrier)
        self._store(self.tail, entry)
        self._persist(self.tail, len(entry))
        lsn = self.next_lsn
        self.tail += stride
        self.next_lsn += 1
        return lsn

    def append_batch(self, payloads: List[bytes]) -> List[int]:
        """Group commit at its best: the whole batch costs ONE persistency
        barrier (all entries streamed, one fence). Per-entry popcounts keep
        the per-entry validity argument — a crash mid-batch recovers the
        longest valid prefix of the batch."""
        if not payloads:
            return []
        entries: List[Tuple[int, bytes]] = []
        off, lsn = self.tail, self.next_lsn
        for payload in payloads:
            n = len(payload)
            body = _ZR_HDR.pack(n, lsn, 0)[: _ZR_HDR.size - 8] + payload
            cnt = popcount(np.frombuffer(body, dtype=np.uint8)) + 1
            entries.append((off, _ZR_HDR.pack(n, lsn, cnt) + payload))
            off += self.cfg.pad(_ZR_HDR.size + n)
            lsn += 1
        if off - self.tail > self._remaining():
            raise RuntimeError("log full")
        for o, e in entries:
            self._store(o, e)
        self._persist_many([(o, len(e)) for o, e in entries])  # the ONE barrier
        lsns = list(range(self.next_lsn, lsn))
        self.tail, self.next_lsn = off, lsn
        return lsns

    @classmethod
    def recover(cls, pmem: PMem, base: int, capacity: int,
                cfg: Optional[LogConfig] = None) -> RecoveredLog:
        cfg = cfg or LogConfig()
        img = pmem.durable_view()[base : base + capacity]
        entries: List[bytes] = []
        lsns: List[int] = []
        offsets: List[int] = []
        off, lsn = 0, 1
        while off + _ZR_HDR.size <= capacity:
            n, got_lsn, cnt = _ZR_HDR.unpack_from(img, off)
            if cnt == 0 or got_lsn != lsn or off + _ZR_HDR.size + n > capacity:
                break
            body = bytes(img[off : off + _ZR_HDR.size - 8]) + bytes(
                img[off + _ZR_HDR.size : off + _ZR_HDR.size + n]
            )
            if popcount(np.frombuffer(body, dtype=np.uint8)) + 1 != cnt:
                break  # some cache line of the entry never became durable
            entries.append(bytes(img[off + _ZR_HDR.size : off + _ZR_HDR.size + n]))
            lsns.append(got_lsn)
            offsets.append(off)
            off += cfg.pad(_ZR_HDR.size + n)
            lsn += 1
        return RecoveredLog(entries, lsns, off, lsn, offsets)


LOG_TECHNIQUES = {
    "classic": ClassicLog,
    "header": HeaderLog,
    "zero": ZeroLog,
}
