"""Persistency-barrier model (paper §3.1).

On x86/Optane, durability of a store requires (a) forcing the cache line out
of the CPU cache (``clflush`` / ``clflushopt`` / ``clwb`` or a non-temporal
streaming store) and (b) an ``sfence`` that waits until the line reached the
persistent domain (ADR — the DIMM's battery-backed write buffer).

    void persist(void* ptr) { clwb(ptr); sfence(); }

The paper's cost unit is the *persistency barrier* (flush + sfence): Zero
logging needs 1 per log entry, Header/Classic need 2, CoW page flush needs
2 (with pvn) or 3 (with explicit invalidation), µLog needs 4.

TPU adaptation note: the role-equivalent ordering point on a TPU host is
"device→host DMA complete, then durable-media ack (fsync/O_DIRECT)". We keep
the paper's terminology; :class:`FlushKind` distinguishes the four x86
variants because Fig. 4 shows they have different latencies (Cascade Lake
implements clwb as flushopt; streaming stores skip the read-for-ownership).
"""

from __future__ import annotations

import enum


class FlushKind(enum.Enum):
    """The four ways of forcing data out of the CPU cache (paper Fig. 4)."""

    FLUSH = "flush"        # clflush: write back + invalidate
    FLUSHOPT = "flushopt"  # clflushopt: weaker ordering, still invalidates
    CLWB = "clwb"          # cache line write back, line stays valid
    NT = "nt"              # non-temporal (streaming) store, bypasses cache


class AccessPattern(enum.Enum):
    """Write-target pattern; same-line rewrites are the pathological case
    the paper highlights (Fig. 4 left group, §2.3)."""

    SAME_LINE = "same"
    SEQUENTIAL = "seq"
    RANDOM = "rand"


#: Invalid page/log identifier used by the failure-atomicity protocols.
INVALID_PID: int = 0xFFFFFFFF
