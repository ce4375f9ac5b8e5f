"""Deterministic key-range → shard assignment with durable, versioned
views.

A :class:`ShardMap` partitions the global key space into ``n_ranges``
page-aligned ranges and assigns each range an owning shard by
**rendezvous (highest-random-weight) hashing**: every ``(range, shard)``
pair hashes to a 64-bit weight and the range belongs to the shard with
the largest one. Adding or removing a shard therefore moves only the
ranges whose argmax changed — the minimal-movement property the
resharding acceptance tests assert — and the assignment is a pure
function of the id pair, bit-identical across processes and replays.

Assignment *authority*, however, is never the hash: it is the durable
**ownership record** ``(range, view, shard)``, the single point of
truth for who answers a range at every instant — including halfway
through an interrupted view change, when some ranges have flipped to
the rendezvous target of the new view and the rest still carry their
old owner. The records live in a double-buffered Zero-log pair behind a
two-slot head region, mirroring the spill map's ping-pong protocol
(``repro_torch.tier.spill``): appends are single-barrier Zero-log commits,
and when the active log fills the live record set is rewritten into the
other buffer and the head flipped with one NT store + persist — the
atomic switch. A crash on either side of any barrier recovers a
consistent map.

View *lifecycle* records share the same logs: a genesis record fixes
the range geometry, a **view-start** record durably declares the shard
set a reshard is moving toward (so recovery can resume an interrupted
migration), and a **view-commit** record seals it. Between start and
commit the map is intentionally mixed — each range is old-owner or
new-owner, decided solely by its ownership record — which is exactly
the crash-mid-reshard invariant the corpus asserts.

Layout on the (typically dedicated, small) *meta pool*::

    <name>.m0 / <name>.m1   ping-pong Zero logs of map records
    <name>.hd               2-slot head (counter, active) — max wins
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.blocks import align_up
from repro_torch.core.costmodel import FlushKind

__all__ = ["ShardMap", "rendezvous_owner"]

_MASK = (1 << 64) - 1

_GENESIS = struct.Struct("<II")    # n_ranges, nkeys
_VIEWHDR = struct.Struct("<QI")    # view, nshards (start record)
_COMMIT = struct.Struct("<Q")      # view          (commit record)
_OWN = struct.Struct("<IQI")       # range, view, shard
_HD = struct.Struct("<QI")         # counter, active buffer

_T_GENESIS, _T_START, _T_COMMIT, _T_OWN = 1, 2, 3, 4


def _mix(x: int) -> int:
    """splitmix64 finalizer: a full-avalanche 64-bit mix, so rendezvous
    weights are uncorrelated across both range ids and shard ids."""
    x &= _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


def rendezvous_owner(range_id: int, shards: Iterable[int]) -> int:
    """The highest-random-weight owner of a range among ``shards``.

    Deterministic (pure function of the id pair; ties — p ≈ 2^-64 —
    go to the smaller shard id via the sorted scan with a strict
    comparison) and minimal-movement: removing a shard reassigns only
    the ranges it owned, adding one steals only the ranges whose new
    weight wins."""
    best_sid, best_w = -1, -1
    for sid in sorted(int(s) for s in shards):
        w = _mix(((range_id + 1) << 32) ^ _mix(sid + 0x9E3779B9))
        if w > best_w:
            best_sid, best_w = sid, w
    if best_sid < 0:
        raise ValueError("rendezvous over an empty shard set")
    return best_sid


class ShardMap:
    """Durable, versioned range→shard map (see module docstring).

    Open-or-create on ``pool``: pass ``n_ranges``/``nkeys``/``shards``
    to create (the initial view 1 commits an ownership record for every
    range up front — the map is total from birth), or reopen an
    existing map and recover the committed view, the per-range owners,
    and any view change that was started but never committed. Creation
    is itself crash-recoverable: it is judged complete only once the
    initial view's commit record is durable, so reopening after a crash
    anywhere inside creation (regions allocated but genesis missing, or
    ownership records partly written) re-runs the remainder
    idempotently rather than misreading the pool as corrupt."""

    def __init__(self, pool, *, n_ranges: Optional[int] = None,
                 nkeys: Optional[int] = None,
                 shards: Optional[Iterable[int]] = None,
                 name: str = "sm", map_capacity: int = 1 << 14) -> None:
        """Open-or-create; see the class docstring for the two modes."""
        self.pool = pool
        self.name = name
        cl = pool.geometry.cache_line
        self._hd = pool.raw(f"{name}.hd", nbytes=2 * cl)
        self._maps = []
        for j in (0, 1):
            rname = f"{name}.m{j}"
            if pool.directory.lookup(rname) is not None:
                self._maps.append(pool.log(rname))
            else:
                self._maps.append(pool.log(rname, capacity=int(map_capacity),
                                           technique="zero"))
        self._hd_counter, self._active = self._read_hd()

        #: committed geometry (genesis record)
        self.n_ranges: int = 0
        self.nkeys: int = 0
        #: last committed view number
        self.view: int = 0
        #: ``(view, shard ids)`` started but not committed, else None
        self.pending: Optional[Tuple[int, Tuple[int, ...]]] = None
        self._view_shards: Dict[int, Tuple[int, ...]] = {}
        self._owner: Dict[int, Tuple[int, int]] = {}   # range -> (view, sid)
        for raw in self._maps[self._active].recovered.entries:
            self._replay(bytes(raw))

        # Creation is detected from the recovered *record* state, not
        # from region presence: the head/log regions come into being
        # before the genesis record does, so a crash during creation can
        # leave the regions allocated with the records partly (or not at
        # all) appended. Reopening such a pool re-runs creation
        # idempotently instead of misreading it as a corrupt map.
        if self.n_ranges == 0:
            # no durable genesis: a fresh map, or a creation the crash
            # cut before its first record — (re-)create from scratch
            if not n_ranges or not nkeys or not shards:
                raise ValueError(
                    "creating a ShardMap needs n_ranges, nkeys and shards")
            self._append(bytes([_T_GENESIS])
                         + _GENESIS.pack(int(n_ranges), int(nkeys)))
        if self.view == 0:
            # the initial view never committed: creation was interrupted
            # somewhere between genesis and the view-1 commit. Finish it
            # idempotently — ``begin_view`` is re-entrant, ranges whose
            # ownership record already landed keep it (same rendezvous
            # answer), the rest get theirs now. The log's prefix
            # guarantee makes the commit record the creation barrier: if
            # it recovered, every record before it did too.
            if self.pending is not None:
                ids = self.pending[1]
            elif shards:
                ids = tuple(sorted(int(s) for s in shards))
            else:
                raise ValueError(
                    f"shard map {self.name!r} creation was interrupted "
                    f"before its shard set became durable; pass shards= "
                    f"to re-create it")
            view = self.begin_view(ids)
            for r in range(self.n_ranges):
                if r not in self._owner:
                    self.record_owner(r, view, rendezvous_owner(r, ids))
            self.commit_view()

    # ------------------------------------------------------ durable layer

    def _read_hd(self) -> Tuple[int, int]:
        img = self._hd.durable_view()
        cl = self.pool.geometry.cache_line
        best = (0, 0)
        for slot in range(2):
            counter, active = _HD.unpack_from(img, slot * cl)
            if counter > best[0]:
                best = (counter, active)
        return best

    def _write_hd(self, active: int) -> None:
        self._hd_counter += 1
        slot = self._hd_counter % 2
        cl = self.pool.geometry.cache_line
        self._hd.store(slot * cl, _HD.pack(self._hd_counter, active),
                       streaming=True)
        self._hd.persist(slot * cl, _HD.size, kind=FlushKind.NT)
        self._active = active

    def _replay(self, raw: bytes) -> None:
        t, body = raw[0], raw[1:]
        if t == _T_GENESIS:
            self.n_ranges, self.nkeys = _GENESIS.unpack_from(body)
        elif t == _T_START:
            view, n = _VIEWHDR.unpack_from(body)
            ids = tuple(struct.unpack_from(f"<{n}I", body, _VIEWHDR.size))
            self._view_shards[view] = ids
            self.pending = (view, ids)
        elif t == _T_COMMIT:
            (view,) = _COMMIT.unpack_from(body)
            self.view = view
            if self.pending is not None and self.pending[0] == view:
                self.pending = None
        elif t == _T_OWN:
            r, view, sid = _OWN.unpack_from(body)
            cur = self._owner.get(r)
            if cur is None or view >= cur[0]:
                self._owner[r] = (view, sid)

    def _append(self, raw: bytes) -> None:
        try:
            self._maps[self._active].append(raw)
        except RuntimeError:
            # Compaction itself can overflow (the live set alone no
            # longer fits a buffer); surface that exactly like a
            # post-compaction append failure — one capacity diagnostic,
            # not the log's generic error. Durably benign either way:
            # the head only flips after a complete rewrite.
            try:
                self._compact()
                self._maps[self._active].append(raw)
            except RuntimeError:
                raise RuntimeError(
                    f"shard map {self.name!r} cannot hold its live record "
                    f"set even after compaction ({self.n_ranges} ranges); "
                    f"create it with a larger map_capacity") from None
        self._replay(raw)

    def _compact(self) -> None:
        """Rewrite the live state — genesis, committed view, pending
        view (if any), one ownership record per range — into the
        inactive log, then flip the head (the atomic switch)."""
        other = 1 - self._active
        log = self._maps[other]
        log.reset()
        log.append(bytes([_T_GENESIS])
                   + _GENESIS.pack(self.n_ranges, self.nkeys))
        ids = self._view_shards.get(self.view, ())
        log.append(self._start_record(self.view, ids))
        log.append(bytes([_T_COMMIT]) + _COMMIT.pack(self.view))
        if self.pending is not None:
            log.append(self._start_record(*self.pending))
        for r in sorted(self._owner):
            view, sid = self._owner[r]
            log.append(bytes([_T_OWN]) + _OWN.pack(r, view, sid))
        self._write_hd(other)

    @staticmethod
    def _start_record(view: int, ids: Tuple[int, ...]) -> bytes:
        return (bytes([_T_START]) + _VIEWHDR.pack(view, len(ids))
                + struct.pack(f"<{len(ids)}I", *ids))

    # -------------------------------------------------------------- reads

    @property
    def shards(self) -> Tuple[int, ...]:
        """Shard ids of the last *committed* view."""
        return self._view_shards.get(self.view, ())

    def owner_of_range(self, r: int) -> int:
        """The shard durably recorded as owning range ``r`` right now —
        the routing authority, even mid-reshard."""
        try:
            return self._owner[int(r)][1]
        except KeyError:
            raise RuntimeError(f"range {r} has no ownership record "
                               f"(corrupt or foreign map)") from None

    def owners(self) -> Dict[int, int]:
        """``{range: owning shard}`` from the durable records."""
        return {r: sid for r, (_, sid) in sorted(self._owner.items())}

    def assignment(self, shards: Optional[Iterable[int]] = None
                   ) -> Dict[int, int]:
        """The pure rendezvous assignment for a shard set (default: the
        committed view's) — where a reshard *would* put every range."""
        ids = tuple(sorted(int(s) for s in shards)) if shards is not None \
            else self.shards
        return {r: rendezvous_owner(r, ids) for r in range(self.n_ranges)}

    def moving_ranges(self, shards: Iterable[int]) -> List[int]:
        """Ranges whose durable owner differs from the rendezvous target
        under ``shards`` — what a reshard to that set must migrate."""
        target = self.assignment(shards)
        return [r for r in range(self.n_ranges)
                if target[r] != self.owner_of_range(r)]

    # ------------------------------------------------------- view changes

    def begin_view(self, shards: Iterable[int]) -> int:
        """Durably start a view change toward ``shards`` and return its
        view number. Re-entrant for resume: beginning the *same* target
        again returns the pending view without a new record; a different
        target while one is pending is an error (finish or resume it
        first)."""
        ids = tuple(sorted(int(s) for s in shards))
        if not ids:
            raise ValueError("a view needs at least one shard")
        if self.pending is not None:
            if self.pending[1] == ids:
                return self.pending[0]
            raise RuntimeError(
                f"view {self.pending[0]} -> {self.pending[1]} is still "
                f"pending; resume it before starting another")
        view = self.view + 1
        self._append(self._start_record(view, ids))
        return view

    def record_owner(self, r: int, view: int, sid: int) -> None:
        """Durably flip range ``r`` to ``sid`` under ``view`` — one
        Zero-log barrier, the per-range commit point of a migration."""
        self._append(bytes([_T_OWN]) + _OWN.pack(int(r), int(view), int(sid)))

    def commit_view(self) -> None:
        """Durably seal the pending view: it becomes the committed one
        and routing answers for it alone."""
        if self.pending is None:
            raise RuntimeError("no view change in progress")
        self._append(bytes([_T_COMMIT]) + _COMMIT.pack(self.pending[0]))

    # -------------------------------------------------------------- sizing

    @staticmethod
    def region_bytes(geometry, map_capacity: int = 1 << 14) -> int:
        """Meta-pool bytes the map's regions need (directory excluded)."""
        return (2 * (int(map_capacity) + geometry.block)
                + align_up(2 * geometry.cache_line, geometry.block))
