"""Lane-partitioned log with group commit — the engine's write-side core.

A :class:`MultiLog` stripes appends across N per-lane logs (each one a
Zero/Classic/Header log in its own pool region ``<name>.lane<i>``) and
assigns every entry a *global* LSN at submit time. Appends are buffered
per lane and committed in batches of ``group_commit`` entries, so the
technique's persistency barriers are amortized over the whole batch:
Zero logging pays ONE barrier per k entries instead of one per entry.
Lane work runs under :meth:`repro_torch.core.pmem.PMem.lane`, so per-lane
barrier/line/block counts land in :class:`~repro_torch.core.pmem.PMemStats`
and ``costmodel.engine_time_ns`` can model the lanes as concurrent.

Durability contract: ``append()`` returns the entry's global LSN but the
entry is durable only after the next :meth:`commit` (or ``sync=True``,
or an automatic full-batch lane commit plus every *earlier* lane batch).
What recovery guarantees is a *consistent global prefix*: the recovered
entries are exactly global LSNs ``1..m`` for some ``m`` that covers at
least every entry committed before the crash.

Merge-on-recovery: each lane's own recovery yields a prefix of that
lane's entries (the per-technique validity argument). Global LSNs are
handed out round-robin, so within a lane they increase monotonically —
the global durable prefix is the longest run ``1..m`` present across
lanes, and everything beyond ``m`` (entries that became durable in one
lane while an *earlier* entry died with another lane's lost batch) is
discarded by durably re-zeroing each lane's tail back to its last kept
entry. Without that repair, re-appending after recovery would produce
two different entries carrying the same global LSN.

Generations (``gen_sets >= 2``): the log runs a *ring* of lane sets
(regions ``<name>.g<j>.lane<i>``) plus a ping-pong generation header
(``<name>.gen``). :meth:`MultiLog.roll` seals the current generation —
commit everything, then atomically advance the header to generation
``g+1``, whose lane set takes over with LSNs restarting at 1. Sealed
generations stay PMem-resident (readable, crash-recoverable) until a
:class:`repro_torch.tier.SpillScheduler` retires them to SSD (or, with no
scheduler, until their ring slot is reused — plain truncation). The
header's ``retired_upto`` watermark is the single atomic source of
truth for *where* a generation lives: ``gen > retired_upto`` recovers
from PMem, ``gen <= retired_upto`` from SSD, never both — the
crash-during-spill property of ``tests/test_tier_props.py``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.log import HeaderLog, LogConfig, RecoveredLog

__all__ = ["MultiLog", "MultiLogRecovered"]

_GLSN = struct.Struct("<Q")
# generation header slot: counter, current_gen, retired_upto, gen_sets, lanes
_GENHDR = struct.Struct("<QQQII")

#: default number of appends batched per lane commit
DEFAULT_GROUP_COMMIT = 8


@dataclasses.dataclass
class MultiLogRecovered:
    """What merge-on-recovery found: the consistent global-LSN prefix."""

    entries: List[bytes]
    glsns: List[int]
    next_glsn: int
    #: entries recovered per lane *before* the merge cut
    per_lane: List[int]
    #: durable entries discarded because an earlier global LSN was lost
    discarded: int
    #: originating lane of each kept entry (parallel to ``entries``) —
    #: lets replay attribute each record's work to the lane that wrote
    #: it, so the cost model prices recovery at max-over-lanes instead
    #: of charging one serial stream
    lanes: List[int] = dataclasses.field(default_factory=list)


class MultiLog:
    """N-lane group-commit log over pool regions ``<name>.lane<i>``.

    Create by passing ``capacity`` (total bytes, split evenly over
    ``lanes``); reopen by name alone — the lane regions are discovered
    from the pool directory and merged recovery runs automatically.
    Region names are capped at 20 bytes, so ``name`` must leave room for
    the ``.lane<i>`` suffix.

    ``gen_sets >= 2`` makes the log *generational*: a ring of
    ``gen_sets`` lane sets (regions ``<name>.g<j>.lane<i>``, generation
    ``g`` living in slot ``(g-1) % gen_sets``) plus a ping-pong header
    region ``<name>.gen``. ``capacity`` is then *per generation*;
    :meth:`roll` seals the live generation and moves appends to the next
    set with LSNs restarting at 1, so a checkpoint-driven consumer (the
    KV redo log) can run indefinitely in ``gen_sets × capacity`` bytes
    of PMem. A generational log is reopened generational automatically.
    """

    def __init__(self, pool, name: str, *, lanes: Optional[int] = None,
                 capacity: Optional[int] = None,
                 technique: Optional[str] = None,
                 group_commit: int = DEFAULT_GROUP_COMMIT,
                 cfg: Optional[LogConfig] = None,
                 lane_id_base: int = 0,
                 gen_sets: int = 1,
                 lane_sockets: Optional[List[int]] = None,
                 lane_cpu_sockets: Optional[List[int]] = None,
                 placer=None) -> None:
        """Open-or-create the log.

        Args:
            pool: the :class:`repro_torch.pool.Pool` holding the lane regions.
            name: base region name; lane regions are ``<name>.lane<i>``
                (or ``<name>.g<j>.lane<i>`` when generational).
            lanes: stripe width when creating (default 2); on reopen the
                durable directory decides and a conflicting value raises.
            capacity: total log bytes when creating (per generation for
                a generational log), split evenly over the lanes.
            technique: per-lane log technique when creating (default
                "zero"); on reopen the durable record decides.
            group_commit: appends buffered per lane before an automatic
                batch commit (1 = commit every append immediately). With
                a placer this is the *base* of per-lane adaptive sizes
                (see :attr:`lane_group_commit`).
            cfg: :class:`~repro_torch.core.log.LogConfig` for the lanes.
            lane_id_base: first lane id used for per-lane stats
                attribution (the :class:`~repro_torch.io.IOEngine` hands out
                non-overlapping ranges).
            gen_sets: size of the generation ring; 1 (default) is the
                plain non-generational log.
            lane_sockets: NUMA home socket per lane region when creating
                (default: the placer spreads them round-robin, or all 0);
                on reopen the durable tags decide and a conflicting list
                raises.
            lane_cpu_sockets: explicit CPU socket per lane — pins where
                each lane *executes*, overriding the placer (benchmarks
                force far-socket-only placement with this).
            placer: :class:`~repro_torch.io.placer.LanePlacer` consulted for
                region spreading, CPU placement and dynamic group-commit
                sizing. Defaults to the pool's placer on a multi-socket
                pool; pass ``placer=False`` to disable.
        """
        self.pool = pool
        self.name = name
        self.group_commit = max(1, int(group_commit))
        self.lane_id_base = int(lane_id_base)
        #: spill scheduler registered via ``attach_spill`` (generational)
        self._spill = None
        if placer is None and getattr(pool, "sockets", 1) > 1:
            placer = pool.placer()
        self._placer = placer or None
        self._lane_cpu_override = lane_cpu_sockets

        gen_rec = pool.directory.lookup(f"{name}.gen")
        if (gen_rec is None and int(gen_sets) > 1
                and pool.directory.lookup(f"{name}.lane0") is not None):
            # upgrading in place would create a fresh empty ring and
            # orphan every committed entry in the existing lane regions
            raise ValueError(
                f"multilog {name!r} exists as a non-generational log; it "
                f"cannot be reopened with gen_sets={gen_sets} (recreate "
                f"it under a new name, or open without gen_sets)")
        self.generational = gen_rec is not None or int(gen_sets) > 1
        if self.generational:
            self._init_generational(lanes, capacity, technique, cfg,
                                    int(gen_sets), lane_sockets,
                                    existing=gen_rec is not None)
            return

        self.gen_sets = 1
        existing = 0
        while pool.directory.lookup(f"{name}.lane{existing}") is not None:
            existing += 1
        if existing:
            if lanes is not None and lanes != existing:
                raise ValueError(
                    f"multilog {name!r} has {existing} durable lanes, "
                    f"caller asked for {lanes}")
            self.lanes = existing
            self.handles = [pool.log(f"{name}.lane{i}", technique=technique,
                                     cfg=cfg)
                            for i in range(existing)]
        else:
            if capacity is None:
                raise ValueError(
                    f"creating multilog {name!r} requires capacity=")
            self.lanes = int(lanes) if lanes is not None else 2
            if self.lanes < 1:
                raise ValueError("lanes must be >= 1")
            per_lane = pool.geometry.pad_to_block(
                max(1, int(capacity) // self.lanes))
            # Fail BEFORE creating lane 0: a failure mid-loop would leak
            # durable lane regions (directory allocations are permanent),
            # leaving a partially-striped log behind.
            last_name = f"{name}.lane{self.lanes - 1}"
            if len(last_name.encode("utf-8")) > 20:
                raise ValueError(
                    f"multilog name {name!r} too long for {self.lanes} "
                    f"lanes ({last_name!r} exceeds the 20 B region-name cap)")
            if self.lanes * per_lane > pool.free_bytes:
                raise ValueError(
                    f"multilog {name!r}: {self.lanes} lanes x {per_lane} B "
                    f"exceed the pool's {pool.free_bytes} free bytes")
            homes = self._home_sockets(lane_sockets)
            self.handles = [
                pool.log(f"{name}.lane{i}", capacity=per_lane,
                         technique=technique or "zero", cfg=cfg,
                         socket=homes[i])
                for i in range(self.lanes)
            ]
        self.technique = self.handles[0].technique
        self._setup_placement(lane_sockets)
        self._pending: List[List[bytes]] = [[] for _ in range(self.lanes)]
        self._pending_bytes: List[int] = [0] * self.lanes
        self._rr = 0
        self.recovered = self._merge_recovery()
        self._next_glsn = self.recovered.next_glsn
        self._live: List[Tuple[int, bytes]] = list(
            zip(self.recovered.glsns, self.recovered.entries))

    # ------------------------------------------------------- NUMA placement

    def _home_sockets(self, requested: Optional[List[int]]) -> List[int]:
        """Home socket per lane region for the create path: the caller's
        list, else the placer's round-robin spread, else all socket 0."""
        if requested is not None:
            if len(requested) != self.lanes:
                raise ValueError(
                    f"multilog {self.name!r}: {len(requested)} lane_sockets "
                    f"for {self.lanes} lanes")
            return [int(s) for s in requested]
        if self._placer is not None:
            return self._placer.spread(self.lanes)
        return [0] * self.lanes

    def _setup_placement(self, requested: Optional[List[int]]) -> None:
        """Resolve, from the (now open) lane handles' durable socket tags,
        where each lane's bytes live and which CPU socket runs it; seed
        the per-lane adaptive group-commit sizes."""
        #: NUMA home socket of each lane's region (durable directory tag)
        self.lane_sockets: List[int] = [h.record.socket for h in self.handles]
        if requested is not None and [int(s) for s in requested] != self.lane_sockets:
            raise ValueError(
                f"multilog {self.name!r} lanes live on sockets "
                f"{self.lane_sockets}, caller asked for {list(requested)} — "
                f"home sockets are fixed at creation")
        if self._lane_cpu_override is not None:
            if len(self._lane_cpu_override) != self.lanes:
                raise ValueError(
                    f"multilog {self.name!r}: {len(self._lane_cpu_override)} "
                    f"lane_cpu_sockets for {self.lanes} lanes")
            #: CPU socket each lane executes on
            self.lane_cpu: List[int] = [int(s) for s in self._lane_cpu_override]
        elif self._placer is not None:
            self.lane_cpu = self._placer.place(self.lane_sockets)
        else:
            self.lane_cpu = list(self.lane_sockets)   # run every lane near
        #: per-lane group-commit target (adapted by the placer; see
        #: LanePlacer.adapt_k) — starts at the configured base
        self._lane_k: List[int] = [self.group_commit] * self.lanes

    def lane_k(self, lane: Optional[int] = None):
        """Stable read-only view of the adaptive group-commit state.

        With no argument, returns a fresh list of every lane's current
        group-commit target (== ``group_commit`` everywhere until a
        placer adapts them to each lane's observed submit rate and
        socket distance).  With ``lane``, returns that single lane's
        target as an int.  This is the public surface consumers such as
        the serve-layer admission controller should read — the backing
        ``_lane_k`` array is private and may change representation.
        """
        if lane is None:
            return list(self._lane_k)
        return int(self._lane_k[lane])

    @property
    def lane_group_commit(self) -> List[int]:
        """Current per-lane group-commit sizes; alias for
        :meth:`lane_k` kept for existing callers."""
        return self.lane_k()

    # ------------------------------------------------------- generations

    def _init_generational(self, lanes: Optional[int],
                           capacity: Optional[int],
                           technique: Optional[str],
                           cfg: Optional[LogConfig],
                           gen_sets: int,
                           lane_sockets: Optional[List[int]] = None,
                           *, existing: bool) -> None:
        """Create or reopen the generation ring + header (see class doc).
        Lane ``i`` lives on the same home socket in every generation set,
        so placement survives rolls."""
        pool = self.pool
        name = self.name
        cl = pool.geometry.cache_line
        if existing:
            self._gen_root = pool.raw(f"{name}.gen")
            hdr = self._read_gen_header()
            if hdr is None:
                raise ValueError(f"multilog {name!r}: generation header "
                                 f"region exists but holds no valid slot")
            self._gen_counter, self.current_gen, self.retired_upto, \
                k, n_lanes = hdr
            if gen_sets > 1 and gen_sets != k:
                raise ValueError(
                    f"multilog {name!r} has {k} durable generation sets, "
                    f"caller asked for {gen_sets}")
            if lanes is not None and lanes != n_lanes:
                raise ValueError(
                    f"multilog {name!r} has {n_lanes} durable lanes, "
                    f"caller asked for {lanes}")
            self.gen_sets, self.lanes = k, n_lanes
            self._sets = [
                [pool.log(f"{name}.g{j}.lane{i}", technique=technique,
                          cfg=cfg) for i in range(self.lanes)]
                for j in range(self.gen_sets)
            ]
        else:
            if capacity is None:
                raise ValueError(
                    f"creating multilog {name!r} requires capacity=")
            if gen_sets < 2:
                raise ValueError("generational logs need gen_sets >= 2")
            self.gen_sets = gen_sets
            self.lanes = int(lanes) if lanes is not None else 2
            if self.lanes < 1:
                raise ValueError("lanes must be >= 1")
            per_lane = pool.geometry.pad_to_block(
                max(1, int(capacity) // self.lanes))
            last_name = f"{name}.g{self.gen_sets - 1}.lane{self.lanes - 1}"
            if len(last_name.encode("utf-8")) > 20:
                raise ValueError(
                    f"multilog name {name!r} too long for {self.gen_sets} "
                    f"generation sets x {self.lanes} lanes ({last_name!r} "
                    f"exceeds the 20 B region-name cap)")
            need = self.gen_sets * self.lanes * per_lane + 2 * cl
            if need > pool.free_bytes:
                raise ValueError(
                    f"multilog {name!r}: {self.gen_sets} generation sets x "
                    f"{self.lanes} lanes x {per_lane} B exceed the pool's "
                    f"{pool.free_bytes} free bytes")
            # Lane regions first, header last: the header's single-line
            # entry commit is the atomic creation point, and re-running
            # this path after a crash mid-creation reopens/creates the
            # lane regions idempotently.
            homes = self._home_sockets(lane_sockets)
            self._sets = [
                [pool.log(f"{name}.g{j}.lane{i}", capacity=per_lane,
                          technique=technique or "zero", cfg=cfg,
                          socket=homes[i])
                 for i in range(self.lanes)]
                for j in range(self.gen_sets)
            ]
            self._gen_root = pool.raw(f"{name}.gen", nbytes=2 * cl)
            self._gen_counter = 0
            self.current_gen = 1
            self.retired_upto = 0
            self._write_gen_header(1, 0)

        self._active = (self.current_gen - 1) % self.gen_sets
        self.handles = self._sets[self._active]
        self.technique = self.handles[0].technique
        self._setup_placement(lane_sockets)
        self._pending = [[] for _ in range(self.lanes)]
        self._pending_bytes = [0] * self.lanes
        self._rr = 0
        # Which ring slot holds which PMem-resident generation. Slots
        # holding only retired (spilled/discarded) generations are
        # conservatively dirty: a crash may have landed between the
        # retired-watermark commit and the slot re-zero.
        occupied: Dict[int, int] = {
            (g - 1) % self.gen_sets: g
            for g in range(self.retired_upto + 1, self.current_gen + 1)
        }
        self._sealed: Dict[int, List[Tuple[int, bytes]]] = {}
        self._slot_clean: Dict[int, bool] = {}
        for j in range(self.gen_sets):
            self._slot_clean[j] = False
            g = occupied.get(j)
            if g is None or j == self._active:
                continue
            rec = self._merge_recovery(self._sets[j])
            self._sealed[g] = list(zip(rec.glsns, rec.entries))
        self.recovered = self._merge_recovery()
        self._next_glsn = self.recovered.next_glsn
        self._live = list(zip(self.recovered.glsns, self.recovered.entries))

    def _read_gen_header(self) -> Optional[Tuple[int, int, int, int, int]]:
        """Durable generation header: max-counter slot of the ping-pong
        pair, or ``None`` if neither slot was ever written."""
        img = self._gen_root.durable_view()
        cl = self.pool.geometry.cache_line
        best = None
        for slot in range(2):
            rec = _GENHDR.unpack_from(img, slot * cl)
            if rec[0] and (best is None or rec[0] > best[0]):
                best = rec
        return best

    def _write_gen_header(self, current_gen: int, retired_upto: int) -> None:
        """Durably advance the generation header (one barrier; the slot
        fits a single cache line, so the commit is atomic)."""
        from repro_torch.core.persist import FlushKind
        self._gen_counter += 1
        slot = self._gen_counter % 2
        cl = self.pool.geometry.cache_line
        self._gen_root.store(
            slot * cl,
            _GENHDR.pack(self._gen_counter, current_gen, retired_upto,
                         self.gen_sets, self.lanes),
            streaming=True)
        self._gen_root.persist(slot * cl, _GENHDR.size, kind=FlushKind.NT)
        self.current_gen = current_gen
        self.retired_upto = retired_upto

    @property
    def generation(self) -> int:
        """The live generation number (1 for a non-generational log)."""
        return self.current_gen if self.generational else 1

    def attach_spill(self, spill) -> None:
        """Register the :class:`repro_torch.tier.SpillScheduler` that retires
        sealed generations to SSD (:meth:`roll` enqueues onto it, and
        reads of retired generations route through it).

        Sealed-but-unretired generations recovered at open time are
        re-enqueued here: a crash that landed between a roll and its
        drain must not leave the generation orphaned — without the
        re-enqueue, the next ring reuse would discard it while the
        watermark advanced past it."""
        self._spill = spill
        for g in sorted(getattr(self, "_sealed", {})):
            spill.enqueue_generation(self, g)

    def roll(self, spill=None) -> int:
        """Seal the live generation and start the next one. Returns the
        sealed generation's number.

        The sequence is: group-commit everything pending (the sealed
        content is now durable in the current lane set), make sure the
        target ring slot is free — if it still holds an unretired sealed
        generation, drain the spill scheduler (or, with no scheduler,
        advance the retired watermark: plain truncation) and re-zero it —
        then atomically advance the header to generation ``g+1``. A crash
        anywhere in between recovers consistently: before the header
        commit the old generation is still live; after it, the new
        (empty) one is.

        The sealed generation stays PMem-resident and readable
        (:meth:`read_generation`) until the scheduler durably retires it.
        """
        if not self.generational:
            raise RuntimeError(
                f"multilog {self.name!r} is not generational; create it "
                f"with gen_sets >= 2 to roll")
        spill = spill if spill is not None else self._spill
        self.commit()
        g = self.current_gen
        sealed = list(self._live)
        nxt = g + 1
        target = (nxt - 1) % self.gen_sets
        evictee = nxt - self.gen_sets   # generation previously in that slot
        if evictee >= 1 and evictee > self.retired_upto:
            if spill is not None:
                spill.drain()
            if evictee > self.retired_upto:
                # No scheduler (or the drain did not cover it): discard —
                # the ring slot is reclaimed and the generation's history
                # is gone, exactly the old reset() truncation semantics.
                self._write_gen_header(g, evictee)
                self._sealed.pop(evictee, None)
        if not self._slot_clean.get(target, False):
            for h in self._sets[target]:
                h.reset()
        self._sealed[g] = sealed
        self._write_gen_header(nxt, self.retired_upto)
        self._active = target
        self.handles = self._sets[target]
        self._slot_clean[target] = False
        self._pending = [[] for _ in range(self.lanes)]
        self._pending_bytes = [0] * self.lanes
        self._rr = 0
        self._next_glsn = 1
        self._live = []
        if spill is not None:
            spill.enqueue_generation(self, g)
        return g

    def mark_retired(self, gen: int) -> None:
        """Durably advance the retired watermark to ``gen`` (called by the
        spill scheduler once the generation is safely on SSD — SSD flush
        and map record first, THEN this; the watermark is what recovery
        consults, so a crash in between still recovers from PMem). Newly
        retired ring slots are re-zeroed for reuse."""
        if not self.generational:
            raise RuntimeError("not a generational multilog")
        if gen >= self.current_gen:
            raise ValueError(f"cannot retire the live generation {gen}")
        if gen <= self.retired_upto:
            return
        old = self.retired_upto
        self._write_gen_header(self.current_gen, gen)
        for g in range(old + 1, gen + 1):
            self._sealed.pop(g, None)
            slot = (g - 1) % self.gen_sets
            if slot == self._active:
                continue
            for h in self._sets[slot]:
                h.reset()
            self._slot_clean[slot] = True

    def sealed_generations(self) -> Dict[int, List[bytes]]:
        """PMem-resident sealed generations: ``{gen: [payload, ...]}`` for
        every generation that is sealed but not yet retired to SSD."""
        if not self.generational:
            return {}
        return {g: [p for _, p in items]
                for g, items in sorted(self._sealed.items())}

    def read_generation(self, gen: int, *, spill=None
                        ) -> Tuple[str, List[bytes]]:
        """Read one generation's payloads and report where they came from.

        Returns ``("pmem", entries)`` for the live or a sealed-but-
        unretired generation (recovered from the lane regions) and
        ``("ssd", entries)`` for a retired one (read through the spill
        scheduler, checksum-verified). The header's retired watermark
        decides — never both tiers, which is the crash-during-spill
        invariant ``tests/test_tier_props.py`` asserts."""
        if not self.generational:
            raise RuntimeError("not a generational multilog")
        if gen < 1 or gen > self.current_gen:
            raise ValueError(f"no generation {gen} (live is "
                             f"{self.current_gen})")
        if gen > self.retired_upto:
            if gen == self.current_gen:
                return "pmem", [p for _, p in self._live]
            return "pmem", [p for _, p in self._sealed.get(gen, [])]
        spill = spill if spill is not None else self._spill
        if spill is None:
            raise RuntimeError(
                f"generation {gen} is retired to SSD; pass the spill "
                f"scheduler that owns the spill map")
        return "ssd", spill.read_generation(self.name, gen)

    # ------------------------------------------------------------ recovery

    @staticmethod
    def _global_prefix(per_lane_entries: List[List[bytes]]
                       ) -> Tuple[Dict[int, Tuple[int, bytes]], int]:
        """Decode each lane's framed entries and find the longest
        contiguous global-LSN prefix 1..m present across lanes. Returns
        (glsn -> (lane, payload), m). The single source of truth for the
        merge invariant — used by both open-time recovery and the
        read-only :meth:`recover` preview."""
        items: Dict[int, Tuple[int, bytes]] = {}
        for lane_i, entries in enumerate(per_lane_entries):
            for raw in entries:
                (glsn,) = _GLSN.unpack_from(raw)
                items[glsn] = (lane_i, bytes(raw[_GLSN.size:]))
        m = 0
        while (m + 1) in items:
            m += 1
        return items, m

    def _merge_recovery(self, handles=None) -> MultiLogRecovered:
        handles = self.handles if handles is None else handles
        per_lane = [h.recovered for h in handles]
        items, m = self._global_prefix([rec.entries for rec in per_lane])
        keep = [0] * len(handles)
        for g in range(1, m + 1):
            keep[items[g][0]] += 1
        discarded = 0
        for lane_i, (h, rec) in enumerate(zip(handles, per_lane)):
            extra = len(rec.entries) - keep[lane_i]
            if extra > 0:
                discarded += extra
                self._truncate_lane(h, rec, keep[lane_i])
        return MultiLogRecovered(
            entries=[items[g][1] for g in range(1, m + 1)],
            glsns=list(range(1, m + 1)),
            next_glsn=m + 1,
            per_lane=[len(r.entries) for r in per_lane],
            discarded=discarded,
            lanes=[items[g][0] for g in range(1, m + 1)],
        )

    def _truncate_lane(self, handle, rec: RecoveredLog, kept: int) -> None:
        """Durably re-zero a lane's tail beyond its ``kept``-entry prefix,
        and rewind the writer, so discarded global LSNs can be re-issued."""
        keep_end = rec.offsets[kept] if kept < len(rec.offsets) else rec.tail
        span = rec.tail - keep_end
        pm = self.pool.pmem
        if span > 0:
            pm.store(handle.base + keep_end, np.zeros(span, dtype=np.uint8),
                     streaming=True)
            pm.sfence()
        w = handle._writer
        w.tail = keep_end
        w.next_lsn = kept + 1
        if isinstance(w, HeaderLog):
            # a stale (larger) durable size slot is harmless: recovery
            # stops at the zeroed bytes regardless (n == 0 breaks the scan)
            w._size = keep_end - w._data_start()
        handle.recovered = RecoveredLog(
            rec.entries[:kept], rec.lsns[:kept], keep_end, kept + 1,
            rec.offsets[:kept])

    # -------------------------------------------------------------- append

    def append(self, payload: bytes, *, sync: bool = False) -> int:
        """Submit one entry; returns its global LSN immediately.

        The entry becomes durable at the next :meth:`commit` (``sync=True``
        issues one right away). A lane whose buffer reaches ``group_commit``
        entries commits that batch automatically."""
        lane = self._rr
        # Reserve capacity at SUBMIT time: the lane's buffered batch must
        # always fit its region, so a later commit()/roll() can never
        # fail with "log full" (the invariant the KV auto-checkpoint
        # path relies on). If this entry would overflow the reservation,
        # flush the partial batch first; if it still does not fit, the
        # lane is genuinely full and nothing was submitted.
        w = self.handles[lane]._writer
        framed = w.stride(_GLSN.size + len(payload))
        if self._pending_bytes[lane] + framed > w.capacity - w.tail:
            self._commit_lane(lane, "capacity")
            if framed > w.capacity - w.tail:
                raise RuntimeError("log full")
        glsn = self._next_glsn
        self._next_glsn += 1
        self._rr = (self._rr + 1) % self.lanes
        self._pending[lane].append(_GLSN.pack(glsn) + payload)
        self._pending_bytes[lane] += framed
        if self.generational:
            self._live.append((glsn, bytes(payload)))
        if sync:
            self.commit()
        elif len(self._pending[lane]) >= self._lane_k[lane]:
            self._commit_lane(lane, "auto")
        return glsn

    def _commit_lane(self, lane: int, cause: str = "explicit") -> None:
        batch = self._pending[lane]
        if not batch:
            return
        with self.pool.pmem.lane(self.lane_id_base + lane,
                                 socket=self.lane_cpu[lane]):
            self.handles[lane].append_batch(batch)
        self._pending[lane] = []
        self._pending_bytes[lane] = 0
        if self._placer is not None:
            # dynamic group-commit sizing: a lane whose batches keep
            # filling grows its k (throughput-bound); one the caller
            # keeps fencing early shrinks it; remote lanes keep a higher
            # floor to amortize their costlier barriers
            self._lane_k[lane] = self._placer.adapt_k(
                self._lane_k[lane], len(batch), cause,
                remote=self.lane_cpu[lane] != self.lane_sockets[lane],
                base=self.group_commit)

    def commit(self) -> None:
        """Group-commit every buffered entry on every lane. After this
        returns, all previously appended entries are durable."""
        for lane in range(self.lanes):
            self._commit_lane(lane, "explicit")

    def reset(self) -> None:
        """Truncate in place: durably re-zero every (active-set) lane and
        restart the global LSN at 1. Pending un-committed entries are
        dropped. Generational logs should prefer :meth:`roll`, which
        preserves the sealed generation; ``reset`` is the bare per-lane
        primitive beneath it."""
        for h in self.handles:
            h.reset()
        self._pending = [[] for _ in range(self.lanes)]
        self._pending_bytes = [0] * self.lanes
        self._rr = 0
        self._next_glsn = 1
        self._live = []
        self.recovered = MultiLogRecovered([], [], 1, [0] * self.lanes, 0)

    def close(self, *, commit: bool = True) -> None:
        """Commit pending entries (unless ``commit=False``) and close
        every lane handle (all generation sets included)."""
        if commit:
            self.commit()
        for h in (h for s in getattr(self, "_sets", [self.handles])
                  for h in s):
            h.close()

    # --------------------------------------------------------------- misc

    @property
    def pending(self) -> int:
        """Entries buffered (submitted, not yet durable) across lanes."""
        return sum(len(b) for b in self._pending)

    @property
    def next_glsn(self) -> int:
        """Global LSN the next append will receive."""
        return self._next_glsn

    @property
    def next_lsn(self) -> int:
        """Alias for :attr:`next_glsn` — lets consumers treat a MultiLog
        and a single-lane :class:`~repro_torch.pool.LogHandle` uniformly."""
        return self._next_glsn

    def recover(self) -> MultiLogRecovered:
        """Re-run merged recovery against the current durable image (what
        a restart would see right now). Read-only: no truncation repair —
        the returned prefix is what a fresh open would keep."""
        items, m = self._global_prefix(
            [h.recover().entries for h in self.handles])
        return MultiLogRecovered(
            entries=[items[g][1] for g in range(1, m + 1)],
            glsns=list(range(1, m + 1)),
            next_glsn=m + 1,
            per_lane=[],
            discarded=len(items) - m,
            lanes=[items[g][0] for g in range(1, m + 1)],
        )

    def stats(self):
        """Pool-wide op-count delta since the first lane handle opened."""
        return self.handles[0].stats()

    def reset_stats(self) -> None:
        """Restart every lane handle's stats window."""
        for h in self.handles:
            h.reset_stats()
