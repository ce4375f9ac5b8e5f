"""Step-granular training write-ahead log — Zero logging in production.

The latency-critical log of the paper maps to the per-step training record:
(step, data cursor, RNG key, loss, grad-norm, loss scale). It is on the
critical path of every training step (the step is not "committed" until the
record is durable — exactly a transaction commit), so the technique with the
fewest persistency barriers wins: Zero logging, ONE barrier per step.

Records are fixed-size and cache-line padded (Fig. 6's ≈8× lesson), so the
WAL also never rewrites a line. On restart the WAL gives the exact resume
point: the last durable step, its RNG key, and the data-pipeline cursor —
replaying the pipeline deterministically with no re-read of earlier batches.

Construction goes through :class:`repro_torch.pool.Pool` — ``pool.wal(name)`` or
:meth:`TrainWAL.on_pool` — which open-or-create a named log region and
recover automatically; the WAL never computes a byte offset itself (all
layout lives behind the pool directory). ``pool.wal(name, lanes=N,
group_commit=k)`` runs the WAL on the repro_torch.io engine's
:class:`~repro_torch.io.MultiLog` instead: N zero-log lanes, k steps amortized
per persistency barrier (data-parallel trainers whose replicas commit
steps concurrently). The legacy ``TrainWAL(pmem, base, capacity)``
signature survives only as a deprecation shim: it formats (or attaches)
a pool directory over the caller's region and opens the WAL as the
named region ``train_wal`` inside it — ``base`` must be 0 and is not a
raw offset into anything; nonzero values are rejected.
"""

from __future__ import annotations

import dataclasses
import struct
import warnings
from typing import List, Optional, Tuple

__all__ = ["StepRecord", "TrainWAL"]

_REC = struct.Struct("<QQQQfffQ")  # step, cursor, rng_hi, rng_lo, loss, gnorm, lscale, t_ns

#: cache-line-padded bytes per record in a Zero log (header + record < 128)
_BYTES_PER_STEP = 128


@dataclasses.dataclass(frozen=True)
class StepRecord:
    step: int
    data_cursor: int
    rng_key: Tuple[int, int]      # (hi, lo) of a jax PRNG key's raw words
    loss: float
    grad_norm: float
    loss_scale: float
    time_ns: int = 0

    def pack(self) -> bytes:
        return _REC.pack(
            self.step, self.data_cursor, self.rng_key[0], self.rng_key[1],
            self.loss, self.grad_norm, self.loss_scale, self.time_ns,
        )

    @classmethod
    def unpack(cls, buf: bytes) -> "StepRecord":
        s, c, hi, lo, loss, gn, ls, t = _REC.unpack(buf[: _REC.size])
        return cls(s, c, (hi, lo), loss, gn, ls, t)


class TrainWAL:
    """Training WAL over a pool log region. Technique defaults to "zero"
    (the paper's result); "classic"/"header" remain available as baselines
    so the end-to-end benefit is measurable."""

    #: directory region name used by the legacy shim
    _LEGACY_REGION = "train_wal"

    def __init__(
        self,
        pmem=None,
        base: int = 0,
        capacity: Optional[int] = None,
        *,
        technique: str = "zero",
        recover: bool = False,
        _handle=None,
    ) -> None:
        """Open the WAL. Preferred: :meth:`on_pool` / ``pool.wal(name)``
        (``_handle`` carries the pool log handle). The positional
        ``(pmem, base, capacity)`` form is the deprecated shim described
        in the module docstring: it adopts the region as a pool and opens
        the ``train_wal`` directory region — no raw offsets are used, and
        ``base`` must be 0. ``recover=False`` on the shim starts a fresh
        generation over an existing region instead of resuming it."""
        if _handle is None:
            # Legacy shim: adopt the caller's raw region as a pool. The
            # directory lives at the head, so base must be 0; the log gets
            # whatever the directory does not use (clamped to `capacity`).
            from repro_torch.pool import Pool
            warnings.warn(
                "TrainWAL(pmem, base, capacity) raw-region construction is "
                "deprecated; use pool.wal(name) / TrainWAL.on_pool(pool, "
                "name) instead", DeprecationWarning, stacklevel=2)
            if pmem is None:
                raise TypeError("TrainWAL needs a pool handle or a PMem")
            if base != 0:
                raise ValueError(
                    "raw base offsets are no longer supported; allocate a "
                    "region through repro_torch.pool.Pool instead")
            pool = Pool.attach(pmem)
            if pool.directory.lookup(self._LEGACY_REGION) is not None:
                # the durable record decides the technique on reopen
                _handle = pool.log(self._LEGACY_REGION)
                if not recover:
                    # legacy recover=False meant "fresh WAL over this
                    # region": start a new generation instead of silently
                    # resuming the old one
                    _handle.reset()
            else:
                cap = min(capacity if capacity is not None else pool.free_bytes,
                          pool.free_bytes)
                _handle = pool.log(self._LEGACY_REGION, capacity=cap,
                                   technique=technique)
        from repro_torch.io.multilog import MultiLog
        self.log = _handle
        self._multilog = isinstance(_handle, MultiLog)
        self.technique = _handle.technique
        self.records: List[StepRecord] = [
            StepRecord.unpack(e) for e in _handle.recovered.entries
        ]

    @classmethod
    def on_pool(cls, pool, name: str = "train_wal", *,
                capacity_steps: Optional[int] = None,
                technique: Optional[str] = None,
                lanes: int = 1, group_commit: int = 1,
                gen_sets: int = 1) -> "TrainWAL":
        """Open-or-create a named WAL region on ``pool``.

        ``capacity_steps`` is required when creating; on open it is
        *verified* against the durable region (a region cannot grow, so
        asking for more steps than it holds raises rather than failing
        thousands of steps later with a full log). ``technique`` defaults
        to "zero" when creating; on open the directory record decides.

        ``lanes > 1`` creates the WAL on a lane-striped group-commit
        :class:`~repro_torch.io.MultiLog` (regions ``<name>.lane<i>``): commits
        batch ``group_commit`` steps per barrier, and ``commit_step``
        grows a ``sync=`` knob. A WAL created multi-lane is reopened
        multi-lane automatically (the lane regions are discovered). On a
        multi-socket pool the lane regions are spread over the sockets
        and each lane runs near its region (the pool's
        :class:`~repro_torch.io.placer.LanePlacer`).

        ``gen_sets >= 2`` (multi-lane only) puts the WAL on a generation
        ring: ``capacity_steps`` is then *per generation*, and
        :meth:`roll` seals the live generation at a checkpoint so the
        step log stops growing without bound (sealed generations stay
        recoverable until a spill scheduler retires them to SSD). A
        generational WAL is reopened generational automatically."""
        from repro_torch.io.multilog import MultiLog
        multi_exists = (pool.directory.lookup(f"{name}.lane0") is not None
                        or pool.directory.lookup(f"{name}.gen") is not None)
        single_exists = pool.directory.lookup(name) is not None
        if single_exists and lanes > 1:
            raise ValueError(
                f"WAL {name!r} exists as a single-lane region; it cannot "
                f"be reopened with lanes={lanes} (recreate it, or open "
                f"with lanes=1)")
        if gen_sets > 1 and single_exists:
            raise ValueError(
                f"WAL {name!r} exists as a single-lane region; it cannot "
                f"be reopened with gen_sets={gen_sets} (recreate it)")
        # the generation ring runs on the MultiLog even at lanes=1
        if multi_exists or ((lanes > 1 or gen_sets > 1) and not single_exists):
            if multi_exists:
                handle = MultiLog(pool, name, technique=technique,
                                  group_commit=group_commit,
                                  gen_sets=gen_sets)
                if capacity_steps is not None:
                    held = sum(h.record.length for h in handle.handles)
                    if held < capacity_steps * _BYTES_PER_STEP:
                        raise ValueError(
                            f"WAL {name!r} holds {held} B across "
                            f"{handle.lanes} lanes, caller asked for "
                            f"{capacity_steps} steps "
                            f"({capacity_steps * _BYTES_PER_STEP} B) — "
                            f"durable regions cannot grow")
            else:
                if capacity_steps is None:
                    raise ValueError(
                        f"creating WAL {name!r} requires capacity_steps=")
                capacity = (capacity_steps * _BYTES_PER_STEP
                            + 4096 * max(1, lanes))
                handle = MultiLog(pool, name, lanes=lanes, capacity=capacity,
                                  technique=technique or "zero",
                                  group_commit=group_commit,
                                  gen_sets=gen_sets)
            return cls(_handle=handle)
        if single_exists:
            capacity = (capacity_steps * _BYTES_PER_STEP
                        if capacity_steps is not None else None)
            handle = pool.log(name, capacity=capacity, technique=technique)
        else:
            if capacity_steps is None:
                raise ValueError(
                    f"creating WAL {name!r} requires capacity_steps=")
            handle = pool.log(name,
                              capacity=capacity_steps * _BYTES_PER_STEP + 4096,
                              technique=technique or "zero")
        return cls(_handle=handle)

    def commit_step(self, record: StepRecord, *, sync: bool = True) -> int:
        """Commit a training step (one barrier under single-lane Zero).

        On a multi-lane WAL, ``sync=False`` buffers the record for group
        commit — it becomes durable with the next full batch or
        :meth:`flush`; the returned LSN is assigned immediately."""
        if self._multilog:
            lsn = self.log.append(record.pack(), sync=sync)
        else:
            lsn = self.log.append(record.pack())
        self.records.append(record)
        return lsn

    def flush(self) -> None:
        """Force group commit of any buffered steps (multi-lane WAL)."""
        if self._multilog:
            self.log.commit()

    @property
    def generational(self) -> bool:
        """Whether this WAL runs on a generation ring (``gen_sets >= 2``)."""
        return bool(getattr(self.log, "generational", False))

    def roll(self) -> int:
        """Seal the live WAL generation and start the next one (checkpoint
        truncation for a generational WAL — the in-memory ``records``
        history is kept; the sealed generation stays recoverable until a
        spill scheduler retires it). Returns the sealed generation."""
        if not self.generational:
            raise RuntimeError(
                "TrainWAL.roll needs a generational WAL — create it with "
                "pool.wal(lanes=N, gen_sets>=2)")
        return self.log.roll()

    @property
    def last(self) -> Optional[StepRecord]:
        return self.records[-1] if self.records else None

    def barriers_per_step(self) -> float:
        """Persistency barriers per committed step — amortized over the
        group-commit batch on a multi-lane WAL."""
        if self._multilog:
            per_batch = self.log.handles[0].barriers_per_append
            return per_batch / self.log.group_commit
        return self.log.barriers_per_append

    @classmethod
    def capacity_for(cls, steps: int, *, lanes: int = 1,
                     gen_sets: int = 1) -> int:
        """Bytes for a pool region holding a `steps`-step WAL (directory
        overhead included; a multi-lane WAL adds per-lane slack and
        block-padding on top of the striped capacity; a generational WAL
        holds ``gen_sets`` lane sets of ``steps`` each plus the ring
        header)."""
        from repro_torch.pool import Pool
        per_set = steps * _BYTES_PER_STEP + 8192 + 8192 * max(1, lanes)
        return (max(1, gen_sets) * per_set + 8192
                + Pool.overhead_bytes())
