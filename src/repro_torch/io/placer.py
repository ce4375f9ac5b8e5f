"""NUMA-aware lane placement — which CPU socket runs which lane.

The paper's bandwidth results are per-socket; Izraelevitz et al. ("Basic
Performance Measurements of the Intel Optane DC Persistent Memory
Module", arXiv:1903.05714) measure far-socket PMem access at roughly
2-3x the cost of near-socket: every store crosses the UPI interconnect,
the DIMM's write-combining buffer merges less, and persist barriers wait
for the remote ADR domain. The functional layer models this as *home*
sockets on byte ranges (:meth:`repro_torch.core.pmem.PMem.set_home`, threaded
through the pool directory's per-region socket tags) and CPU sockets on
lanes (``PMem.lane(i, socket=s)``); the cost model charges a lane's
remote work the ``numa_remote_*`` multipliers.

:class:`LanePlacer` is the policy above that mechanism, consulted by
:class:`~repro_torch.io.multilog.MultiLog`, :class:`~repro_torch.io.flushq.FlushQueue`
and :class:`~repro_torch.io.engine.IOEngine` (automatically on any multi-socket
pool — ``pool.placer()``):

* :meth:`spread` — where to *create* lane regions: round-robin over the
  sockets, so every lane can later be served by a near-socket CPU within
  the per-socket lane budget.
* :meth:`place` — which CPU socket *runs* each lane: near its region's
  home socket while that socket has CPU lane capacity left, falling back
  to a remote socket only under load (more lanes than near capacity).
  Placement is a performance hint, never a durability input — recovery
  is byte-identical under any placement (asserted in
  ``tests/test_numa.py``).
* :meth:`adapt_k` — dynamic group-commit sizing: a lane whose batches
  keep filling (throughput-bound — submits arrive faster than commits)
  doubles its batch toward ``k_max``; a lane mostly cut short by
  explicit commits (latency-bound) halves back toward 1. Remote lanes
  keep a higher floor: their barriers cost
  ``numa_remote_barrier_mult`` x as much, so twice the appends should
  share each one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.costmodel import COST_MODEL, PMemCostModel

__all__ = ["LanePlacer"]

#: CPU lanes a single socket serves at full near-socket speed before the
#: placer starts overflowing to remote sockets. Matches the cost model's
#: ``wc_defeat_lanes``: past ~4 concurrent writers per socket the DIMM's
#: write-combining buffer stops merging anyway (Fig. 2a), so there is no
#: near-socket throughput left to protect.
DEFAULT_CPU_LANES_PER_SOCKET = 4


class LanePlacer:
    """Near-socket-first lane placement + adaptive group-commit sizing."""

    def __init__(self, pmem, *,
                 cpu_lanes_per_socket: int = DEFAULT_CPU_LANES_PER_SOCKET,
                 cost_model: PMemCostModel = COST_MODEL) -> None:
        """Bind to a :class:`~repro_torch.core.pmem.PMem`'s socket topology.

        Args:
            pmem: the PMem whose ``sockets`` count defines the topology.
            cpu_lanes_per_socket: near-socket CPU lane budget per socket;
                lanes beyond it are placed remote (the "under load"
                fallback).
            cost_model: supplies the remote multipliers the adaptive
                group-commit floor is derived from.
        """
        self.pmem = pmem
        self.cpu_lanes_per_socket = max(1, int(cpu_lanes_per_socket))
        self.cost_model = cost_model

    @property
    def sockets(self) -> int:
        """Socket count of the bound topology."""
        return max(1, self.pmem.sockets)

    # ------------------------------------------------------------ placement

    def spread(self, n_lanes: int) -> List[int]:
        """Home sockets for ``n_lanes`` *new* lane regions: round-robin
        over the topology, so each socket serves an equal share and
        :meth:`place` can keep every lane near until the per-socket CPU
        budget is exhausted."""
        return [i % self.sockets for i in range(int(n_lanes))]

    def place(self, region_sockets: Sequence[int]) -> List[int]:
        """CPU socket for each lane, given its region's home socket.

        Near-socket first: a lane runs on its region's socket while that
        socket has CPU capacity (``cpu_lanes_per_socket``) left. Only
        under load — more lanes homed on a socket than it can serve —
        do the overflow lanes fall back to the socket with the most
        remaining capacity (remote, paying the Izraelevitz penalty).
        With *every* socket saturated, lanes oversubscribe their home
        socket instead: going remote then adds interconnect cost without
        adding CPU capacity (the cost model's oversaturation decay is
        the operative penalty there)."""
        free = {s: self.cpu_lanes_per_socket for s in range(self.sockets)}
        cpu: List[Optional[int]] = [None] * len(region_sockets)
        for i, home in enumerate(region_sockets):
            near = min(max(0, int(home)), self.sockets - 1)
            if free[near] > 0:
                cpu[i] = near
                free[near] -= 1
        for i, c in enumerate(cpu):
            if c is not None:
                continue
            best = max(free, key=lambda s: free[s])
            if free[best] > 0:
                free[best] -= 1
                cpu[i] = best       # remote fallback, only under load
            else:
                cpu[i] = min(max(0, int(region_sockets[i])),
                             self.sockets - 1)   # saturated: stay near
        return cpu  # type: ignore[return-value]

    def distance(self, cpu_socket: int, home_socket: int) -> int:
        """0 for a near-socket lane, 1 for a remote one."""
        return 0 if int(cpu_socket) == int(home_socket) else 1

    # ------------------------------------------------- dynamic group commit

    def adapt_k(self, k: int, batch_len: int, cause: str, *,
                remote: bool, base: int) -> int:
        """Next group-commit size for a lane that just committed a batch.

        Args:
            k: the lane's current batch-size target.
            batch_len: entries in the batch just committed.
            cause: why the commit happened — ``"auto"`` (the buffer
                filled: throughput-bound), ``"capacity"`` (submit-time
                reservation forced an early flush: also throughput-bound)
                or ``"explicit"`` (caller ``commit()``/``sync``:
                latency-bound when the batch was still small).
            remote: whether the lane runs far from its region's socket.
            base: the log's configured ``group_commit`` (scales the caps).

        ``base == 1`` is a *durability contract* — the caller wants every
        append durable at return (the PersistentKV default) — so the
        placer never batches beyond it; adaptive sizing engages only for
        callers that already opted into batched durability (base >= 2).
        """
        base = max(1, int(base))
        if base == 1:
            return 1
        floor = min(2 * base, base + 2) if remote else 1
        cap = max(8 * base, floor)
        if cause in ("auto", "capacity") and batch_len >= k:
            # submits outpace commits: amortize more appends per barrier
            k = min(cap, max(k * 2, floor))
        elif cause == "explicit" and batch_len * 2 <= k:
            # the caller keeps fencing half-empty batches: shrink toward
            # per-append durability
            k = max(floor, (k + 1) // 2)
        return max(floor, min(int(k), cap))
