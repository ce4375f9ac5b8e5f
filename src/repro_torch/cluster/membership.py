"""Cluster membership: failure detection and slow-shard cordoning feed
view planning.

A view change needs a target shard set; these policies decide it. Both
are deterministic decision logic over injected clocks/observations —
the part that must be correct — simulated single-process here exactly
like the engines (the transport is jax.distributed in deployment).
They moved here from the seed ``repro_torch.distributed`` modules
(``fault_tolerance``/``straggler``), whose training-specific remainder
(elastic checkpoint assembly, gradient quorum) stays put:

  - :class:`HeartbeatRegistry` — hosts beat; misses past a deadline
    declare them dead. Dead shards should leave the next view.
  - :class:`BackupStepPolicy` — an EWMA straggler detector; persistent
    stragglers are cordoned. Cordoned shards should leave the next
    view before they drag the cluster's p99 with them (Wu
    arXiv:2005.07658: one slow partition sets the tail).
  - :func:`plan_view` — folds both into "the shard set the next
    ``ClusterKV.reshard`` should target".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Set

import numpy as np

__all__ = ["HeartbeatRegistry", "BackupStepPolicy", "plan_view"]


@dataclasses.dataclass
class HeartbeatRegistry:
    """Deadline-based failure detector: hosts call :meth:`beat`, a
    periodic :meth:`sweep` declares silent ones dead. Death is sticky —
    a late beat from a declared-dead host is ignored (it must rejoin
    through a view change, not un-die)."""

    deadline_s: float = 10.0

    def __post_init__(self) -> None:
        self._last: Dict[int, float] = {}
        self.dead: Set[int] = set()

    def beat(self, host: int, now: Optional[float] = None) -> None:
        """Record a heartbeat (``now`` injects a deterministic clock)."""
        if host in self.dead:
            return
        self._last[host] = time.monotonic() if now is None else now

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Declare hosts silent past the deadline dead; returns the
        newly dead."""
        now = time.monotonic() if now is None else now
        newly = [h for h, t in self._last.items()
                 if h not in self.dead and now - t > self.deadline_s]
        self.dead.update(newly)
        return newly

    @property
    def alive(self) -> List[int]:
        """Hosts that have beaten and are not declared dead."""
        return sorted(h for h in self._last if h not in self.dead)


@dataclasses.dataclass
class BackupStepPolicy:
    """EWMA straggler detector: hosts whose smoothed step time exceeds
    ``threshold ×`` the median are flagged; ``patience`` consecutive
    flags cordon the host (work continues on the survivors via a view
    change). Cordoning is sticky for the policy's lifetime."""

    threshold: float = 1.8       # × median EWMA step time
    patience: int = 3
    ewma: float = 0.3

    def __post_init__(self) -> None:
        self._t: Dict[int, float] = {}
        self._flags: Dict[int, int] = {}
        self.cordoned: Set[int] = set()

    def observe(self, host: int, step_time: float) -> None:
        """Fold one step-time sample into the host's EWMA."""
        prev = self._t.get(host, step_time)
        self._t[host] = (1 - self.ewma) * prev + self.ewma * step_time

    def evaluate(self) -> List[int]:
        """Flag outliers against the median; returns hosts newly
        cordoned this round."""
        active = {h: t for h, t in self._t.items() if h not in self.cordoned}
        if len(active) < 2:
            return []
        med = float(np.median(list(active.values())))
        newly = []
        for h, t in active.items():
            if t > self.threshold * med:
                self._flags[h] = self._flags.get(h, 0) + 1
                if self._flags[h] >= self.patience:
                    self.cordoned.add(h)
                    newly.append(h)
            else:
                self._flags[h] = 0
        return newly


def plan_view(current: Iterable[int],
              registry: Optional[HeartbeatRegistry] = None,
              policy: Optional[BackupStepPolicy] = None) -> List[int]:
    """The shard set the next view change should target: the current
    set minus dead (registry) and cordoned (policy) shards. Feed the
    result to ``ClusterKV.reshard``; raises if nobody survives (a view
    needs at least one shard)."""
    ids = {int(s) for s in current}
    if registry is not None:
        ids -= set(registry.dead)
    if policy is not None:
        ids -= set(policy.cordoned)
    if not ids:
        raise ValueError("no shards left for the next view")
    return sorted(ids)
