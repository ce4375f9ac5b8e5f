"""Per-request latency accounting on the modeled clock.

A request's latency is ``completion_ns - arrival_ns`` where completion
comes from the frontend's modeled service loop: the engine's busy time
is ``engine_time_ns`` over the exact PMem/SSD/cache op counts the
request batch executed, and queueing delay is the gap between a
request's arrival and when the engine got around to its batch. That
makes the tail percentiles *queueing-theoretic* quantities — p999
reflects the convolution of burst arrivals with slow batches (spills,
checkpoints), not a throughput average.

Percentiles use the nearest-rank method on the sorted latency list
(``ceil(q * n)``-th value): integer selection, no interpolation — so a
given request trace maps to bit-identical p50/p99/p999 on every
platform, which the determinism checks in ``benchmarks/serve_load.py``
and ``tests/test_serve.py`` rely on.

Shed requests are recorded separately and excluded from the latency
distribution (they were never served; counting them as zero-latency
successes or as infinite-latency failures would each distort the tail
in a different direction — the shed *count* is its own SLO dimension).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["percentile_ns", "LatencySummary", "LatencyRecorder"]


def percentile_ns(sorted_ns: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence:
    the ``ceil(q*n)``-th smallest value (q in (0, 1]). Deterministic
    integer selection — no interpolation."""
    n = len(sorted_ns)
    if n == 0:
        return 0.0
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    return float(sorted_ns[min(n - 1, max(0, math.ceil(q * n) - 1))])


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    """The percentile digest of one (tenant's or the whole run's)
    latency distribution, in microseconds of modeled time."""

    count: int
    shed: int
    p50_us: float
    p99_us: float
    p999_us: float
    mean_us: float
    max_us: float

    @property
    def served_frac(self) -> float:
        """Fraction of offered requests actually served (1 - shed rate)."""
        total = self.count + self.shed
        return self.count / total if total else 1.0


class LatencyRecorder:
    """Accumulates per-request completions and sheds, keyed by tenant.

    The frontend calls :meth:`record` as batches complete on the
    modeled clock and :meth:`shed` for requests the admission
    controller rejected; consumers read :meth:`summary` /
    :meth:`histogram` afterwards."""

    def __init__(self) -> None:
        self._lat: Dict[str, List[int]] = {}
        self._shed: Dict[str, int] = {}

    # ------------------------------------------------------------ intake

    def record(self, tenant: str, arrival_ns: int,
               completion_ns: int) -> int:
        """Record one served request; returns its latency (ns)."""
        lat = int(completion_ns) - int(arrival_ns)
        if lat < 0:
            raise ValueError(
                f"completion {completion_ns} precedes arrival {arrival_ns}")
        self._lat.setdefault(tenant, []).append(lat)
        return lat

    def shed(self, tenant: str) -> None:
        """Count one admission-rejected request (never served)."""
        self._shed[tenant] = self._shed.get(tenant, 0) + 1

    # ----------------------------------------------------------- readout

    def tenants(self) -> List[str]:
        """Every tenant that recorded at least one completion or shed."""
        return sorted(set(self._lat) | set(self._shed))

    def latencies_ns(self, tenant: Optional[str] = None) -> List[int]:
        """Ascending-sorted latency list (one tenant, or the whole run)."""
        if tenant is not None:
            return sorted(self._lat.get(tenant, []))
        out: List[int] = []
        for lats in self._lat.values():
            out.extend(lats)
        return sorted(out)

    def shed_count(self, tenant: Optional[str] = None) -> int:
        """Requests the admission controller rejected."""
        if tenant is not None:
            return self._shed.get(tenant, 0)
        return sum(self._shed.values())

    def summary(self, tenant: Optional[str] = None) -> LatencySummary:
        """Percentile digest (one tenant, or the whole run)."""
        lats = self.latencies_ns(tenant)
        shed = self.shed_count(tenant)
        if not lats:
            return LatencySummary(0, shed, 0.0, 0.0, 0.0, 0.0, 0.0)
        return LatencySummary(
            count=len(lats),
            shed=shed,
            p50_us=percentile_ns(lats, 0.50) / 1000.0,
            p99_us=percentile_ns(lats, 0.99) / 1000.0,
            p999_us=percentile_ns(lats, 0.999) / 1000.0,
            mean_us=sum(lats) / len(lats) / 1000.0,
            max_us=lats[-1] / 1000.0,
        )

    def histogram(self, tenant: Optional[str] = None, *,
                  base_us: float = 1.0,
                  factor: float = 2.0) -> List[Tuple[float, int]]:
        """Log-spaced latency histogram: ``(upper_bound_us, count)``
        rows, buckets doubling (by ``factor``) from ``base_us``; the
        last bucket absorbs the tail. Intended for example scripts —
        percentiles come from :meth:`summary`, not from buckets."""
        lats = self.latencies_ns(tenant)
        if not lats:
            return []
        bounds = [base_us]
        while bounds[-1] * 1000.0 < lats[-1]:
            bounds.append(bounds[-1] * factor)
        counts = [0] * len(bounds)
        for lat in lats:
            us = lat / 1000.0
            for i, b in enumerate(bounds):
                if us <= b:
                    counts[i] += 1
                    break
        return list(zip(bounds, counts))
