"""Open-loop traffic generation — the offered load half of serving.

Open loop means arrival times are fixed by the generator, not by the
server: a client does not wait for its previous request to complete
before issuing the next one (that would be closed-loop, which
self-throttles and hides tail collapse). Under open-loop load an
overloaded server's queue grows without bound and p99 explodes — the
effect the admission controller (:mod:`repro_torch.serve.frontend`) exists to
contain, and the one closed-loop benchmarks structurally cannot see.

Every stream is deterministic from ``(seed, tenant index)`` via
``np.random.SeedSequence`` — two runs with the same specs and seed
produce bit-identical request lists, which the serve benchmarks assert.

Shapes modeled per tenant (:class:`TenantSpec`):

* **Clients** — a population of modeled concurrent clients; each
  request is issued by one of them (round-trips are not serialized per
  client: open loop).
* **Zipf key popularity** — ranks drawn Zipf(``zipf_s``) and mapped
  through a per-tenant key permutation, so tenants disagree about
  which keys are hot.
* **Poisson arrivals with bursts** — exponential inter-arrivals at
  ``rate``; during a burst window (every ``burst_every_s`` seconds for
  ``burst_len_s``) the instantaneous rate is multiplied by
  ``burst_x``.
* **Op mix** — get/put/scan fractions; a scan touches ``scan_len``
  consecutive keys.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["TenantSpec", "Request", "generate"]

#: modeled-clock resolution: arrivals are integer nanoseconds
_NS = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape (see module docstring)."""

    #: tenant name; also the KV engine name the frontend creates for it
    #: (keep it short — region names cap at 20 bytes and the engine
    #: derives ``<name>.pages`` / ``<name>.wal`` / ``<name>.root``)
    name: str
    #: modeled concurrent client population
    clients: int = 100
    #: mean request rate, requests/second of modeled time
    rate: float = 10_000.0
    #: op mix — fractions must sum to 1
    get_frac: float = 0.8
    put_frac: float = 0.2
    scan_frac: float = 0.0
    #: Zipf skew for key popularity (values <= 1.0 mean uniform)
    zipf_s: float = 1.2
    #: keys touched by one scan request
    scan_len: int = 8
    #: burst phase: every ``burst_every_s`` seconds the arrival rate is
    #: multiplied by ``burst_x`` for ``burst_len_s`` seconds (0 = none)
    burst_every_s: float = 0.0
    burst_len_s: float = 0.0
    burst_x: float = 1.0

    def __post_init__(self) -> None:
        if abs(self.get_frac + self.put_frac + self.scan_frac - 1.0) > 1e-9:
            raise ValueError(
                f"tenant {self.name!r}: op fractions sum to "
                f"{self.get_frac + self.put_frac + self.scan_frac}, not 1")
        if self.clients < 1 or self.rate <= 0:
            raise ValueError(f"tenant {self.name!r}: need clients >= 1 "
                             f"and rate > 0")


@dataclasses.dataclass(frozen=True)
class Request:
    """One request of the offered load, fixed before serving starts."""

    #: global arrival-order id (assigned after the cross-tenant merge)
    rid: int
    tenant: str
    #: issuing client within the tenant's population
    client: int
    #: arrival on the modeled clock, ns
    arrival_ns: int
    #: ``"get"`` | ``"put"`` | ``"scan"``
    op: str
    key: int
    #: keys covered when ``op == "scan"`` (1 otherwise)
    scan_len: int
    #: deterministic seed for the put value (unique per request, so a
    #: shed request's value is recognizably absent from the store)
    vseed: int


def _tenant_stream(spec: TenantSpec, ti: int, nkeys: int,
                   duration_s: float, seed: int) -> List[Request]:
    """One tenant's arrival stream (rids are assigned later, globally)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, ti]))
    perm = rng.permutation(nkeys)
    out: List[Request] = []
    t = 0.0
    while True:
        rate = spec.rate
        if spec.burst_every_s > 0 and spec.burst_len_s > 0:
            if (t % spec.burst_every_s) < spec.burst_len_s:
                rate *= spec.burst_x
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            break
        u = float(rng.random())
        if u < spec.get_frac:
            op, slen = "get", 1
        elif u < spec.get_frac + spec.put_frac:
            op, slen = "put", 1
        else:
            op, slen = "scan", spec.scan_len
        if spec.zipf_s > 1.0:
            rank = min(int(rng.zipf(spec.zipf_s)) - 1, nkeys - 1)
        else:
            rank = int(rng.integers(0, nkeys))
        key = int(perm[rank])
        if op == "scan":
            key = min(key, max(0, nkeys - slen))
        out.append(Request(
            rid=-1,
            tenant=spec.name,
            client=int(rng.integers(0, spec.clients)),
            arrival_ns=int(round(t * _NS)),
            op=op,
            key=key,
            scan_len=slen,
            vseed=int(rng.integers(0, 1 << 31)),
        ))
    return out


def generate(tenants: Sequence[TenantSpec], *, nkeys: int,
             duration_s: float, seed: int = 0,
             limit: Optional[int] = None) -> List[Request]:
    """The full offered load: every tenant's stream merged in arrival
    order (ties broken by tenant position, so the merge — and therefore
    every downstream percentile — is bit-stable across runs).

    ``limit`` truncates the merged list (benchmark smoke sizing).
    Returns requests with final ``rid`` values 0..n-1 in arrival order.
    """
    if nkeys < 1:
        raise ValueError("nkeys must be >= 1")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    merged: List[Request] = []
    for ti, spec in enumerate(tenants):
        merged.extend(_tenant_stream(spec, ti, nkeys, duration_s, seed))
    order = {t.name: i for i, t in enumerate(tenants)}
    merged.sort(key=lambda r: (r.arrival_ns, order[r.tenant], r.vseed))
    if limit is not None:
        merged = merged[:limit]
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(merged)]
