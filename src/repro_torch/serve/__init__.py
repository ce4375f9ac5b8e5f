"""``repro_torch.serve`` — multi-tenant request serving on the paper's engine.

The primitives below this layer (group-commit WAL lanes, batched block
flushes, the three-tier page cache) exist to serve *requests*; this
package is the request path that makes their interactions measurable:

* :mod:`repro_torch.serve.workload` — an open-loop traffic generator:
  thousands of modeled concurrent clients per tenant, Zipf key
  popularity, Poisson arrivals with burst phases, fully deterministic
  from one seed.
* :mod:`repro_torch.serve.frontend` — the scheduler/admission controller:
  batches arrivals into engine ops sized by the WAL's adaptive
  group-commit state (:meth:`MultiLog.lane_k`), sheds load per tenant
  when the modeled backlog would blow the SLO, and isolates tenants
  with per-owner cache quotas (:meth:`BufferManager.set_quota`).
* :mod:`repro_torch.serve.latency` — per-request queueing-delay accounting:
  p50/p99/p999 derived from ``engine_time_ns`` (completion vs arrival
  on the modeled clock — open-loop, so overload shows up as tail
  collapse, not just lower throughput).
* :mod:`repro_torch.serve.modelstate` — the "model-state serving" scenario:
  checkpoint shards of a ``repro_torch.configs`` model paged through the
  DRAM/PMem/SSD tiers.

Like everything in the repo the clock is modeled: exact op counts ×
calibrated constants. Wall time measures nothing here.
"""

from repro_torch.serve.frontend import ServeFrontend, ServeReport, SLOConfig
from repro_torch.serve.latency import LatencyRecorder, LatencySummary, percentile_ns
from repro_torch.serve.modelstate import ModelStateStore
from repro_torch.serve.workload import Request, TenantSpec, generate

__all__ = [
    "ServeFrontend",
    "ServeReport",
    "SLOConfig",
    "LatencyRecorder",
    "LatencySummary",
    "percentile_ns",
    "ModelStateStore",
    "Request",
    "TenantSpec",
    "generate",
]
