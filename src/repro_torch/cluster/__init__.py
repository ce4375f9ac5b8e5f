"""repro_torch.cluster — sharded multi-engine KV with crash-consistent view
changes.

N independent :class:`~repro_torch.core.recovery.PersistentKV` engines (each
its own pool, WAL lanes, spill tier and cache) behind a durable
rendezvous-hashed range map (:class:`ShardMap`), routed by
:class:`ClusterKV`, resharded live by view changes whose per-range
commit point is one durable ownership record — the spill protocol's
down-tier-first ordering generalized to cross-shard handoff (copy →
flush → ownership record → invalidate). Membership policies
(:class:`HeartbeatRegistry`, :class:`BackupStepPolicy`,
:func:`plan_view`) decide which shard set the next view targets.
Proven by ``tests/test_cluster_acceptance.py`` and the
crash-mid-reshard corpus in ``tests/test_crash_corpus.py``.
"""

from repro_torch.cluster.membership import (BackupStepPolicy, HeartbeatRegistry,
                                      plan_view)
from repro_torch.cluster.router import (CausalSession, ClusterConfig, ClusterKV,
                                  ReshardReport, ViewChange)
from repro_torch.cluster.shardmap import ShardMap, rendezvous_owner

__all__ = ["BackupStepPolicy", "CausalSession", "ClusterConfig", "ClusterKV",
           "HeartbeatRegistry", "ReshardReport", "ShardMap", "ViewChange",
           "plan_view", "rendezvous_owner"]
