"""Partition-tolerant multi-process coherence runtime.

The worker axis of the ``(W, window)`` directory planes is sharded
across N OS processes (``shard.py``: deterministic full-width replicas
with slice ownership, each holding its planes on its device), fronted by
a control plane (``control.py``) that owns membership and heartbeat
failure detection (``membership.py``), per-RPC deadlines with backoff
retries and partition/kill injection (``rpc.py``), barrier-cut composed
checkpoints, and degraded-mode recovery that replays a failed shard's
suffix to a bit-equal finish.
"""
from repro_torch.cluster.control import (ClusterReport, ClusterResult,
                                         ClusterRuntime, ReplicaDivergence)
from repro_torch.cluster.membership import (HeartbeatDetector,
                                            MembershipTable, ShardState)
from repro_torch.cluster.rpc import ShardChannel, ShardDown, ShardError
from repro_torch.cluster.shard import make_runtime, state_digest

__all__ = [
    "ClusterReport", "ClusterResult", "ClusterRuntime",
    "ReplicaDivergence", "HeartbeatDetector", "MembershipTable",
    "ShardState", "ShardChannel", "ShardDown", "ShardError",
    "make_runtime", "state_digest",
]
