"""comms/ — scheduled collectives: typed, overlappable data movement.

Cross-shard and cross-plane byte moves (evacuation KV, prefix
installs, handoff KV gathers, settle pulls) become typed
:class:`~.ops.TransferOp` values on a :class:`~.scheduler.\
CollectiveScheduler` that dispatches them device-side inside the
engine's dispatch-ahead window — while the next gang block is in
flight — instead of paying a blocking host round-trip at settle time
(the port's copy of ``kube_sqs_autoscaler_tpu/comms/``).

- :mod:`.ops` — the four-kind transfer taxonomy, size buckets, and
  the settle-pull constructor over the engines' pinned host copies;
- :mod:`.scheduler` — queueing, small-op coalescing (one batched
  dispatch per destination per cycle), the
  ``transfer_dispatches`` / ``transfer_bytes`` /
  ``overlapped_transfers_total`` counter family, lifecycle
  ``transfer`` spans, and the ``sched/`` safety-net flush event;
- :mod:`.topology` — the fleet as a link graph (ring / 2D mesh /
  torus / host-staged two-tier constructors, derived from the live
  serving geometry) — the WHICH-ROUTE half;
- :mod:`.routing` — the route planner (disjoint-path chunking for
  large ops, latency-minimal paths for small), the per-link
  virtual-time ledger, and the routed-vs-WHEN-only schedule
  simulator.
"""

from .ops import (  # noqa: F401
    EVACUATION_KV,
    HANDOFF_KV,
    PREFIX_INSTALL,
    SETTLE_PULL,
    SIZE_BUCKET_LABELS,
    SMALL_OP_BYTES,
    TRANSFER_KINDS,
    TransferOp,
    array_nbytes,
    settle_pull_op,
    size_bucket,
)
from .routing import (  # noqa: F401
    PIPELINE_BYTES,
    LinkLedger,
    RouteChunk,
    RoutePlan,
    RoutePlanner,
    ScheduleResult,
    assert_no_oversubscription,
    simulate_schedule,
)
from .scheduler import CollectiveScheduler  # noqa: F401
from .topology import (  # noqa: F401
    TOPOLOGY_KINDS,
    Link,
    Topology,
    mesh2d_topology,
    ring_topology,
    topology_from_geometry,
    two_tier_topology,
)

__all__ = [
    "CollectiveScheduler",
    "Link",
    "LinkLedger",
    "PIPELINE_BYTES",
    "RouteChunk",
    "RoutePlan",
    "RoutePlanner",
    "ScheduleResult",
    "TOPOLOGY_KINDS",
    "Topology",
    "assert_no_oversubscription",
    "mesh2d_topology",
    "ring_topology",
    "simulate_schedule",
    "topology_from_geometry",
    "two_tier_topology",
    "EVACUATION_KV",
    "HANDOFF_KV",
    "PREFIX_INSTALL",
    "SETTLE_PULL",
    "SIZE_BUCKET_LABELS",
    "SMALL_OP_BYTES",
    "TRANSFER_KINDS",
    "TransferOp",
    "array_nbytes",
    "settle_pull_op",
    "size_bucket",
]
