"""The serving fleet: ControlLoop-actuated ContinuousWorker replicas.

The port's copy of ``kube_sqs_autoscaler_tpu/fleet/``.
:class:`WorkerPool` implements the :class:`~..core.types.Scaler` seam over
in-process serving replicas, :class:`ShardedWorkerPool` over the shard
masks of one gang-stepped serving plane; :class:`FleetDriver` interleaves
serving cycles with control ticks.  ``FleetWorker`` (``fleet.worker``) is
imported when a pool builds a worker, so importing this package imports
no torch and builds no kernel.
"""

from .pool import (
    DEAD,
    DRAINING,
    REPLICA_STATE_CODES,
    SERVING,
    STOPPED,
    FleetDriver,
    FleetEvent,
    Replica,
    WorkerPool,
)
from .sharded import (
    INACTIVE,
    PROBING,
    QUARANTINED,
    SHARD_HEALTH_CODES,
    SHARD_STATE_CODES,
    ShardedWorkerPool,
)

__all__ = [
    "DEAD",
    "DRAINING",
    "INACTIVE",
    "PROBING",
    "QUARANTINED",
    "REPLICA_STATE_CODES",
    "SERVING",
    "SHARD_HEALTH_CODES",
    "SHARD_STATE_CODES",
    "STOPPED",
    "FleetDriver",
    "FleetEvent",
    "Replica",
    "ShardedWorkerPool",
    "WorkerPool",
]
