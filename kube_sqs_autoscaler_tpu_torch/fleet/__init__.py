"""The serving fleet: ControlLoop-actuated ContinuousWorker replicas.

The port's copy of ``kube_sqs_autoscaler_tpu/fleet/`` without the sharded
pool.  :class:`WorkerPool` implements the :class:`~..core.types.Scaler`
seam over in-process serving replicas; :class:`FleetDriver` interleaves
serving cycles with control ticks.  ``FleetWorker`` (``fleet.worker``) is
imported when a pool builds a replica, so importing this package imports
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

__all__ = [
    "DEAD",
    "DRAINING",
    "REPLICA_STATE_CODES",
    "SERVING",
    "STOPPED",
    "FleetDriver",
    "FleetEvent",
    "Replica",
    "WorkerPool",
]
