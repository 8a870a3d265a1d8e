"""Actuator layer: replica scalers over an orchestrator API.

The port's copy of ``kube_sqs_autoscaler_tpu/scale/``.  Two actuators
satisfy the :class:`~..core.types.Scaler` seam: :class:`PodAutoScaler` (a
Deployment's replica integer) and the in-process serving fleet's
:class:`~..fleet.WorkerPool` (re-exported lazily here, so importing this
package imports no part of the serving stack).  Standard library only.
"""

from .actuator import PodAutoScaler
from .fake import FakeDeploymentAPI, NotFoundError, RecordingDeploymentAPI
from .objects import Deployment

__all__ = [
    "PodAutoScaler",
    "FakeDeploymentAPI",
    "NotFoundError",
    "RecordingDeploymentAPI",
    "Deployment",
    "WorkerPool",
]


def __getattr__(name):
    if name == "WorkerPool":
        from ..fleet import WorkerPool

        return WorkerPool
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
