"""PodAutoScaler: clamped-step replica actuator.

The port's copy of ``kube_sqs_autoscaler_tpu/scale/actuator.py``.

Reference counterpart: ``scale/scale.go:21-107``.  Semantics reproduced:

- ``scale_up`` (``scale/scale.go:54-79``): Get the deployment; on API error
  raise :class:`ScaleError` with the reference's context string, no scale.
  If ``current >= max``: Info log, return successfully (boundary no-op is
  success — this matters to the policy, which refreshes its cooldown
  timestamp on success, SURVEY.md §2.2-C2 item 8).  Else step by
  ``scale_up_pods`` clamped to max and write back the *whole* object
  (read-modify-write, no conflict retry — preserved, see SURVEY.md §7.3).
- ``scale_down`` (``scale/scale.go:81-107``): mirror image with the min
  clamp.

The orchestrator is abstracted by :class:`DeploymentAPI` — satisfied by the
in-memory :class:`~.fake.FakeDeploymentAPI` (tests) and the real
:class:`~.kube.KubeDeploymentAPI` (production), exactly like the reference's
client-go interface seam (``scale/scale.go:22``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Protocol

from ..core.types import ScaleError
from .objects import Deployment

log = logging.getLogger(__name__)


class DeploymentAPI(Protocol):
    """The slice of an orchestrator the actuator needs (one namespace)."""

    def get(self, name: str) -> Deployment:
        """Fetch a deployment by name; raises on API failure / not found."""
        ...

    def update(self, deployment: Deployment) -> Deployment:
        """Replace the deployment object; raises on API failure."""
        ...


@dataclass
class PodAutoScaler:
    """Bounded step scaler for one Deployment (``scale/scale.go:21-29``)."""

    client: DeploymentAPI
    max: int
    min: int
    scale_up_pods: int
    scale_down_pods: int
    deployment: str
    namespace: str

    def scale_up(self) -> None:
        try:
            deployment = self.client.get(self.deployment)
        except Exception as err:
            raise ScaleError(
                "Failed to get deployment from kube server, no scale up occurred"
            ) from err

        current = deployment.replicas
        if current >= self.max:
            log.info("More than max pods running. No scale up. Replicas: %d", current)
            return
        next_replicas = min(current + self.scale_up_pods, self.max)

        try:
            self.client.update(deployment.with_replicas(next_replicas))
        except Exception as err:
            raise ScaleError("Failed to scale up") from err
        log.info("Scale up successful. Replicas: %d", next_replicas)

    def scale_down(self) -> None:
        try:
            deployment = self.client.get(self.deployment)
        except Exception as err:
            raise ScaleError(
                "Failed to get deployment from kube server, no scale down occurred"
            ) from err

        current = deployment.replicas
        if current <= self.min:
            log.info("Less than min pods running. No scale down. Replicas: %d", current)
            return
        next_replicas = max(current - self.scale_down_pods, self.min)

        try:
            self.client.update(deployment.with_replicas(next_replicas))
        except Exception as err:
            raise ScaleError("Failed to scale down") from err
        log.info("Scale down successful. Replicas: %d", next_replicas)
