"""In-memory fake orchestrator.

The port's copy of ``kube_sqs_autoscaler_tpu/scale/fake.py``.

Equivalent of client-go's ``fake.NewSimpleClientset`` as the reference's
tests use it (``scale/scale_test.go:85-105``, ``main_test.go:243-261``): a
namespace-scoped Deployment store implementing the full
:class:`~.actuator.DeploymentAPI` surface in memory, so the production
actuator runs unmodified against it.

Like the client-go fake, objects are copied on the way in and out — mutating
a returned ``Deployment`` does not change the store until ``update`` is
called.  Error injection hooks (``fail_next_get`` / ``fail_next_update``)
cover the error paths the reference never tests (SURVEY.md §4 gaps).
"""

from __future__ import annotations

import threading

from .objects import Deployment


class NotFoundError(KeyError):
    """Deployment does not exist (client-go would return a 404 StatusError)."""


class FakeDeploymentAPI:
    """In-memory, thread-safe Deployment store for one namespace."""

    def __init__(self, namespace: str, deployments: list[Deployment] | None = None):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._store: dict[str, Deployment] = {}
        self.get_calls = 0
        self.update_calls = 0
        self.fail_next_get: Exception | None = None
        self.fail_next_update: Exception | None = None
        for deployment in deployments or []:
            self._store[deployment.name] = deployment.clone()

    @classmethod
    def with_deployments(
        cls, namespace: str, replicas: int, *names: str
    ) -> "FakeDeploymentAPI":
        """Pre-seeded store, like the reference's two-deployment fixture
        (``main_test.go:243-261`` seeds ``deploy`` and ``deploy-no-scale``)."""
        return cls(
            namespace,
            [Deployment(name=n, namespace=namespace, replicas=replicas) for n in names],
        )

    def get(self, name: str) -> Deployment:
        with self._lock:
            self.get_calls += 1
            if self.fail_next_get is not None:
                err, self.fail_next_get = self.fail_next_get, None
                raise err
            if name not in self._store:
                raise NotFoundError(f'deployments.apps "{name}" not found')
            return self._store[name].clone()

    def update(self, deployment: Deployment) -> Deployment:
        with self._lock:
            self.update_calls += 1
            if self.fail_next_update is not None:
                err, self.fail_next_update = self.fail_next_update, None
                raise err
            if deployment.name not in self._store:
                raise NotFoundError(f'deployments.apps "{deployment.name}" not found')
            self._store[deployment.name] = deployment.clone()
            return deployment.clone()

    def replicas(self, name: str) -> int:
        """Test convenience: current stored replica count."""
        with self._lock:
            if name not in self._store:
                raise NotFoundError(f'deployments.apps "{name}" not found')
            return self._store[name].replicas


class RecordingDeploymentAPI:
    """Recorder + persistent-failure proxy over a DeploymentAPI.

    The restart episodes' shared evidence collector: timestamps every successful
    replica write on the injected clock — the cooldown-violation
    evidence — and counts/timestamps every attempt that reached the
    "apiserver" — the breaker's did-an-RPC-happen evidence.  ``fail``
    holds the apiserver down persistently (the one-shot
    ``fail_next_update`` hook cannot keep it down long enough to open a
    breaker)."""

    def __init__(self, inner, clock) -> None:
        self.inner = inner
        self.clock = clock
        self.fail = False
        self.update_attempts: list = []  # t of every RPC that reached us
        self.scale_times: list = []  # (t, replicas) successful writes

    def get(self, name):
        return self.inner.get(name)

    def update(self, deployment):
        self.update_attempts.append(self.clock.now())
        if self.fail:
            raise RuntimeError("apiserver down")
        self.scale_times.append((self.clock.now(), deployment.replicas))
        return self.inner.update(deployment)
