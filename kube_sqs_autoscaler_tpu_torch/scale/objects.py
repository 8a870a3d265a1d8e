"""Minimal Deployment object model.

The port's copy of ``kube_sqs_autoscaler_tpu/scale/objects.py``.

The actuator only reads and writes ``spec.replicas`` of one named Deployment
(``scale/scale.go:60-70``), but — like the reference, which round-trips the
*whole* typed Deployment object through ``Get``/``Update``
(``scale/scale.go:55,72``) — we carry the full raw object so a real
API-server write is a faithful read-modify-write of the entire resource, not
a patch.  (The reference deliberately does not use the Scale subresource or
conflict retries; SURVEY.md §7.3 says to preserve, not fix, that.)
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Deployment:
    """A Deployment as the actuator sees it: identity + replicas + raw body."""

    name: str
    namespace: str
    replicas: int
    raw: dict[str, Any] = field(default_factory=dict)

    def clone(self) -> "Deployment":
        """Deep, independent copy.

        Equivalent to ``copy.deepcopy(self)`` but ~10x cheaper: only ``raw``
        is mutable and so needs the deep copy (and most objects in the
        fake-store hot path carry an empty one); ``dataclasses.replace``
        carries every other field — including any added later — verbatim.
        """
        return dataclasses.replace(
            self, raw=copy.deepcopy(self.raw) if self.raw else {}
        )

    def with_replicas(self, replicas: int) -> "Deployment":
        """Copy with a new replica count, keeping the raw body in sync."""
        raw = copy.deepcopy(self.raw)
        if raw:
            raw.setdefault("spec", {})["replicas"] = int(replicas)
        return Deployment(
            name=self.name,
            namespace=self.namespace,
            replicas=int(replicas),
            raw=raw,
        )

    @classmethod
    def from_raw(cls, raw: dict[str, Any]) -> "Deployment":
        """Build from a Kubernetes apps/v1 JSON object."""
        meta = raw.get("metadata", {})
        spec = raw.get("spec", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            # apiserver semantics: spec.replicas defaults to 1 when unset
            replicas=int(spec.get("replicas", 1)),
            raw=copy.deepcopy(raw),
        )
