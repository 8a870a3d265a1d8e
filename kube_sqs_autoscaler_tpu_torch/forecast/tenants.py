"""Per-tenant depth signals for the forecaster seam.

The port's copy of ``kube_sqs_autoscaler_tpu/forecast/tenants.py``.  A
control loop without it scales on ONE number — the shared queue's
total depth — so a thousand staged requests from a weight-0.1 batch
tenant and a thousand from a tight-SLO interactive tenant look
identical to the autoscaler.  This module makes the loop scale on *who*
is arriving, not just how much:

- :class:`TenantDepthHistory` — per-tenant :class:`~.history.DepthHistory`
  ring buffers (bounded tenant cardinality: past ``max_tenants``
  distinct labels, new ones fold into a catch-all, the same discipline
  as the serving side's Prometheus attribution tables), fed from the
  workers' fair-admission staged depths
  (:meth:`~..fleet.pool.WorkerPool.staged_by_tenant`);
- :func:`slo_urgency_weights` — how much one staged request of each
  tenant is WORTH to the autoscaler: a tenant whose TTFT SLO is 4×
  tighter than the loosest configured SLO needs capacity 4× sooner, so
  its backlog counts 4× (SLO-free tenants count 1×);
- :class:`TenantAwareDepth` — a :class:`~..core.types.DepthPolicy`
  that boosts the depth the gates threshold on to
  ``max(observed, ceil(Σ staged_t × weight_t))``, optionally running a
  per-tenant :class:`~.forecasters.Forecaster` over each ring buffer so
  the boost anticipates each tenant's trajectory at ``now + horizon``.
  Conservative by construction (like ``PredictivePolicy``): the boost
  can only raise the gates' depth, never mask a real backlog, so the up
  gate fires no later than it would on the raw observation and every
  reference cooldown subtlety is untouched.

It imports no torch: the forecasters are optional collaborators passed in
by the caller.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Callable, Mapping

from .history import DepthHistory

if TYPE_CHECKING:
    from .forecasters import Forecaster

#: Distinct tenant ring buffers kept before new labels fold into the
#: catch-all (labels come from untrusted message bodies — same bound
#: discipline as ``workloads.service.MAX_TENANT_SERIES``).
MAX_TENANT_HISTORIES = 512
OTHER_TENANTS = "~other"


class TenantDepthHistory:
    """Per-tenant staged-depth ring buffers on the loop's clock.

    ``observe`` takes the whole per-tenant depth map at once (the shape
    :meth:`~..fleet.pool.WorkerPool.staged_by_tenant` hands out); a
    tenant absent from one observation records an explicit 0 — a
    drained tenant's forecast must decay, not freeze at its last
    backlog.  Tenant cardinality is bounded: past ``max_tenants``
    distinct labels, new ones aggregate into ``~other``.
    """

    def __init__(self, capacity: int = 128,
                 max_tenants: int = MAX_TENANT_HISTORIES) -> None:
        if max_tenants < 1:
            raise ValueError(f"max_tenants={max_tenants} must be >= 1")
        self.capacity = capacity
        self.max_tenants = max_tenants
        self._histories: dict[str, DepthHistory] = {}

    def _key(self, tenant: str) -> str:
        if tenant in self._histories or \
                len(self._histories) < self.max_tenants:
            return tenant
        return OTHER_TENANTS

    def observe(self, t: float, depths: Mapping[str, float]) -> None:
        folded: dict[str, float] = {}
        for tenant, depth in depths.items():
            key = self._key(tenant)
            folded[key] = folded.get(key, 0.0) + float(depth)
        for tenant in self._histories:
            folded.setdefault(tenant, 0.0)
        for tenant, depth in folded.items():
            history = self._histories.get(tenant)
            if history is None:
                history = self._histories[tenant] = DepthHistory(
                    self.capacity
                )
            history.observe(t, depth)

    def tenants(self) -> list[str]:
        return sorted(self._histories)

    def history(self, tenant: str) -> DepthHistory | None:
        return self._histories.get(tenant)

    def latest(self) -> dict[str, float]:
        """Most recent depth per tenant (0.0 for never-observed)."""
        out: dict[str, float] = {}
        for tenant, history in self._histories.items():
            _, depths, n = history.snapshot()
            out[tenant] = float(depths[n - 1]) if n else 0.0
        return out

    def forecast(
        self, forecaster: Forecaster, horizon: float,
        min_samples: int = 3,
    ) -> dict[str, float]:
        """Per-tenant predicted depth at ``now + horizon`` (falls back
        to the latest observation below ``min_samples``)."""
        out: dict[str, float] = {}
        for tenant, history in self._histories.items():
            times, depths, n = history.snapshot()
            if n < min_samples:
                out[tenant] = float(depths[n - 1]) if n else 0.0
                continue
            out[tenant] = max(
                0.0, float(forecaster.predict(times, depths, n, horizon))
            )
        return out


def slo_urgency_weights(tenancy) -> dict[str, float]:
    """One staged request's worth per tenant, from the TTFT SLOs.

    The loosest configured SLO anchors weight 1.0; a tenant whose SLO
    is k× tighter weighs k× (its backlog must clear k× sooner, so it
    should move the autoscaler k× as hard).  SLO-free tenants weigh
    1.0 — with no SLOs configured at all every weight is 1.0 and the
    weighted depth degenerates to the plain staged total.
    """
    slos = [s for s in getattr(tenancy, "ttft_slo_s", ()) if s > 0]
    anchor = max(slos) if slos else 0.0
    return {
        tenant: (anchor / slo if (slo := tenancy.slo_of(tenant)) > 0
                 else 1.0)
        for tenant in tenancy.tenants
    }


class TenantAwareDepth:
    """DepthPolicy: the gates see the SLO-weighted tenant backlog.

    ``depths_fn`` supplies the live per-tenant staged depths (e.g.
    ``pool.staged_by_tenant``); each call records them into the ring
    buffers and computes ``ceil(Σ depth_t × weight_t)`` — with a
    ``forecaster``, ``depth_t`` is ``max(latest, forecast@now+horizon)``
    per tenant, so a ramping tenant's weight kicks in a horizon early.
    The returned depth is ``max(observed, weighted)`` fed through the
    optional ``inner`` policy (chain a ``PredictivePolicy`` to keep the
    total-depth forecast too): monotone in the observation, so the up
    gate can never fire later than reactive and a weighted dip alone
    never sheds replicas.
    """

    def __init__(
        self,
        depths_fn: Callable[[], Mapping[str, float]],
        tenancy,
        *,
        inner=None,
        forecaster: Forecaster | None = None,
        horizon: float = 0.0,
        history: TenantDepthHistory | None = None,
        min_samples: int = 3,
    ) -> None:
        if horizon < 0:
            raise ValueError(f"horizon must be >= 0, got {horizon}")
        self.depths_fn = depths_fn
        self.weights = slo_urgency_weights(tenancy)
        self.inner = inner
        self.forecaster = forecaster
        self.horizon = float(horizon)
        self.min_samples = min_samples
        self.history = history or TenantDepthHistory()
        self.name = "tenant-aware" + (
            f":{forecaster.name}" if forecaster is not None else ""
        )
        # scoreboard: what the gates last saw vs the raw observation
        self.last_weighted: float = 0.0
        self.last_depths: dict[str, float] = {}

    def _weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def effective_messages(self, now: float, num_messages: int) -> int:
        depths = dict(self.depths_fn() or {})
        self.history.observe(now, depths)
        if self.forecaster is not None and self.horizon > 0:
            predicted = self.history.forecast(
                self.forecaster, self.horizon, self.min_samples
            )
            for tenant, forecast_depth in predicted.items():
                depths[tenant] = max(
                    depths.get(tenant, 0.0), forecast_depth
                )
        weighted = sum(
            depth * self._weight(tenant)
            for tenant, depth in depths.items()
        )
        self.last_weighted = weighted
        self.last_depths = depths
        boosted = max(int(num_messages), int(math.ceil(weighted)))
        if self.inner is not None:
            return self.inner.effective_messages(now, boosted)
        return boosted
