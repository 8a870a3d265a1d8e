"""ShardedWorkerPool: the ``Scaler`` seam over shard mask flips.

The port's copy of ``kube_sqs_autoscaler_tpu/fleet/sharded.py`` without
the lifecycle hook.  A :class:`~.pool.WorkerPool` scales by spawning and draining
whole replicas, each stepped from Python in turn; this pool holds one
:class:`~.worker.FleetWorker` over a
:class:`~..workloads.shard_plane.ShardedBatcher`, and its replica count is
the plane's active-shard count.  Through the seam it behaves as
``PodAutoScaler`` and ``WorkerPool`` do (steps clamped to ``[min, max]``,
a boundary no-op is success, an injected failure raises
:class:`~..core.types.ScaleError` and changes nothing):

- ``scale_down`` drains the newest serving shards: their masks flip off,
  their rows in flight finish, and an emptied shard turns inactive;
- ``scale_up`` resurrects draining shards first (newest drain first), then
  activates inactive ones, lowest index first;
- replies stay exactly-once through the reply registry of
  :class:`~.pool.FleetPoolBase`, as in the replica pool.

The shard is a failure domain of its own.  Each cycle the pool reads the
plane's health sentinels, which ride the plane's one settle copy: a shard
they indict is **quarantined** (masked off), its rows in flight are
**evacuated** (re-prefilled onto healthy shards through one resume insert,
or handed back to the queue), after ``probe_after_cycles`` it is
**probed** (mask on, one request), and a clean probe **readmits** it.

With tenancy the plane's worker stages per tenant and routes prefixed
admissions to sticky tenant homes over per-shard prefix pools; the tenant
homes and the admission accounting (and, with admission shards, the
sharded admission plane's state) ride :meth:`ShardedWorkerPool.export_state`
as its ``admission`` section, and the admission shards are a failure
domain of their own (:meth:`ShardedWorkerPool.kill_admission_shard`,
:meth:`ShardedWorkerPool.partition_admission_shard`).
Importing this module imports no torch: :meth:`ShardedWorkerPool.serving`
imports the worker when it builds it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from ..core.clock import Clock
from .pool import DRAINING, SERVING, FleetPoolBase

log = logging.getLogger(__name__)

builtins_min = min
builtins_max = max

# mask off, nothing in flight (a shard has no process to lose, so it is
# never dead or stopped)
INACTIVE = "inactive"
# masked off by the health sentinels, rows evacuated, not resurrected by
# scale_up; then the breaker's half-open twin, one request let through
QUARANTINED = "quarantined"
PROBING = "probing"
SHARD_STATE_CODES = {
    SERVING: 0, DRAINING: 1, INACTIVE: 2, QUARANTINED: 3, PROBING: 4,
}
# shard_health gauge codes (0 = healthy)
SHARD_HEALTH_CODES = {
    SERVING: 0, DRAINING: 0, INACTIVE: 0, PROBING: 1, QUARANTINED: 2,
}


class ShardedWorkerPool(FleetPoolBase):
    """A Scaler whose replica count is the active-shard count of one
    gang-stepped serving plane.

    ``worker_factory(pool)`` builds the one worker (:meth:`serving` wires a
    :class:`~.worker.FleetWorker` over the plane; the contract tests pass
    a stub).  ``max`` defaults to, and may not exceed, the plane's
    allocated shards: activation is a mask flip, not a spawn."""

    def __init__(
        self,
        worker_factory: Callable[["ShardedWorkerPool"], Any],
        *,
        min: int,
        max: int | None = None,
        scale_up_pods: int = 1,
        scale_down_pods: int = 1,
        initial: int | None = None,
        clock: Clock | None = None,
        replied_capacity: int = 65536,
        hang_grace_cycles: int = 3,
        probe_after_cycles: int = 8,
    ) -> None:
        if scale_up_pods < 1 or scale_down_pods < 1:
            raise ValueError("scale step sizes must be >= 1")
        if hang_grace_cycles < 2:
            # one settle without progress is legitimate: the gang engine
            # reads block N a cycle after dispatching it
            raise ValueError("hang_grace_cycles must be >= 2")
        if probe_after_cycles < 1:
            raise ValueError("probe_after_cycles must be >= 1")
        super().__init__(clock=clock, replied_capacity=replied_capacity)
        self.worker = worker_factory(self)
        self.shards = self.worker.batcher.shards
        # this pool re-decodes a NaN-flagged shard's rows after quarantine,
        # so the plane may discard that shard's settled block whole
        if hasattr(self.worker.batcher, "discard_bad_blocks"):
            self.worker.batcher.discard_bad_blocks = True
        if max is None:
            max = self.shards
        if not 1 <= min <= max:
            raise ValueError(f"need 1 <= min ({min}) <= max ({max})")
        if max > self.shards:
            raise ValueError(
                f"max ({max}) exceeds the plane's allocated shards "
                f"({self.shards}); activation is a mask flip, not a spawn"
            )
        self.min = min
        self.max = max
        self.scale_up_pods = scale_up_pods
        self.scale_down_pods = scale_down_pods
        if initial is None:
            initial = min
        if not min <= initial <= max:
            raise ValueError(f"initial ({initial}) must be within [min, max]")
        self.hang_grace_cycles = hang_grace_cycles
        self.probe_after_cycles = probe_after_cycles
        self.quarantined_total = 0
        self.rows_evacuated_total = 0
        self.released_total = 0
        self.readmitted_total = 0
        self._quarantined_at: dict[int, int] = {}
        # shards quarantined while draining: a passed probe resumes the
        # drain the Scaler ordered instead of readmitting them
        self._drain_on_readmit: set[int] = set()
        self.shard_states = [
            SERVING if s < initial else INACTIVE for s in range(self.shards)
        ]
        for s in range(self.shards):
            self.worker.batcher.set_shard_active(s, s < initial)
            if s < initial:
                self._event("shard-activate", shard=s)

    # -- the Scaler seam --------------------------------------------------

    @property
    def replicas(self) -> int:
        """Serving shards, the plane's ``spec.replicas`` (draining shards
        excluded, like the replica pool's draining members)."""
        return sum(1 for st in self.shard_states if st == SERVING)

    def scale_up(self) -> None:
        self._injected_failure("up")
        current = self.replicas
        if current >= self.max:
            log.info(
                "More than max shards active. No scale up. Shards: %d",
                current,
            )
            return
        target = builtins_min(current + self.scale_up_pods, self.max)
        draining = [s for s in reversed(range(self.shards))
                    if self.shard_states[s] == DRAINING]
        inactive = [s for s in range(self.shards)
                    if self.shard_states[s] == INACTIVE]
        for shard in (draining + inactive)[: target - current]:
            self.shard_states[shard] = SERVING
            self.worker.batcher.set_shard_active(shard, True)
            self._event("shard-activate", shard=shard)
        log.info("Scale up successful. Shards: %d", self.replicas)

    def scale_down(self) -> None:
        self._injected_failure("down")
        current = self.replicas
        if current <= self.min:
            log.info(
                "Less than min shards active. No scale down. Shards: %d",
                current,
            )
            return
        target = builtins_max(current - self.scale_down_pods, self.min)
        serving = [s for s in reversed(range(self.shards))
                   if self.shard_states[s] == SERVING]
        for shard in serving[: current - target]:
            # newest first; the mask flip stops admission, rows in flight
            # finish on the gang step
            self.shard_states[shard] = DRAINING
            self.worker.batcher.set_shard_active(shard, False)
            self._event("shard-drain-start", shard=shard,
                        inflight=self.worker.batcher.shard_busy(shard))
        log.info("Scale down successful. Shards: %d", self.replicas)

    # -- the serving cycle -----------------------------------------------

    def run_cycle(self) -> int:
        """One worker cycle (refill, gang step, settle) however many shards
        are active, then supervision: quarantine what the sentinels indict,
        retire emptied draining shards, advance the probes.  Returns the
        requests completed."""
        self.cycle += 1
        done = self.worker.run_once()
        self._supervise_shards()
        for shard, state in enumerate(self.shard_states):
            if (state == DRAINING
                    and self.worker.batcher.shard_busy(shard) == 0):
                self.shard_states[shard] = INACTIVE
                self._event("shard-deactivate", shard=shard)
        self._probe_shards()
        self._update_metrics()
        return done

    # -- the shard failure domain ------------------------------------------

    def _supervise_shards(self) -> None:
        """Quarantine every shard the plane's settle-time sentinels
        indict."""
        suspects = getattr(self.worker.batcher, "shard_suspects", None)
        if suspects is None:  # contract-test stubs have no health surface
            return
        for shard, cause in suspects(self.hang_grace_cycles):
            if self.shard_states[shard] != QUARANTINED:
                self._quarantine(shard, cause)

    def _quarantine(self, shard: int, cause: str) -> None:
        batcher = self.worker.batcher
        if self.shard_states[shard] == DRAINING:
            self._drain_on_readmit.add(shard)
        elif self.shard_states[shard] == SERVING:
            self._drain_on_readmit.discard(shard)
        self.shard_states[shard] = QUARANTINED
        self._quarantined_at[shard] = self.cycle
        # the mask write stops the router and re-asserts the device bit
        # (it heals a corrupted mask too)
        batcher.set_shard_active(shard, False)
        batcher.shard_probing[shard] = False
        batcher.clear_shard_health(shard)
        self.quarantined_total += 1
        evacuated, released = self.worker.evacuate_shard(shard)
        self.rows_evacuated_total += evacuated
        self.released_total += released
        self._event("shard-quarantine", shard=shard, cause=cause,
                    evacuated=evacuated, released=released)
        log.warning(
            "Shard %d quarantined (%s); evacuated %d row(s) to healthy "
            "shards, released %d to the queue",
            shard, cause, evacuated, released,
        )

    def _probe_shards(self) -> None:
        """After ``probe_after_cycles`` a quarantined shard turns PROBING
        (mask on, room for one request).  A probing shard whose last
        settled block had busy rows, no stall, no NaN flag and gang tokens
        (or a completion: a budget-1 row never enters a gang block) is
        readmitted, or resumes its drain if it was draining; a probe that
        trips a sentinel is quarantined again by the supervision pass."""
        batcher = self.worker.batcher
        for shard, state in enumerate(self.shard_states):
            if state == QUARANTINED:
                if (self.cycle - self._quarantined_at[shard]
                        >= self.probe_after_cycles):
                    self.shard_states[shard] = PROBING
                    batcher.set_shard_active(shard, True)
                    batcher.shard_probing[shard] = True
                    self._event("shard-probe", shard=shard)
            elif state == PROBING:
                bad = batcher.last_health_bad
                clean = (
                    batcher.last_settle_busy[shard] > 0
                    and batcher.shard_stall_cycles[shard] == 0
                    and not (bad is not None and bool(bad[shard]))
                    and (batcher.shard_last_gang_progress[shard] > 0
                         or batcher.shard_last_completed[shard] > 0)
                )
                if not clean:
                    continue
                resume_drain = shard in self._drain_on_readmit
                batcher.shard_probing[shard] = False
                self.readmitted_total += 1
                if resume_drain:
                    self._drain_on_readmit.discard(shard)
                    self.shard_states[shard] = DRAINING
                    batcher.set_shard_active(shard, False)
                else:
                    self.shard_states[shard] = SERVING
                self._event("shard-readmit", shard=shard,
                            resumed_drain=resume_drain)
                log.info("Shard %d passed its probe; %s", shard,
                         "resuming its drain" if resume_drain
                         else "re-admitted")

    # -- deterministic fault injection (sim.faults.FleetFaultPlan) ---------

    def poison_shard(self, shard: int, poisoned: bool = True) -> None:
        """Chaos seam: NaN-poison (or heal) the shard's decode logits."""
        self.worker.batcher.inject_poison(shard, poisoned)

    def wedge_shard(self, shard: int, wedged: bool = True) -> None:
        """Chaos seam: freeze (or unfreeze) the shard's rows."""
        self.worker.batcher.inject_wedge(shard, wedged)

    def corrupt_shard_mask(self, shard: int) -> None:
        """Chaos seam: clear the shard's device admission bit while the
        host still believes it admits."""
        self.worker.batcher.corrupt_active_mask(shard)

    def kill_admission_shard(self, shard: int) -> int:
        """Chaos seam (``FleetFaultPlan.admission_kills``): kill one
        admission shard (staging, not engine): its staged requests go back
        to the queue and it rehydrates next cycle.  Needs
        ``tenancy.admission_shards >= 2``."""
        return self.worker.kill_admission_shard(shard)

    def partition_admission_shard(self, shard: int,
                                  partitioned: bool = True) -> None:
        """Chaos seam (``FleetFaultPlan.admission_partitions``): partition
        (or heal) one admission shard's gossip."""
        self.worker.partition_admission_shard(shard, partitioned)

    @property
    def processed(self) -> int:
        return self.worker.processed

    @property
    def completed_by_tenant(self) -> dict[str, int]:
        """Answered completions per tenant (one worker; the registry's
        duplicate path never reaches the count)."""
        return dict(getattr(self.worker, "completed_by_tenant", {}))

    @property
    def idle(self) -> bool:
        return (self.worker.batcher.active == 0
                and getattr(self.worker, "staged", 0) == 0)

    def stop_all(self) -> None:
        """Stop the plane, releasing unfinished requests back to the queue
        (shutdown never loses work), and clear every mask and probe cap."""
        release = getattr(self.worker, "release_inflight", None)
        if release is not None:
            release()
        self.worker.stop()
        for shard, state in enumerate(self.shard_states):
            if state in (SERVING, DRAINING, PROBING, QUARANTINED):
                self.shard_states[shard] = INACTIVE
                self.worker.batcher.set_shard_active(shard, False)
            self.worker.batcher.shard_probing[shard] = False
        self._drain_on_readmit.clear()
        self._quarantined_at.clear()
        self._update_metrics()

    # -- durable state: the reply registry, plus the one worker's
    # admission accounting (DRR/EDF deficits, flood classification, the
    # ladders, the tenant homes); shard states stay out, the autoscaler
    # derives the shard count again ------------------------------------------

    def export_state(self) -> dict:
        state = super().export_state()
        admission = getattr(self.worker, "export_admission_state", None)
        if admission is not None:
            state["admission"] = admission()
            state["records"] += state["admission"].get("records", 0)
        return state

    def import_state(self, state: dict, *, rebase: float = 0.0,
                     now: float | None = None,
                     max_age_s: float = 0.0) -> int:
        recovered = super().import_state(state)
        admission = state.get("admission")
        importer = getattr(self.worker, "import_admission_state", None)
        if importer is not None and isinstance(admission, dict):
            recovered += importer(admission, rebase=rebase, now=now,
                                  max_age_s=max_age_s)
        return recovered

    # -- observability ------------------------------------------------------

    def attach_lifecycle(self, registry) -> None:
        """Wire a :class:`~..obs.lifecycle.LifecycleRegistry` through the
        plane's one worker (admission, emit, settle, evacuation)."""
        self.lifecycle = registry
        attach = getattr(self.worker, "attach_lifecycle", None)
        if attach is not None:
            attach(registry)

    def attach_metrics(self, metrics) -> None:
        """Refresh the per-shard gauges (``shard_active``,
        ``shard_active_slots``, ``shard_tokens_per_second``,
        ``shard_health``) and the counters ``shard_quarantined_total`` and
        ``rows_evacuated_total`` into a
        :class:`~..obs.prometheus.WorkloadMetrics` registry each cycle."""
        self.metrics = metrics
        self._update_metrics()

    def _update_metrics(self) -> None:
        if self.metrics is None:
            return
        batcher = self.worker.batcher
        served_since = getattr(self.worker, "_served_since", None)
        for row in batcher.shard_stats(served_since):
            state = self.shard_states[row["shard"]]
            self.metrics.set_shard_gauges(
                row["shard"],
                active=state in (SERVING, PROBING),
                active_slots=row["active_slots"],
                tokens_per_second=row["tokens_per_second"],
                health=SHARD_HEALTH_CODES[state],
            )
        self.metrics.set_gauge(
            "shard_quarantined_total", self.quarantined_total,
            "Shards quarantined by the health sentinels (poisoned logits, "
            "no progress, admission-mask mismatch) over the plane's "
            "lifetime.",
            kind="counter",
        )
        self.metrics.set_gauge(
            "rows_evacuated_total", self.rows_evacuated_total,
            "In-flight rows moved off quarantined shards onto healthy ones "
            "(re-prefilled mid-request; rows with nowhere to go are "
            "released to the queue instead).",
            kind="counter",
        )
        from ..workloads.continuous import drain_ttft_histograms

        drain_ttft_histograms(batcher, self.metrics)

    # -- real-plane construction ------------------------------------------

    @classmethod
    def serving(
        cls,
        queue,
        params,
        model_config,
        service_config,
        *,
        min: int,
        max: int | None = None,
        shards: int | None = None,
        family: str | None = None,
        result_queue=None,
        engine_source=None,
        now_fn=None,
        device="cuda",
        prefix_cache=None,
        tenancy=None,
        mesh=None,
        **pool_kwargs,
    ) -> "ShardedWorkerPool":
        """One gang-stepped :class:`~.worker.FleetWorker` whose plane holds
        ``shards`` shards of ``service_config.batch_size`` slots
        (``shards`` defaults to ``service_config.shards``, or to ``max``
        when that is 1), on ``device`` (``"cuda"`` by default; a missing
        card raises), serving the model ``family`` (by default the
        config's).  ``engine_source`` is a sharded donor batcher whose
        engine the plane adopts; ``now_fn`` is the request-TTL clock.
        ``params`` may be int8-quantized and ``prefix_cache`` a shared
        prompt prefix, as for :meth:`~.pool.WorkerPool.serving`.
        ``tenancy`` gives the plane's worker fair-admission staging (the
        sharded admission plane with ``admission_shards > 1``), sticky
        tenant homes and, with ``prefix_pool > 0``, per-shard pools.
        On a serving ``mesh`` every rank builds the pool and the plane
        holds the rank's rows and heads (the plane's ``shards % data``
        rule applies), as :meth:`~.pool.WorkerPool.serving` describes."""
        if shards is None:
            shards = (service_config.shards if service_config.shards > 1
                      else (max or service_config.shards))
        seeded = dataclasses.replace(service_config, shards=shards)

        def factory(pool: "ShardedWorkerPool"):
            from .worker import FleetWorker

            # sharded=True: the plane even at one shard (the worker's own
            # pick would build the plain batcher, which has no masks)
            return FleetWorker(
                queue, params, model_config, seeded, family=family,
                result_queue=result_queue, now_fn=now_fn, device=device,
                prefix_cache=prefix_cache, pool=pool,
                engine_source=engine_source, sharded=True, tenancy=tenancy,
                mesh=mesh,
            )

        return cls(factory, min=min, max=max, **pool_kwargs)
