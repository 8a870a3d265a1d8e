"""WorkerPool: the serving fleet behind the ``Scaler`` seam.

The port's copy of ``kube_sqs_autoscaler_tpu/fleet/pool.py`` without the
sharded, tenancy and controller-restart parts.  A :class:`WorkerPool` is a
:class:`~..core.types.Scaler` whose ``scale_up``/``scale_down`` spin real
:class:`~.worker.FleetWorker` replicas up and down, so the
:class:`~..core.loop.ControlLoop` drives a fleet of serving replicas
instead of a number.

Through the seam it behaves as the reference's ``PodAutoScaler``: it steps
by ``scale_up_pods``/``scale_down_pods`` clamped to ``[min, max]``, a
boundary no-op is success (the policy refreshes its cooldown on it), and
a failure raises :class:`~..core.types.ScaleError` and changes nothing.

- **spin-up** — a new replica shares the pool's params by reference and
  adopts the donor replica's engine; it pays only for its own KV cache;
- **drain** — ``scale_down`` marks the newest replicas draining: they
  stop admitting, keep stepping their in-flight slots, and retire once
  empty.  A drain past ``drain_timeout_cycles`` hands its unfinished
  requests back to the queue (``change_message_visibility(0)``);
- **supervision** — a killed replica, or a hung one caught by a watchdog
  after ``hang_grace_cycles`` cycles without progress, is declared dead;
  its un-replied in-flight requests are re-dispatched to survivors, and
  the pool's reply registry keeps any request from being answered twice
  (it also absorbs visibility-timeout redeliveries);
- **routing** — each fleet cycle steps serving replicas freest-first,
  re-dispatched orphans ahead of fresh queue traffic.

Everything is synchronous and deterministic, and every replica steps in
this one thread on the one CUDA stream: replica B's settle waits behind
replica A's block, and stream order keeps each replica's work in order.
The supervisor reads host counters only, never a device tensor.  Faults
are flag flips at known cycles (:class:`~..sim.faults.FleetFaultPlan`).
Importing this module imports no torch: the replica class is imported
when :meth:`WorkerPool.serving` builds one.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..core.clock import Clock, SystemClock
from ..core.types import ScaleError

log = logging.getLogger(__name__)

# The constructor's min/max keyword names (PodAutoScaler's field names)
# shadow the builtins in signatures; these aliases keep the clamp math
# unambiguous.
builtins_min = min
builtins_max = max


def _free_count(batcher) -> int:
    """Admission capacity as a bare count (``_free_slot_count`` when the
    batcher has it; contract-test stubs carry a plain ``free_slots``)."""
    counter = getattr(batcher, "_free_slot_count", None)
    return counter() if counter is not None else len(batcher.free_slots)


# Lifecycle states a replica moves through (the fleet_replica_state
# gauge's codes).
SERVING = "serving"
DRAINING = "draining"
DEAD = "dead"
STOPPED = "stopped"
REPLICA_STATE_CODES = {SERVING: 0, DRAINING: 1, DEAD: 2, STOPPED: 3}


@dataclass(frozen=True)
class FleetEvent:
    """One supervisor decision, stamped on the pool's clock."""

    name: str  # replica-spawn | replica-kill | replica-drain-start | ...
    t: float
    args: dict = field(default_factory=dict)


class _BoundedSet:
    """Insertion-ordered set with a capacity: the reply registry.
    Request ids are unique per queue, so membership only needs to cover a
    redelivery horizon; bounding it keeps a long-lived fleet's memory
    flat."""

    def __init__(self, capacity: int) -> None:
        self._capacity = capacity
        self._set: set = set()
        self._order: deque = deque()

    def add(self, item) -> None:
        if item in self._set:
            return
        self._set.add(item)
        self._order.append(item)
        while len(self._order) > self._capacity:
            self._set.discard(self._order.popleft())

    def __contains__(self, item) -> bool:
        return item in self._set

    def __len__(self) -> int:
        return len(self._order)

    def items(self) -> list:
        """Insertion-ordered contents (state export)."""
        return list(self._order)


class FleetPoolBase:
    """Plumbing of a fleet actuator: the bounded exactly-once reply
    registry, the :class:`FleetEvent` stream and its Chrome-trace export,
    and the one-shot failure-injection seams of the contract tests."""

    def __init__(
        self,
        *,
        clock: Clock | None = None,
        replied_capacity: int = 65536,
    ) -> None:
        self.clock = clock or SystemClock()
        self.events: deque[FleetEvent] = deque(maxlen=4096)
        self.cycle = 0
        self.metrics = None
        self._replied = _BoundedSet(replied_capacity)
        self.duplicates_suppressed = 0
        # test seams, mirroring the fakes' error injection hooks
        self.fail_next_up: Exception | None = None
        self.fail_next_down: Exception | None = None

    def _injected_failure(self, direction: str) -> None:
        """Raise (once) the armed ``fail_next_up``/``fail_next_down`` error
        as a :class:`ScaleError`, changing nothing."""
        attr = f"fail_next_{direction}"
        err = getattr(self, attr)
        if err is not None:
            setattr(self, attr, None)
            raise ScaleError(f"Failed to scale {direction}") from err

    # -- reply registry (the zero-duplicate guarantee) -------------------

    def already_replied(self, rid: str) -> bool:
        return rid in self._replied

    def mark_replied(self, rid: str) -> None:
        self._replied.add(rid)

    def note_duplicate(self, rid: str) -> None:
        self.duplicates_suppressed += 1
        log.info("Suppressed duplicate reply for request %s", rid)

    # -- state export: the registry a restarted pool must not lose -------

    def export_state(self) -> dict:
        return {
            "records": len(self._replied),
            "replied": self._replied.items(),
            "duplicates_suppressed": self.duplicates_suppressed,
        }

    def import_state(self, state: dict) -> int:
        """Restore the reply registry (re-adding through the bounded set
        reproduces its eviction state); returns the records restored."""
        recovered = 0
        for rid in state.get("replied") or ():
            self._replied.add(rid)
            recovered += 1
        self.duplicates_suppressed = int(
            state.get("duplicates_suppressed", 0) or 0
        )
        return recovered

    # -- event stream ----------------------------------------------------

    def _event(self, name: str, **args) -> None:
        self.events.append(FleetEvent(name, self.clock.now(), args))

    def trace_events(self, time_origin: float | None = None) -> list[dict]:
        """The pool's decisions as Chrome-trace instant events."""
        from ..obs.trace import instant_trace_events

        return instant_trace_events(self.events, time_origin)


class Replica:
    """One supervised fleet member: a worker plus its lifecycle state."""

    def __init__(self, index: int, worker: Any, spawned_at: float) -> None:
        self.index = index
        self.worker = worker
        self.state = SERVING
        self.spawned_at = spawned_at
        self.drain_started_cycle: int | None = None
        # progress watchdog (busy wedge)
        self.last_progress = -1
        self.stalled_cycles = 0
        # idle-wedge watchdog: refill-pass liveness while holding no work
        self.last_refills: int | None = None
        self.idle_stalled_cycles = 0

    def progress(self) -> int:
        """Monotone progress signal from host counters: tokens emitted
        plus requests settled."""
        return self.worker.batcher.tokens_emitted + self.worker.processed


class WorkerPool(FleetPoolBase):
    """A supervised pool of serving replicas behind the Scaler seam.

    ``replica_factory(pool)`` builds one replica worker (:meth:`serving`
    wires a :class:`~.worker.FleetWorker`; the contract tests substitute a
    stub).  ``min``/``max``/``scale_up_pods``/``scale_down_pods`` mirror
    ``PodAutoScaler``'s fields.
    """

    def __init__(
        self,
        replica_factory: Callable[["WorkerPool"], Any],
        *,
        min: int,
        max: int,
        scale_up_pods: int = 1,
        scale_down_pods: int = 1,
        initial: int | None = None,
        clock: Clock | None = None,
        hang_grace_cycles: int = 3,
        drain_timeout_cycles: int | None = None,
        replied_capacity: int = 65536,
    ) -> None:
        if not 1 <= min <= max:
            raise ValueError(f"need 1 <= min ({min}) <= max ({max})")
        if scale_up_pods < 1 or scale_down_pods < 1:
            raise ValueError("scale step sizes must be >= 1")
        if hang_grace_cycles < 2:
            # one no-progress cycle is legitimate: the block engine reads
            # block N one cycle after dispatching it
            raise ValueError("hang_grace_cycles must be >= 2")
        super().__init__(clock=clock, replied_capacity=replied_capacity)
        self.replica_factory = replica_factory
        self.min = min
        self.max = max
        self.scale_up_pods = scale_up_pods
        self.scale_down_pods = scale_down_pods
        self.hang_grace_cycles = hang_grace_cycles
        self.drain_timeout_cycles = drain_timeout_cycles
        # live replicas plus a bounded tail of retired/dead ones; older
        # ones are pruned each cycle with their counts folded into
        # _retired_processed
        self.members: list[Replica] = []
        self.retired_keep = 32
        # live count of DEAD/STOPPED members, kept at the transitions so
        # the prune pass skips its scan while nothing exceeds retired_keep
        self._retired_members = 0
        self._retired_processed = 0
        self._next_index = 0
        self._spawn_ordinal = 0  # factory invocations (pre-commit safe)
        self._orphans: list[dict] = []  # re-dispatch queue (priority)
        self.redispatched_total = 0
        self.released_total = 0
        if initial is None:
            initial = min
        if not min <= initial <= max:
            raise ValueError(
                f"initial ({initial}) must be within [min, max]"
            )
        for _ in range(initial):
            self._spawn()

    # ------------------------------------------------------------------
    # The Scaler seam (PodAutoScaler parity)
    # ------------------------------------------------------------------

    @property
    def replicas(self) -> int:
        """Serving replica count, the fleet's ``spec.replicas``: draining
        replicas are excluded, like pods past their deletion timestamp."""
        return sum(1 for r in self.members if r.state == SERVING)

    def scale_up(self) -> None:
        self._injected_failure("up")
        current = self.replicas
        if current >= self.max:
            log.info(
                "More than max replicas serving. No scale up. Replicas: %d",
                current,
            )
            return
        target = builtins_min(current + self.scale_up_pods, self.max)
        # build-then-commit, so a factory failure changes nothing
        workers = []
        try:
            for _ in range(target - current):
                workers.append(self.replica_factory(self))
        except Exception as err:
            for worker in workers:
                worker.stop()
            raise ScaleError("Failed to scale up") from err
        for worker in workers:
            self._add_replica(worker)
        log.info("Scale up successful. Replicas: %d", self.replicas)

    def scale_down(self) -> None:
        self._injected_failure("down")
        current = self.replicas
        if current <= self.min:
            log.info(
                "Less than min replicas serving. No scale down. "
                "Replicas: %d",
                current,
            )
            return
        target = builtins_max(current - self.scale_down_pods, self.min)
        for _ in range(current - target):
            self._drain_one()
        log.info("Scale down successful. Replicas: %d", self.replicas)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def _spawn(self) -> Replica:
        return self._add_replica(self.replica_factory(self))

    def _add_replica(self, worker: Any) -> Replica:
        replica = Replica(self._next_index, worker, self.clock.now())
        self._next_index += 1
        self.members.append(replica)
        self._event("replica-spawn", replica=replica.index)
        return replica

    def _drain_one(self) -> None:
        # newest serving replica first (its cache is coldest)
        replica = builtins_max(
            (r for r in self.members if r.state == SERVING),
            key=lambda r: r.index,
        )
        replica.state = DRAINING
        replica.worker.admitting = False
        replica.drain_started_cycle = self.cycle
        self._event(
            "replica-drain-start", replica=replica.index,
            inflight=replica.worker.batcher.active,
        )

    def engine_donor(self):
        """The batcher whose engine a new replica adopts: any member's,
        even a dead one's (the engine holds no rolling state).  ``None``
        for the first spawn."""
        for replica in self.members:
            return replica.worker.batcher
        return None

    def kill_worker(self, index: int) -> None:
        """Fault injection: crash replica ``index`` now.  The next
        :meth:`run_cycle`'s supervisor pass re-dispatches its un-replied
        in-flight requests to survivors."""
        self._member(index).worker.kill()

    def hang_worker(self, index: int) -> None:
        """Fault injection: wedge replica ``index`` — it looks alive but
        makes no progress until a watchdog declares it dead."""
        self._member(index).worker.hang()

    def _member(self, index: int) -> Replica:
        for replica in self.members:
            if replica.index == index:
                return replica
        raise ValueError(f"no replica with index {index}")

    # ------------------------------------------------------------------
    # The fleet cycle: supervise -> route -> serve -> retire
    # ------------------------------------------------------------------

    def run_cycle(self) -> int:
        """One fleet cycle; returns requests completed across replicas."""
        self.cycle += 1
        self._supervise()
        done = 0
        # one state-partition pass per cycle, so the cycle's cost stays
        # flat however much retirement history the members hold
        serving: list[Replica] = []
        draining: list[Replica] = []
        for replica in self.members:
            if replica.state == SERVING:
                serving.append(replica)
            elif replica.state == DRAINING:
                draining.append(replica)
        # router: freest replica first, so a refill cycle spreads the
        # queue's head across the fleet
        serving.sort(
            key=lambda r: _free_count(r.worker.batcher), reverse=True
        )
        for replica in serving:
            if self._orphans:
                self._dispatch_orphans(replica)
            done += replica.worker.run_once()
        for replica in draining:
            done += replica.worker.run_once()
            if replica.worker.batcher.active == 0:
                # nothing in flight: the drain is complete
                self._retire(replica, released=0)
            elif (
                self.drain_timeout_cycles is not None
                and replica.drain_started_cycle is not None
                and self.cycle - replica.drain_started_cycle
                >= self.drain_timeout_cycles
            ):
                # the drain stalled: hand unfinished requests back to the
                # queue so survivors pick them up, then retire
                released = replica.worker.release_inflight()
                self.released_total += released
                self._retire(replica, released=released)
        self._prune_retired()
        self._update_metrics()
        return done

    def _supervise(self) -> None:
        """Declare killed/hung replicas dead and queue their failover.

        - **busy wedge** — the replica holds work (``active > 0``) but its
          token/settle progress froze: dead after ``hang_grace_cycles``
          stalled cycles (one stalled cycle is the block engine's
          dispatch-ahead lag);
        - **idle wedge** — a healthy idle serving replica still runs its
          refill pass every cycle (``ContinuousWorker.refill_cycles``); a
          serving, admitting replica whose refill counter freezes while it
          holds nothing is declared dead after the same grace.  Draining
          replicas are exempt (they stop refilling by design).
        """
        for replica in self.members:
            if replica.state not in (SERVING, DRAINING):
                continue
            worker = replica.worker
            if worker.killed:
                self._declare_dead(replica, cause="killed")
                continue
            progress = replica.progress()
            if worker.batcher.active > 0 and progress == replica.last_progress:
                replica.stalled_cycles += 1
                if replica.stalled_cycles >= self.hang_grace_cycles:
                    self._declare_dead(replica, cause="hung")
                    continue
            else:
                replica.stalled_cycles = 0
            replica.last_progress = progress
            refills = getattr(worker, "refill_cycles", None)
            if (
                refills is not None
                and replica.state == SERVING
                and getattr(worker, "admitting", True)
                and worker.batcher.active == 0
            ):
                if refills == replica.last_refills:
                    replica.idle_stalled_cycles += 1
                    if replica.idle_stalled_cycles >= self.hang_grace_cycles:
                        self._declare_dead(replica, cause="hung-idle")
                        continue
                else:
                    replica.idle_stalled_cycles = 0
            else:
                replica.idle_stalled_cycles = 0
            replica.last_refills = refills

    def _declare_dead(self, replica: Replica, cause: str) -> None:
        replica.state = DEAD
        self._retired_members += 1
        replica.worker.killed = True  # a hung replica must never step again
        orphans = replica.worker.take_inflight()
        self.redispatched_total += len(orphans)
        self._orphans.extend(orphans)
        self._event(
            "replica-kill", replica=replica.index, cause=cause,
            redispatched=len(orphans),
        )
        log.warning(
            "Replica %d declared dead (%s); re-dispatching %d in-flight "
            "request(s) to %d survivor(s)",
            replica.index, cause, len(orphans), self.replicas,
        )

    def _dispatch_orphans(self, replica: Replica) -> None:
        free = _free_count(replica.worker.batcher)
        if free <= 0:
            return
        take, self._orphans = self._orphans[:free], self._orphans[free:]
        if take:
            replica.worker._admit(take)
            self._event(
                "redispatch", replica=replica.index, requests=len(take),
            )

    def _retire(self, replica: Replica, *, released: int) -> None:
        if replica.state != DEAD:  # a dead replica is already counted
            self._retired_members += 1
        replica.state = STOPPED
        replica.worker.stop()
        self._event(
            "replica-drain-done", replica=replica.index, released=released,
        )

    # ------------------------------------------------------------------
    # Introspection / observability
    # ------------------------------------------------------------------

    def next_spawn_ordinal(self) -> int:
        """Monotone per-factory-call counter (distinct even for builds
        that roll back): :meth:`serving` derives each replica's sampling
        seed from it."""
        ordinal = self._spawn_ordinal
        self._spawn_ordinal += 1
        return ordinal

    def _prune_retired(self) -> None:
        """Drop all but the newest ``retired_keep`` DEAD/STOPPED replicas,
        folding their settle counts into the retired total (a pruned index
        disappears: ``kill_worker`` on it raises).  Skips the scan while
        nothing exceeds ``retired_keep``."""
        if self._retired_members <= self.retired_keep:
            return
        retired = [
            r for r in self.members if r.state in (DEAD, STOPPED)
        ]
        for replica in retired[: -self.retired_keep or None]:
            self._retired_processed += replica.worker.processed
            self.members.remove(replica)
            self._retired_members -= 1

    @property
    def processed(self) -> int:
        """Requests settled over the fleet's lifetime (dead, retired and
        pruned replicas included; duplicate-suppressed settles excluded:
        this counts uniquely answered requests)."""
        return self._retired_processed + sum(
            r.worker.processed for r in self.members
        )

    @property
    def idle(self) -> bool:
        """Nothing in flight anywhere and nothing awaiting re-dispatch."""
        return not self._orphans and all(
            r.worker.batcher.active == 0
            for r in self.members
            if r.state in (SERVING, DRAINING)
        )

    def stop_all(self) -> None:
        """Stop every replica (live ones release their in-flight requests
        back to the queue first: shutdown never loses work)."""
        for replica in self.members:
            if replica.state in (SERVING, DRAINING):
                released = replica.worker.release_inflight()
                self.released_total += released
                self._retire(replica, released=released)
        self._update_metrics()

    def attach_metrics(self, metrics) -> None:
        """Refresh the fleet gauges into a
        :class:`~..obs.prometheus.WorkloadMetrics` registry every cycle:
        ``fleet_replica_state`` / ``fleet_replica_tokens_per_second`` /
        ``fleet_replica_active_slots`` (labeled by replica),
        ``fleet_replicas_draining``, the
        ``fleet_requests_redispatched_total`` counter and every member's
        TTFT samples."""
        self.metrics = metrics
        self._update_metrics()

    def _update_metrics(self) -> None:
        if self.metrics is None:
            return
        now = time.perf_counter()
        for replica in self.members:
            labels = (("replica", str(replica.index)),)
            worker = replica.worker
            served_since = getattr(worker, "_served_since", None)
            rate = 0.0
            if served_since is not None and now > served_since:
                rate = worker.batcher.tokens_emitted / (now - served_since)
            self.metrics.set_gauge(
                "fleet_replica_state",
                REPLICA_STATE_CODES[replica.state],
                "Replica lifecycle state (0=serving, 1=draining, 2=dead, "
                "3=stopped).",
                labels=labels,
            )
            self.metrics.set_gauge(
                "fleet_replica_tokens_per_second", rate,
                "Generated tokens per second over this replica's serving "
                "lifetime.",
                labels=labels,
            )
            self.metrics.set_gauge(
                "fleet_replica_active_slots", worker.batcher.active,
                "Decode slots currently holding an in-flight request on "
                "this replica.",
                labels=labels,
            )
        self.metrics.set_gauge(
            "fleet_replicas_draining",
            sum(1 for r in self.members if r.state == DRAINING),
            "Replicas draining (finishing in-flight work, not admitting).",
        )
        self.metrics.set_gauge(
            "fleet_requests_redispatched_total", self.redispatched_total,
            "In-flight requests re-dispatched from dead replicas to "
            "survivors.",
            kind="counter",
        )
        # replicas get no worker-level registry (their unlabeled gauges
        # would collide), but cumulative TTFT histograms merge: drain
        # every member's samples into the pool's registry
        from ..workloads.continuous import drain_ttft_histograms

        for replica in self.members:
            batcher = getattr(replica.worker, "batcher", None)
            if batcher is not None:
                drain_ttft_histograms(batcher, self.metrics)

    # ------------------------------------------------------------------
    # Real-fleet construction
    # ------------------------------------------------------------------

    @classmethod
    def serving(
        cls,
        queue,
        params,
        model_config,
        service_config,
        *,
        min: int,
        max: int,
        family: str | None = None,
        result_queue=None,
        device="cuda",
        prefix_cache=None,
        **pool_kwargs,
    ) -> "WorkerPool":
        """A pool of real :class:`~.worker.FleetWorker` replicas over one
        shared queue, on ``device`` (``"cuda"`` by default; a missing card
        raises), serving the model ``family`` (``"gpt"`` or ``"llama"``; by
        default the config's).  Replicas share ``params`` by reference,
        the plain tree or an int8-quantized one (``workloads/quantize``),
        and ``prefix_cache`` (a shared prompt prefix in the layout
        ``ServiceConfig.quantized_kv`` picks); the first builds the engine
        and the rest adopt it.

        Sampled serving: each replica gets ``sample_seed + spawn
        ordinal``, so the fleet draws independent streams."""

        def factory(pool: "WorkerPool"):
            from .worker import FleetWorker

            seeded = dataclasses.replace(
                service_config,
                sample_seed=service_config.sample_seed
                + pool.next_spawn_ordinal(),
            )
            return FleetWorker(
                queue, params, model_config, seeded,
                family=family, result_queue=result_queue, device=device,
                prefix_cache=prefix_cache, pool=pool,
                engine_source=pool.engine_donor(),
            )

        return cls(factory, min=min, max=max, **pool_kwargs)


class FleetDriver:
    """Interleaves fleet serving cycles with control-loop ticks.

    The loop under drive is the :class:`~..core.loop.ControlLoop`
    (``loop.tick`` on its own clock, one tick per ``poll_interval``), the
    actuator is the pool, and the world between ticks is serving.
    ``loop=None`` drives the pool alone.  ``cycle_dt > 0`` advances a
    :class:`~..core.clock.FakeClock` that much per cycle (the
    deterministic mode); ``0`` reads real time.  ``fault_plan`` applies a
    :class:`~..sim.faults.FleetFaultPlan`'s faults at their cycles.
    """

    def __init__(
        self,
        pool: WorkerPool,
        loop=None,
        *,
        cycle_dt: float = 0.0,
        fault_plan=None,
    ) -> None:
        self.pool = pool
        self.loop = loop
        self.cycle_dt = cycle_dt
        self.fault_plan = fault_plan
        self.ticks = 0

    def run(
        self,
        *,
        until_processed: int | None = None,
        max_cycles: int = 100_000,
        until: Callable[[], bool] | None = None,
    ) -> dict:
        """Drive until ``until_processed`` requests settled and the fleet
        is idle (or ``max_cycles``); returns summary stats.  ``until``
        replaces the stop condition with a predicate evaluated after each
        cycle."""
        clock = self.loop.clock if self.loop is not None else self.pool.clock
        state = None
        next_tick = None
        if self.loop is not None:
            state = self.loop.initial_policy_state()
            next_tick = clock.now() + self.loop.config.poll_interval
        trajectory: list[int] = []
        cycles = 0
        for _ in range(max_cycles):
            if self.fault_plan is not None:
                self.fault_plan.apply(self.pool.cycle, self.pool)
            self.pool.run_cycle()
            cycles += 1
            if self.cycle_dt:
                clock.advance(self.cycle_dt)  # FakeClock only
            if self.loop is not None and clock.now() >= next_tick:
                state = self.loop.tick(state)
                self.loop.ticks += 1
                self.ticks += 1
                trajectory.append(self.pool.replicas)
                # re-anchor rather than accumulate: a long serve cycle
                # must not cause a burst of catch-up ticks
                next_tick = clock.now() + self.loop.config.poll_interval
            if until is not None:
                if until():
                    break
            elif (
                until_processed is not None
                and self.pool.processed >= until_processed
                and self.pool.idle
            ):
                break
        return {
            "cycles": cycles,
            "ticks": self.ticks,
            "processed": self.pool.processed,
            "replica_trajectory": trajectory,
            "final_replicas": self.pool.replicas,
        }
