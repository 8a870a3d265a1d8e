"""Deterministic fault schedules: controller RPC failures, controller
crashes and fleet faults.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/faults.py`` (its chaos
demo waits for the simulator):

- the failure processes: a :class:`FailureProcess` answers, for each
  controller RPC at virtual time ``t``, one :class:`Fault` — extra latency
  the call consumes, then an optional error (``MetricError`` /
  ``ScaleError``).  :class:`Blackout` (one dead window), :class:`BurstyOutage`
  (periodic windows), :class:`FlakyCalls` (per-call failures derandomized
  by hashing ``(seed, surface, t)``), :class:`LatencySpikes` (slow, not
  dead) and :func:`compose` (latencies add, first error wins);
  :class:`FaultyMetricSource` and :class:`FaultyScaler` wire a process
  around the real metric source and scaler;
- :class:`CrashPlan`: controller kills at named crash points inside a
  tick, actuated by :class:`CrashingMetricSource`, :class:`CrashingScaler`
  and :class:`CrashingJournal` (and ``FleetDriver``'s tick boundary);
- :class:`FleetFaultPlan`: replica kills and hangs, the sharded plane's
  shard faults and the sharded admission plane's shard kills and gossip
  partitions.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

from ..core.clock import Clock
from ..core.types import MetricError, ScaleError


@dataclass(frozen=True)
class Fault:
    """What one call experiences: added latency, then (optionally) an error."""

    error: str | None = None
    latency: float = 0.0


#: The no-fault outcome (shared instance; Fault is frozen).
OK = Fault()


@runtime_checkable
class FailureProcess(Protocol):
    """Deterministic per-call fault decisions over simulated time."""

    def metric_fault(self, t: float) -> Fault:
        """Fault for a metric poll issued at time ``t``."""
        ...

    def scale_fault(self, t: float) -> Fault:
        """Fault for a scaler call issued at time ``t``."""
        ...


@dataclass(frozen=True)
class Blackout:
    """One outage window ``[start, start + duration)``.

    ``metric``/``scale`` choose the failing surface; both True is the
    *correlated* outage.  ``latency`` is what each failing call still
    costs before erroring (a timing-out RPC is slow, not instant).
    """

    start: float
    duration: float
    metric: bool = True
    scale: bool = False
    latency: float = 0.0

    def _fault(self, t: float, affected: bool, what: str) -> Fault:
        if affected and self.start <= t < self.start + self.duration:
            return Fault(
                error=f"{what} outage (blackout t={self.start:g}"
                f"+{self.duration:g})",
                latency=self.latency,
            )
        return OK

    def metric_fault(self, t: float) -> Fault:
        return self._fault(t, self.metric, "metric")

    def scale_fault(self, t: float) -> Fault:
        return self._fault(t, self.scale, "scaler")


@dataclass(frozen=True)
class BurstyOutage:
    """Rectangular outages: dead for ``outage_len`` s at the start of every
    ``period``, healthy in between (mirrors ``scenarios.BurstArrival``)."""

    period: float
    outage_len: float
    first: float = 0.0
    metric: bool = True
    scale: bool = False
    latency: float = 0.0

    def __post_init__(self):
        if not 0 < self.outage_len <= self.period:
            raise ValueError("need 0 < outage_len <= period")

    def _down(self, t: float) -> bool:
        if t < self.first:
            return False
        return (t - self.first) % self.period < self.outage_len

    def _fault(self, t: float, affected: bool, what: str) -> Fault:
        if affected and self._down(t):
            return Fault(
                error=f"{what} outage (bursty period={self.period:g})",
                latency=self.latency,
            )
        return OK

    def metric_fault(self, t: float) -> Fault:
        return self._fault(t, self.metric, "metric")

    def scale_fault(self, t: float) -> Fault:
        return self._fault(t, self.scale, "scaler")


@dataclass(frozen=True)
class FlakyCalls:
    """Memoryless per-call failures at ``failure_rate``, derandomized.

    The draw for a call at time ``t`` is ``Random(f"{seed}:{surface}:
    {round(t, 6)}").random()`` (string seeds hash via SHA-512 — stable
    across processes, unlike ``hash()``) — a pure function of the call
    instant, so
    (a) two episodes over the same process are identical, (b) reference
    and resilient controllers polling on the same cadence face the same
    faults, and (c) a retry after backoff (different ``t``) is a fresh
    independent draw, which is the whole point of retrying.
    """

    failure_rate: float
    seed: int = 0
    metric: bool = True
    scale: bool = False
    latency: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.failure_rate <= 1.0:
            raise ValueError(
                f"failure_rate must be in [0, 1], got {self.failure_rate}"
            )

    def _fault(self, t: float, affected: bool, what: str) -> Fault:
        if not affected:
            return OK
        draw = random.Random(f"{self.seed}:{what}:{round(t, 6)}").random()
        if draw < self.failure_rate:
            return Fault(
                error=f"{what} call failed (flaky p={self.failure_rate:g},"
                f" t={t:g})",
                latency=self.latency,
            )
        return OK

    def metric_fault(self, t: float) -> Fault:
        return self._fault(t, self.metric, "metric")

    def scale_fault(self, t: float) -> Fault:
        return self._fault(t, self.scale, "scaler")


@dataclass(frozen=True)
class LatencySpikes:
    """Calls *succeed* but consume ``delay`` extra virtual seconds inside
    periodic windows — a slow dependency eating the tick budget."""

    period: float
    spike_len: float
    delay: float
    first: float = 0.0
    metric: bool = True
    scale: bool = False

    def __post_init__(self):
        if not 0 < self.spike_len <= self.period:
            raise ValueError("need 0 < spike_len <= period")

    def _slow(self, t: float) -> bool:
        if t < self.first:
            return False
        return (t - self.first) % self.period < self.spike_len

    def _fault(self, t: float, affected: bool) -> Fault:
        if affected and self._slow(t):
            return Fault(latency=self.delay)
        return OK

    def metric_fault(self, t: float) -> Fault:
        return self._fault(t, self.metric)

    def scale_fault(self, t: float) -> Fault:
        return self._fault(t, self.scale)


@dataclass(frozen=True)
class ComposedFaults:
    """Overlay: latencies add, the first process with an error names it."""

    processes: tuple[FailureProcess, ...]

    def _merge(self, faults: Sequence[Fault]) -> Fault:
        latency = sum(f.latency for f in faults)
        error = next((f.error for f in faults if f.error is not None), None)
        if latency == 0.0 and error is None:
            return OK
        return Fault(error=error, latency=latency)

    def metric_fault(self, t: float) -> Fault:
        return self._merge([p.metric_fault(t) for p in self.processes])

    def scale_fault(self, t: float) -> Fault:
        return self._merge([p.scale_fault(t) for p in self.processes])


def compose(*processes: FailureProcess) -> ComposedFaults:
    """Overlay several failure processes into one."""
    return ComposedFaults(tuple(processes))


@dataclass(frozen=True)
class FleetFaultPlan:
    """Replica- and shard-fault schedule: faults are values applied at
    known *pool cycles* (flag flips), not process murder, so an episode's
    zero-lost / zero-duplicate gates replay identically every run.  The
    :class:`~..fleet.FleetDriver` calls :meth:`apply` once per cycle BEFORE
    the cycle runs.

    - ``kills`` / ``hangs``: ``(cycle, replica_index)`` pairs
      (:meth:`~..fleet.WorkerPool.kill_worker` /
      :meth:`~..fleet.WorkerPool.hang_worker`); an unknown index fails
      loudly, as a plan that kills nobody would gate nothing;
    - ``shard_poisons`` / ``shard_wedges``: ``(start_cycle, end_cycle,
      shard)`` windows of :class:`~..fleet.ShardedWorkerPool`'s chaos
      seams, injected at ``start`` and healed at ``end`` (end-exclusive);
    - ``shard_mask_corruptions``: one-shot ``(cycle, shard)`` device-mask
      bit flips (the quarantine's mask write heals them);
    - ``admission_kills``: one-shot ``(cycle, admission_shard)`` kills of
      an admission shard (its staged requests go back to the queue and it
      rehydrates from its tombstone and the peers' gossip next cycle);
    - ``admission_partitions``: ``(start_cycle, end_cycle, shard)``
      gossip-partition windows, validated as ``shard_poisons``: the shard
      keeps admitting but neither sends nor receives flood
      classifications until the window heals.
    """

    kills: tuple[tuple[int, int], ...] = ()
    hangs: tuple[tuple[int, int], ...] = ()
    shard_poisons: tuple[tuple[int, int, int], ...] = ()
    shard_wedges: tuple[tuple[int, int, int], ...] = ()
    shard_mask_corruptions: tuple[tuple[int, int], ...] = ()
    admission_kills: tuple[tuple[int, int], ...] = ()
    admission_partitions: tuple[tuple[int, int, int], ...] = ()

    def __post_init__(self):
        for name in ("shard_poisons", "shard_wedges", "admission_partitions"):
            for start, end, _ in getattr(self, name):
                if not start < end:
                    raise ValueError(
                        f"{name} window needs start < end, got "
                        f"[{start}, {end})"
                    )

    def apply(self, cycle: int, pool) -> None:
        for at, index in self.kills:
            if at == cycle:
                pool.kill_worker(index)
        for at, index in self.hangs:
            if at == cycle:
                pool.hang_worker(index)
        for start, end, shard in self.shard_poisons:
            if cycle == start:
                pool.poison_shard(shard, True)
            elif cycle == end:
                pool.poison_shard(shard, False)
        for start, end, shard in self.shard_wedges:
            if cycle == start:
                pool.wedge_shard(shard, True)
            elif cycle == end:
                pool.wedge_shard(shard, False)
        for at, shard in self.shard_mask_corruptions:
            if at == cycle:
                pool.corrupt_shard_mask(shard)
        for at, shard in self.admission_kills:
            if at == cycle:
                pool.kill_admission_shard(shard)
        for start, end, shard in self.admission_partitions:
            if cycle == start:
                pool.partition_admission_shard(shard, True)
            elif cycle == end:
                pool.partition_admission_shard(shard, False)

    def indices(self) -> set[int]:
        """Every replica index the plan touches (for pre-validation)."""
        return {i for _, i in self.kills} | {i for _, i in self.hangs}

    def shards(self) -> set[int]:
        """Every shard index the plan touches (for pre-validation)."""
        return (
            {s for _, _, s in self.shard_poisons}
            | {s for _, _, s in self.shard_wedges}
            | {s for _, s in self.shard_mask_corruptions}
        )

    def admission_shards(self) -> set[int]:
        """Every admission shard the plan touches (for pre-validation)."""
        return ({s for _, s in self.admission_kills}
                | {s for _, _, s in self.admission_partitions})


# ---------------------------------------------------------------------------
# Controller crash injection: the controller itself is a
# failure domain.  A CrashPlan kills the whole controller process — loop
# AND in-process serving pool — at NAMED crash points inside a tick, so
# the restart battery can prove the durable snapshot + rehydration path
# (core/durable.py) at every window a real kill -9 could hit:
#
#   after-observe                the world was polled; nothing actuated,
#                                nothing journaled, nothing snapshotted
#   after-decide                 the gate fired; the crash lands BEFORE
#                                the scaler RPC (the write-ahead intent
#                                is already durable)
#   after-actuate-before-journal the scaler RPC landed; no journal line,
#                                no snapshot — the classic double-scale
#                                window, closed by the intent
#   torn-mid-journal-line        the tick ran fully; the journal write
#                                tore mid-line; the snapshot (which
#                                follows the journal) never happened
#   tick-boundary                everything durable landed; the kill
#                                falls between ticks (the seamless case)
#
# Crashes raise ControllerCrash (a BaseException) so no never-dies guard
# can swallow them — exactly like the process vanishing at that instant.
# ---------------------------------------------------------------------------

CRASH_AFTER_OBSERVE = "after-observe"
CRASH_AFTER_DECIDE = "after-decide"
CRASH_AFTER_ACTUATE = "after-actuate-before-journal"
CRASH_TORN_JOURNAL = "torn-mid-journal-line"
CRASH_TICK_BOUNDARY = "tick-boundary"
CRASH_POINTS = (
    CRASH_AFTER_OBSERVE,
    CRASH_AFTER_DECIDE,
    CRASH_AFTER_ACTUATE,
    CRASH_TORN_JOURNAL,
    CRASH_TICK_BOUNDARY,
)


@dataclass(frozen=True)
class CrashPlan:
    """Deterministic controller-kill schedule: ``(tick_index, point)``
    pairs, tick indices counted across restarts (``FleetDriver``'s tick
    *attempt* counter, 0-based).  Unknown points fail loudly — a plan
    that kills nowhere gates nothing.

    The mid-tick points are actuated by the wrappers below
    (:class:`CrashingMetricSource` / :class:`CrashingScaler` /
    :class:`CrashingJournal`); ``tick-boundary`` is the
    :class:`~..fleet.pool.FleetDriver`'s own post-tick check.  Note the
    actuation points only fire on ticks where a gate actually reaches
    the scaler — schedule them on ticks the episode's backlog makes
    fire, and assert the observed crash count.
    """

    crashes: tuple[tuple[int, str], ...]

    def __post_init__(self):
        for tick, point in self.crashes:
            if tick < 0:
                raise ValueError(f"crash tick must be >= 0, got {tick}")
            if point not in CRASH_POINTS:
                raise ValueError(
                    f"unknown crash point {point!r} (valid: "
                    f"{', '.join(CRASH_POINTS)})"
                )

    def point_at(self, tick: int) -> "str | None":
        """The crash point scheduled for tick ``tick`` (None = none)."""
        for at, point in self.crashes:
            if at == tick:
                return point
        return None

    def boundary_crash(self, tick: int) -> bool:
        return self.point_at(tick) == CRASH_TICK_BOUNDARY


class CrashingMetricSource:
    """MetricSource proxy that kills the controller right AFTER a
    successful observation on the scheduled tick (``tick_fn`` supplies
    ``FleetDriver``'s current tick-attempt index)."""

    def __init__(self, inner, plan: CrashPlan, tick_fn) -> None:
        self.inner = inner
        self.plan = plan
        self.tick_fn = tick_fn

    def num_messages(self) -> int:
        value = self.inner.num_messages()
        if self.plan.point_at(self.tick_fn()) == CRASH_AFTER_OBSERVE:
            from ..core.durable import ControllerCrash

            raise ControllerCrash(
                f"injected kill after observe (tick {self.tick_fn()})"
            )
        return value


class CrashingScaler:
    """Scaler proxy for the two actuation-adjacent crash points:
    ``after-decide`` dies BEFORE the wrapped RPC (decision made, intent
    durable, world untouched); ``after-actuate-before-journal`` dies
    right after the RPC returns (world changed, nothing durable knows)."""

    def __init__(self, inner, plan: CrashPlan, tick_fn) -> None:
        self.inner = inner
        self.plan = plan
        self.tick_fn = tick_fn

    @property
    def replicas(self):
        # pass through the observed-world surface (rehydration
        # reconciles against it; stubs without one stay without one)
        return getattr(self.inner, "replicas")

    def _call(self, action, direction: str) -> None:
        from ..core.durable import ControllerCrash

        point = self.plan.point_at(self.tick_fn())
        if point == CRASH_AFTER_DECIDE:
            raise ControllerCrash(
                f"injected kill after decide, before scale_{direction} "
                f"(tick {self.tick_fn()})"
            )
        action()
        if point == CRASH_AFTER_ACTUATE:
            raise ControllerCrash(
                f"injected kill after scale_{direction}, before journal "
                f"(tick {self.tick_fn()})"
            )

    def scale_up(self) -> None:
        self._call(self.inner.scale_up, "up")

    def scale_down(self) -> None:
        self._call(self.inner.scale_down, "down")


class CrashingJournal:
    """TickObserver proxy that TEARS the journal mid-line on the
    scheduled tick — half the record's bytes, no newline — then kills
    the controller.  The loop's observer guard catches ``Exception``
    only, so the ControllerCrash propagates and the tick's snapshot
    (which follows the journal observer) never happens: the restart
    must heal the torn tail (the journal reader already tolerates it)
    and recover the tick from nothing but the previous snapshot."""

    def __init__(self, journal, plan: CrashPlan, tick_fn) -> None:
        self.journal = journal
        self.plan = plan
        self.tick_fn = tick_fn

    def on_tick(self, record) -> None:
        if self.plan.point_at(self.tick_fn()) == CRASH_TORN_JOURNAL:
            from ..core.durable import ControllerCrash

            self.journal.tear(record)
            raise ControllerCrash(
                f"injected kill mid-journal-line (tick {self.tick_fn()})"
            )
        self.journal.on_tick(record)


# ---------------------------------------------------------------------------
# Injection wrappers: episodes wire these around the REAL metric
# source and scaler, so the system under test stays the production stack.
# ---------------------------------------------------------------------------


class FaultyMetricSource:
    """MetricSource proxy consulting a :class:`FailureProcess` per poll.

    ``on_failure`` (optional) runs before a fault raises — a simulator
    passes its world-advance hook so the queue's true depth is sampled
    (and ``max_depth`` stays honest) even on ticks the controller never
    saw.
    """

    def __init__(
        self,
        inner,
        faults: FailureProcess,
        clock: Clock,
        on_failure=None,
    ) -> None:
        self.inner = inner
        self.faults = faults
        self.clock = clock
        self.on_failure = on_failure

    def num_messages(self) -> int:
        fault = self.faults.metric_fault(self.clock.now())
        if fault.latency > 0:
            self.clock.sleep(fault.latency)
        if fault.error is not None:
            if self.on_failure is not None:
                self.on_failure()
            raise MetricError(fault.error)
        return self.inner.num_messages()


class FaultyScaler:
    """Scaler proxy consulting a :class:`FailureProcess` per actuation."""

    def __init__(self, inner, faults: FailureProcess, clock: Clock) -> None:
        self.inner = inner
        self.faults = faults
        self.clock = clock

    def _call(self, action) -> None:
        fault = self.faults.scale_fault(self.clock.now())
        if fault.latency > 0:
            self.clock.sleep(fault.latency)
        if fault.error is not None:
            raise ScaleError(fault.error)
        action()

    def scale_up(self) -> None:
        self._call(self.inner.scale_up)

    def scale_down(self) -> None:
        self._call(self.inner.scale_down)
