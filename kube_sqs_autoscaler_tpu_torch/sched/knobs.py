"""KnobActuator: policy outputs actuate engine knobs, live.

The :class:`~..core.types.Scaler` seam lets the control plane actuate
ONE integer — replica count.  Everything else that sets the fleet's
operating point (decode block size, per-shard admission width, shard
count, speculative round overlap, prefix-pool residency) was frozen at
construction: changing any of them meant a redeploy, even though the
engine can absorb each one as an O(1) host action at the right instant
(BLITZSCALE's reconfiguration argument, PAPERS.md).  This module is the
knob seam next to the Scaler seam: a :class:`KnobActuator` stages knob
changes and applies them **between engine cycles at safe points**, with
every change journaled (its own ``knob`` journal line kind),
snapshotted (a :class:`~..core.durable.DurableStateStore` provider, so
a restarted worker resumes its actuated operating point), exported as
``engine_knob{knob=...}`` gauges, and traced (``knob-*`` instants in
their own Chrome-trace category).

The knobs, and where each one is safe:

=============== =====================================================
``decode_block`` at the **re-dispatch boundary**: the engine stages the
                new size and completes the swap inside its next step —
                one cycle skips the dispatch-ahead so the in-flight
                block settles at the old size, then the next block
                dispatches at the new size (the compiled scan is
                shape-polymorphic in the key operand, so a new size is
                one cached retrace, not a rebuild).
``slot_limit``  between cycles: a pure host-side admission cap (per
                shard on the sharded plane).  Rows already above the
                limit finish — drain semantics, never a kill.
``shards``      between cycles: the existing drain/retire machinery —
                mask flips through
                :meth:`~..workloads.shard_plane.ShardedBatcher.
                set_shard_active`, or the supervising
                :class:`~..fleet.sharded.ShardedWorkerPool`'s scale
                path when one owns the plane (quarantine bookkeeping
                stays consistent).
``speculative`` between rounds.  On the fused spec engine: toggles the
                provably-safe second-round overlap (dispatch-ahead of
                draft-and-verify rounds).  On the decode plane
                (:class:`~..planes.engine.DecodePlaneBatcher`): flips
                draft-and-verify itself via the drain-to-plain path —
                in-flight rows finish in their admitted mode, new
                admissions land in the new one.  On a
                :class:`~..planes.pool.DisaggregatedPool` target the
                knob routes to the decode-plane worker.
``prefix_pool`` between cycles: moves the pool's residency ceiling
                within its allocated arena (shrink evicts LRU-cold
                entries; the ``>= per-shard slots`` floor that makes
                same-batch eviction corruption impossible still holds).
``plane_ratio`` between cycles: the disaggregated pool's prefill-plane
                replica count, walked through the pool's own Scaler
                state machine (spawn/drain, clamps respected).  At
                fixed decode shards this IS the prefill:decode ratio —
                the knob the two-plane economics tune.
=============== =====================================================

Arming is validated at CONSTRUCTION (the CLI turns these into startup
usage errors): the speculative knob without a draft engine — or with
beam slots — is rejected before anything serves, as is the shards knob
on an unsharded plane or the prefix-pool knob without a pool.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

KNOB_DECODE_BLOCK = "decode_block"
KNOB_SLOT_LIMIT = "slot_limit"
KNOB_SHARDS = "shards"
KNOB_SPECULATIVE = "speculative"
KNOB_PREFIX_POOL = "prefix_pool"
KNOB_PLANE_RATIO = "plane_ratio"

#: Every knob the actuator knows, in apply order (stable, test-pinned).
ALL_KNOBS = (
    KNOB_DECODE_BLOCK,
    KNOB_SLOT_LIMIT,
    KNOB_SHARDS,
    KNOB_SPECULATIVE,
    KNOB_PREFIX_POOL,
    KNOB_PLANE_RATIO,
)

#: CLI spelling (``--knobs decode-block,slot-limit,...``) -> knob name.
CLI_KNOB_NAMES = {name.replace("_", "-"): name for name in ALL_KNOBS}


class KnobError(ValueError):
    """A knob request the engine cannot honor (bad name, bad value, or
    an engine built without that knob's machinery)."""


def parse_knob_names(csv: str) -> tuple[str, ...]:
    """``--knobs`` CSV -> canonical knob names, order preserved,
    duplicates rejected (a duplicate is a typo, not an emphasis)."""
    names: list[str] = []
    for raw in csv.split(","):
        raw = raw.strip()
        if not raw:
            continue
        knob = CLI_KNOB_NAMES.get(raw, raw)
        if knob not in ALL_KNOBS:
            raise KnobError(
                f"unknown knob {raw!r} (choose from "
                f"{', '.join(sorted(CLI_KNOB_NAMES))})"
            )
        if knob in names:
            raise KnobError(f"knob {raw!r} listed twice")
        names.append(knob)
    if not names:
        raise KnobError("--knobs is empty")
    return tuple(names)


@dataclass(frozen=True)
class KnobEvent:
    """One applied knob change, timestamped on the actuator's clock —
    shaped like a :class:`~..fleet.pool.FleetEvent` so
    :func:`~..obs.trace.instant_trace_events` exports it (``knob-*``
    names land in their own ``"knob"`` trace category)."""

    name: str  # "knob-set"
    t: float
    args: dict = field(default_factory=dict)


class KnobActuator:
    """Stages and applies engine-knob changes at safe points.

    ``target`` is the worker whose engine the knobs drive — a
    :class:`~..workloads.continuous.ContinuousWorker` (or fleet
    subclass) — or a pool of them: a
    :class:`~..fleet.sharded.ShardedWorkerPool` (its one worker) or a
    :class:`~..fleet.pool.WorkerPool` (every serving/draining member;
    the shared ``ServiceConfig`` is updated too so replicas spawned
    AFTER a change construct at the actuated value and still adopt the
    donor's programs).

    ``journal`` (a :class:`~..obs.journal.TickJournal`) records one
    ``knob`` line per applied change; ``metrics`` (a
    :class:`~..obs.prometheus.WorkloadMetrics`) carries the
    ``engine_knob{knob=...}`` gauges; both optional.  The actuator is a
    :class:`~..core.durable.StateProvider`: its snapshot section is the
    actuated operating point, re-applied at the first safe point after
    a restart.
    """

    def __init__(
        self,
        target,
        *,
        armed=ALL_KNOBS,
        clock=None,
        journal=None,
        metrics=None,
    ) -> None:
        from ..core.clock import SystemClock

        self._target = target
        self.armed = tuple(armed)
        for knob in self.armed:
            if knob not in ALL_KNOBS:
                raise KnobError(f"unknown knob {knob!r}")
        self.clock = clock or SystemClock()
        self.journal = journal
        self.metrics = metrics
        self._staged: dict[str, object] = {}
        # every value this actuator has APPLIED, by knob — the reconcile
        # pass re-asserts these onto workers that drift (a replica
        # spawned after a slot_limit/prefix_pool change constructs at
        # the default; decode_block propagates through the shared
        # ServiceConfig, the host-side knobs need this)
        self._actuated: dict[str, object] = {}
        self.changes_total = 0
        self.changes: list[dict] = []
        self.events: deque[KnobEvent] = deque(maxlen=1024)
        # arm-time validation: a knob the engine cannot drive is a
        # construction error, never a mid-cycle traceback
        worker = self._primary()
        batcher = worker.batcher
        if KNOB_DECODE_BLOCK in self.armed and \
                not getattr(batcher, "_block_engine", False):
            raise KnobError(
                "the decode_block knob needs the block/gang decode "
                "engine (construct with decode_block > 1, or the "
                "sharded plane)"
            )
        if KNOB_SHARDS in self.armed and \
                not hasattr(batcher, "set_shard_active"):
            raise KnobError(
                "the shards knob needs the sharded serving plane "
                "(--shards)"
            )
        if KNOB_SPECULATIVE in self.armed:
            spec = self._spec_workers()
            spec_batcher = (spec[0] if spec else worker).batcher
            if getattr(spec_batcher, "beams", 1) > 1:
                raise KnobError(
                    "the speculative knob does not apply to beam slots"
                )
            if not (getattr(spec_batcher, "draft_layers", 0)
                    or getattr(spec_batcher, "spec_layers", 0)):
                raise KnobError(
                    "the speculative knob needs the draft-and-verify "
                    "engine (--speculative-draft-layers)"
                )
        if KNOB_PREFIX_POOL in self.armed and batcher.prefix_pool is None:
            raise KnobError(
                "the prefix_pool knob needs a prefix pool "
                "(--prefix-pool with tenancy)"
            )
        if KNOB_PLANE_RATIO in self.armed and self._disagg_pool() is None:
            raise KnobError(
                "the plane_ratio knob needs a disaggregated pool "
                "(planes.DisaggregatedPool)"
            )
        self.refresh_gauges()

    # -- targets ---------------------------------------------------------

    def _workers(self) -> list:
        """The live workers every applied change fans out to."""
        target = self._target
        if hasattr(target, "batcher"):  # a bare worker
            return [target]
        if hasattr(target, "members"):  # WorkerPool of replicas
            return [
                r.worker for r in target.members
                if r.state in ("serving", "draining")
            ]
        return [target.worker]  # ShardedWorkerPool

    def _primary(self):
        workers = self._workers()
        if not workers:
            raise KnobError("the knob target has no live workers")
        return workers[0]

    def retarget(self, target) -> None:
        """Point the actuator at a fresh target (a controller restart
        replaces the pool; the actuator must actuate the LIVE plane,
        not the abandoned pre-crash one).  Staged changes survive and
        apply to the new target at the next safe point;
        :class:`~.fleet.ScheduledFleetDriver` calls this from its
        crash-restart path."""
        self._target = target
        self.refresh_gauges()

    def _multi_replica(self) -> bool:
        return hasattr(self._target, "members")

    def _disagg_pool(self):
        """The DisaggregatedPool under actuation, when the target IS
        one (the plane_ratio knob's state machine; the speculative
        knob's route to the decode-plane worker)."""
        target = self._target
        if hasattr(target, "decode_pool"):
            return target
        return None

    def _spec_workers(self) -> list:
        """The workers whose engine owns the speculative knob: the one
        decode-plane worker on a disaggregated pool (prefill replicas
        run the plain insert and have no drafting surface), every live
        worker otherwise."""
        pool = self._disagg_pool()
        if pool is not None:
            return [pool.decode]
        return self._workers()

    def _shard_pool(self):
        """The ShardedWorkerPool supervising the plane, when the target
        IS one — the shards knob must go through its state machine so
        quarantine/drain bookkeeping stays consistent."""
        target = self._target
        if hasattr(target, "shard_states"):
            return target
        return None

    # -- staging + application -------------------------------------------

    def set(self, knob: str, value) -> bool:
        """Stage one knob change; applied at the next safe point
        (:meth:`apply`, wired between cycles by the scheduler).
        Returns True when the request stages a change, False when it
        is already the live value.  Raises :class:`KnobError` on an
        unarmed knob or an invalid value — validation happens HERE, at
        request time, never mid-cycle."""
        if knob not in self.armed:
            raise KnobError(f"knob {knob!r} is not armed ({self.armed})")
        value = self._validate(knob, value)
        if value == self._read(knob) and knob not in self._staged:
            return False
        self._staged[knob] = value
        return True

    def apply(self) -> list[dict]:
        """Apply every staged change — called between engine cycles
        (the scheduler's safe point).  Returns the changes applied.

        With NO live workers (a whole-fleet outage between kill and the
        loop's respawn), staged changes are kept for the next safe
        point instead of raising — knob actuation must never be the
        thing that kills a recovering fleet."""
        workers = self._workers()
        if workers:
            self._reconcile(workers)
        if not self._staged:
            return []
        if not workers:
            return []  # every replica dead: retry once the loop respawns
        staged, self._staged = self._staged, {}
        applied: list[dict] = []
        for knob in ALL_KNOBS:  # stable order, test-pinned
            if knob not in staged:
                continue
            value = staged[knob]
            previous = self._read(knob)
            if value == previous:
                continue
            self._apply_one(knob, value)
            self._actuated[knob] = value
            change = {
                "knob": knob,
                "value": value,
                "previous": previous,
                "t": self.clock.now(),
            }
            self.changes_total += 1
            self.changes.append(change)
            applied.append(change)
            self.events.append(
                KnobEvent("knob-set", change["t"], {
                    "knob": knob, "value": value, "previous": previous,
                })
            )
            if self.journal is not None:
                try:
                    self.journal.append_event("knob", change)
                except Exception:  # instrumentation must never kill serving
                    log.exception("knob journal write failed")
            log.info("Knob %s: %s -> %s", knob, previous, value)
        if applied:
            self.refresh_gauges()
        return applied

    @property
    def pending(self) -> dict:
        """Staged-but-unapplied knob requests (read-only view)."""
        return dict(self._staged)

    #: host-side per-worker knobs the reconcile pass re-asserts onto
    #: drifted workers (decode_block propagates through the shared
    #: ServiceConfig at spawn; shards is pool-level, never per-worker)
    _PER_WORKER_KNOBS = (
        KNOB_SLOT_LIMIT, KNOB_SPECULATIVE, KNOB_PREFIX_POOL,
    )

    def _reconcile(self, workers) -> None:
        """Re-assert every APPLIED knob value onto workers whose live
        value drifted — a replica spawned after a change constructs at
        the engine defaults, and without this the fleet runs
        split-brain until the knob next moves to a different value.
        Cheap host reads per cycle; writes only on actual drift."""
        for knob in self._PER_WORKER_KNOBS:
            if knob not in self._actuated:
                continue
            value = self._actuated[knob]
            targets = (
                self._spec_workers() if knob == KNOB_SPECULATIVE
                else workers
            )
            for worker in targets:
                try:
                    if self._read(knob, worker) != value:
                        self._apply_to_worker(knob, value, worker)
                except Exception:  # reconcile must never kill serving
                    log.exception(
                        "knob %s reconcile failed on a worker", knob
                    )

    # -- per-knob validation / read / write ------------------------------

    def _validate(self, knob: str, value):
        batcher = self._primary().batcher
        if knob == KNOB_DECODE_BLOCK:
            value = int(value)
            if value < 1:
                raise KnobError(f"decode_block must be >= 1, got {value}")
            if value < 2 and self._multi_replica():
                # a replica spawned at decode_block 1 builds the
                # single-step engine and cannot adopt a block donor —
                # the fleet-shared knob stays on the block engine
                raise KnobError(
                    "decode_block < 2 on a replica fleet would make "
                    "future spawns unable to adopt the donor engine"
                )
            return value
        if knob == KNOB_SLOT_LIMIT:
            value = int(value)
            per_shard = getattr(batcher, "shard_slots", len(batcher.slots))
            if not 0 <= value <= per_shard:
                raise KnobError(
                    f"slot_limit must be in [0, {per_shard}] "
                    f"(0 = unlimited), got {value}"
                )
            return value
        if knob == KNOB_SHARDS:
            value = int(value)
            shards = batcher.shards
            pool = self._shard_pool()
            low = pool.min if pool is not None else 1
            high = pool.max if pool is not None else shards
            if not low <= value <= high:
                raise KnobError(
                    f"shards must be in [{low}, {high}] (allocated "
                    f"{shards}), got {value}"
                )
            return value
        if knob == KNOB_SPECULATIVE:
            return bool(value)
        if knob == KNOB_PLANE_RATIO:
            value = int(value)
            pool = self._disagg_pool()
            if not pool.min <= value <= pool.max:
                raise KnobError(
                    f"plane_ratio (prefill replicas) must be in "
                    f"[{pool.min}, {pool.max}], got {value}"
                )
            return value
        if knob == KNOB_PREFIX_POOL:
            value = int(value)
            pool = batcher.prefix_pool
            floor = getattr(batcher, "shard_slots", len(batcher.slots))
            if not floor <= value <= pool.entries:
                # below the per-shard slot count one admission batch
                # could LRU-evict an entry another row of the SAME
                # batched insert still references (the pool's corruption
                # invariant); above the allocation needs a realloc —
                # that is a redeploy, not a knob
                raise KnobError(
                    f"prefix_pool capacity must be in [{floor}, "
                    f"{pool.entries}] (per-shard slots .. allocated "
                    f"arena), got {value}"
                )
            return value
        raise KnobError(f"unknown knob {knob!r}")

    def _read(self, knob: str, worker=None):
        if knob == KNOB_PLANE_RATIO:
            return self._disagg_pool().replicas
        if knob == KNOB_SPECULATIVE and worker is None:
            spec = self._spec_workers()
            if spec:
                worker = spec[0]
        batcher = (worker or self._primary()).batcher
        if knob == KNOB_DECODE_BLOCK:
            pending = getattr(batcher, "_pending_decode_block", None)
            return pending if pending is not None else batcher.decode_block
        if knob == KNOB_SLOT_LIMIT:
            return batcher.slot_limit or 0
        if knob == KNOB_SHARDS:
            pool = self._shard_pool()
            if pool is not None:
                return pool.replicas
            return sum(1 for a in batcher.shard_admitting if a)
        if knob == KNOB_SPECULATIVE:
            if getattr(batcher, "spec_layers", 0):
                # the decode plane: the knob IS draft-and-verify (the
                # drain-to-plain mode switch), not the round overlap
                return bool(batcher.draft_enabled)
            return bool(batcher.spec_overlap)
        if knob == KNOB_PREFIX_POOL:
            return batcher.prefix_pool.capacity
        raise KnobError(f"unknown knob {knob!r}")

    def _apply_one(self, knob: str, value) -> None:
        workers = self._workers()
        if knob == KNOB_DECODE_BLOCK:
            for worker in workers:
                worker.batcher.request_decode_block(value)
                config = getattr(worker, "config", None)
                if config is not None and hasattr(config, "decode_block"):
                    config.decode_block = value
            if hasattr(self._target, "spawn_decode_block"):
                # replicas spawned after this change serve at the actuated
                # size: each replica holds its own copy of the service
                # config, so the pool's spawn path is told instead
                self._target.spawn_decode_block = value
            return
        if knob == KNOB_SLOT_LIMIT:
            for worker in workers:
                self._apply_to_worker(knob, value, worker)
            return
        if knob == KNOB_SHARDS:
            pool = self._shard_pool()
            if pool is not None:
                # through the Scaler-seam state machine (resurrect/
                # activate/drain ordering and quarantine exclusion all
                # preserved) — but at step size 1: the autoscaler's
                # scale_up_pods/scale_down_pods step toward the clamps,
                # and a multi-pod step can orbit the requested value
                # forever instead of landing on it
                saved = pool.scale_up_pods, pool.scale_down_pods
                pool.scale_up_pods = pool.scale_down_pods = 1
                try:
                    for _ in range(pool.shards):
                        if pool.replicas < value:
                            pool.scale_up()
                        elif pool.replicas > value:
                            pool.scale_down()
                        else:
                            break
                finally:
                    pool.scale_up_pods, pool.scale_down_pods = saved
                if pool.replicas != value:
                    log.warning(
                        "shards knob: pool settled at %d, wanted %d "
                        "(clamps/quarantine bound the reachable range)",
                        pool.replicas, value,
                    )
                return
            batcher = self._primary().batcher
            admitting = [
                s for s in range(batcher.shards)
                if batcher.shard_admitting[s]
            ]
            if len(admitting) < value:
                for s in range(batcher.shards):
                    if len(admitting) >= value:
                        break
                    if not batcher.shard_admitting[s]:
                        batcher.set_shard_active(s, True)
                        admitting.append(s)
            else:
                # drain newest-index first, mirroring the pool's order
                for s in reversed(admitting):
                    if len(admitting) <= value:
                        break
                    batcher.set_shard_active(s, False)
                    admitting.remove(s)
            return
        if knob == KNOB_PLANE_RATIO:
            # through the disaggregated pool's Scaler state machine
            # (spawn/drain ordering, clamps) at step size 1, exactly
            # like the shards knob's pool path
            pool = self._disagg_pool()
            saved = pool.scale_up_pods, pool.scale_down_pods
            pool.scale_up_pods = pool.scale_down_pods = 1
            try:
                for _ in range(pool.max):
                    if pool.replicas < value:
                        pool.scale_up()
                    elif pool.replicas > value:
                        pool.scale_down()
                    else:
                        break
            finally:
                pool.scale_up_pods, pool.scale_down_pods = saved
            if pool.replicas != value:
                log.warning(
                    "plane_ratio knob: pool settled at %d prefill "
                    "replicas, wanted %d",
                    pool.replicas, value,
                )
            return
        if knob in (KNOB_SPECULATIVE, KNOB_PREFIX_POOL):
            targets = (
                self._spec_workers() if knob == KNOB_SPECULATIVE
                else workers
            )
            for worker in targets:
                self._apply_to_worker(knob, value, worker)
            return
        raise KnobError(f"unknown knob {knob!r}")

    def _apply_to_worker(self, knob: str, value, worker) -> None:
        """One per-worker host knob write (the unit the reconcile pass
        re-asserts)."""
        if knob == KNOB_SLOT_LIMIT:
            worker.batcher.set_slot_limit(value or None)
        elif knob == KNOB_SPECULATIVE:
            worker.batcher.set_speculative(value)
        elif knob == KNOB_PREFIX_POOL:
            worker.batcher.prefix_pool.set_capacity(value)
        else:
            raise KnobError(f"knob {knob!r} is not per-worker")

    # -- observability ---------------------------------------------------

    def current(self) -> dict:
        """Live value of every armed knob (the gauges' source)."""
        return {knob: self._read(knob) for knob in self.armed}

    def refresh_gauges(self) -> None:
        if self.metrics is None:
            return
        try:
            values = self.current()
        except KnobError:
            return  # no live workers to read: keep the last export
        for knob, value in values.items():
            self.metrics.set_gauge(
                "engine_knob", float(int(value)),
                "Live engine-knob operating point, actuated between "
                "cycles at safe points (decode_block size, slot_limit "
                "admission cap (0 = unlimited), serving shards, "
                "speculative round overlap (0/1), prefix-pool "
                "residency capacity).",
                labels=(("knob", knob),),
            )
        self.metrics.set_gauge(
            "engine_knob_changes_total", self.changes_total,
            "Knob changes applied over the actuator's lifetime.",
            kind="counter",
        )

    def trace_events(self, time_origin: float | None = None) -> list[dict]:
        """Applied knob changes as Chrome-trace instants (their own
        ``knob`` category; merge via ``to_chrome_trace(...,
        extra_events=...)``)."""
        from ..obs.trace import instant_trace_events

        return instant_trace_events(self.events, time_origin)

    # -- durable-state surface (core/durable.py StateProvider) -----------

    def export_state(self) -> dict:
        values = self.current()
        # a pending staged value is the operator's latest intent — the
        # snapshot carries it so a crash between stage and apply still
        # lands the change after restart
        values.update(self._staged)
        return {"records": len(values), "knobs": values,
                "changes_total": self.changes_total}

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: float | None = None, max_age_s: float = 0.0,
    ) -> int:
        """Re-stage the snapshot's operating point; it re-applies at
        the first safe point after restart.  Knob values are not
        clocked, so rebase/age do not apply."""
        del rebase, now, max_age_s
        knobs = state.get("knobs")
        if not isinstance(knobs, dict):
            return 0
        recovered = 0
        for knob, value in knobs.items():
            if knob not in self.armed:
                continue
            try:
                self.set(knob, value)
            except KnobError as err:
                log.warning("dropping restored knob %s=%r (%s)",
                            knob, value, err)
                continue
            recovered += 1
        self.changes_total = int(state.get("changes_total", 0) or 0)
        return recovered


class ReactiveKnobPolicy:
    """A minimal depth-thresholded knob policy: deep backlog -> big
    decode block (amortize host overhead), shallow interactive traffic
    -> small block (tight TTFT floor).  Hysteresis between the two
    thresholds holds the current value.

    This is the worker binary's default driver when ``--knobs`` arms
    ``decode-block``.
    """

    def __init__(self, actuator: KnobActuator, depth_fn, *,
                 high: int, low: int, block_high: int = 16,
                 block_low: int = 2) -> None:
        if low > high:
            raise KnobError(f"need low ({low}) <= high ({high})")
        if block_low < 1 or block_high < block_low:
            raise KnobError(
                f"need 1 <= block_low ({block_low}) <= block_high "
                f"({block_high})"
            )
        self.actuator = actuator
        self.depth_fn = depth_fn
        self.high = high
        self.low = low
        self.block_high = block_high
        self.block_low = block_low
        self.decisions = 0

    def evaluate(self) -> None:
        """One decision: read the backlog signal, stage the block.
        ANY failure — a metric-read error from ``depth_fn`` (the
        control loop rides those out via its stale-hold path; the knob
        decision must too), or a whole-fleet outage with no live
        workers to validate against — skips the decision, never
        propagates: knob policy is advisory and must not be the thing
        that kills a serving fleet."""
        self.decisions += 1
        try:
            depth = self.depth_fn()
            if depth >= self.high:
                self.actuator.set(KNOB_DECODE_BLOCK, self.block_high)
            elif depth <= self.low:
                self.actuator.set(KNOB_DECODE_BLOCK, self.block_low)
        except Exception as err:
            log.warning("knob decision skipped: %s", err)


class LearnedKnobPolicy:
    """The learned knob head on the knob seam: a knob-headed
    :class:`~..learn.policy.LearnedPolicy` emits a ladder delta in
    {-1, 0, +1} each tick (``last_knob_delta``, from
    :func:`~..learn.network.knob_delta_decision`); this adapter walks
    the decode-block ladder by it and stages the result on the
    actuator.  The same ``evaluate()`` surface as
    :class:`ReactiveKnobPolicy`, so the scheduler wires either without
    caring which brain decided."""

    def __init__(self, actuator: KnobActuator, policy, *,
                 ladder: tuple[int, ...] = (1, 2, 4, 8, 16, 32)) -> None:
        if not ladder or list(ladder) != sorted(set(ladder)):
            raise KnobError(
                f"ladder must be strictly increasing, got {ladder}"
            )
        self.actuator = actuator
        self.policy = policy
        self.ladder = tuple(int(b) for b in ladder)
        self.decisions = 0

    def rebind(self, policy) -> None:
        """Point the adapter at a fresh brain — a controller restart
        rebuilds the LearnedPolicy; reading the dead one's frozen delta
        forever would walk the ladder to an extreme.
        :class:`~.fleet.ScheduledFleetDriver` calls this from its
        crash-restart path."""
        self.policy = policy

    def evaluate(self) -> None:
        self.decisions += 1
        try:
            # CONSUME the delta (take_knob_delta clears it): the
            # adapter runs every tick, including metric-failure ticks
            # where the policy made no new decision — a stale delta
            # must step the ladder at most once
            take = getattr(self.policy, "take_knob_delta", None)
            delta = (
                take() if take is not None
                else getattr(self.policy, "last_knob_delta", None)
            )
            if not delta:  # None (no tick yet / headless) or hold
                return
            current = self.actuator._read(KNOB_DECODE_BLOCK)
            # the highest rung <= current anchors the walk (a knob
            # value set off-ladder still steps sanely)
            idx = 0
            for i, rung in enumerate(self.ladder):
                if rung <= current:
                    idx = i
            idx = max(0, min(len(self.ladder) - 1, idx + int(delta)))
            self.actuator.set(KNOB_DECODE_BLOCK, self.ladder[idx])
        except Exception as err:
            # whole-fleet outage / broken brain: skip the decision,
            # never kill the fleet (same contract as ReactiveKnobPolicy)
            log.warning("knob decision skipped: %s", err)
