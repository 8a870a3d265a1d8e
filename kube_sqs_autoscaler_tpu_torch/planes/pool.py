"""DisaggregatedPool: the prefill plane and the decode plane, each behind a
``Scaler`` seam.

The port's copy of ``kube_sqs_autoscaler_tpu/planes/pool.py``.  A
:class:`~..fleet.pool.WorkerPool` of prefill replicas feeds one decode
plane (a :class:`~.engine.DecodePlaneBatcher` behind a
:class:`~..fleet.worker.FleetWorker`, wrapped in a
:class:`~..fleet.sharded.ShardedWorkerPool`):

- the pool itself scales the prefill plane (``scale_up`` / ``scale_down``
  spawn and drain prefill replicas, as the replica pool does);
- :attr:`DisaggregatedPool.decode_pool` scales the decode plane by shard
  mask flips.

Only the prefill replicas read the queue.  Each cycle the pool supervises
and steps the prefill plane, moves every started row across the KV
handoff (:meth:`~.engine.DecodePlaneBatcher.submit_handoff`), capped by the
decode plane's free slots and freeing the donor rows after the copy is
enqueued, and steps the decode plane ``decode_steps_per_cycle`` times,
with a shuttle before each step.  Both planes settle through the one reply
registry of :class:`~..fleet.pool.FleetPoolBase`: a prefill replica killed
mid-request has its rows re-dispatched to survivors, a visibility-timeout
redelivery of a request the decode plane holds is prefilled and handed off
again, and the registry suppresses whichever reply comes second.  The
decode plane is one failure domain; losing it whole is the queue's
visibility timeout's job.

Importing this module imports no torch: the workers are imported when
:meth:`DisaggregatedPool.serving` builds them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from ..fleet.pool import DRAINING, SERVING, WorkerPool, _free_count
from ..fleet.sharded import ShardedWorkerPool

log = logging.getLogger(__name__)

# the durable-state section of the pool: the reply registry and the
# decode plane's drafting mode
DISAGG_SECTION = "disagg_pool"

class DisaggregatedPool(WorkerPool):
    """Supervised prefill replicas shuttling KV to one decode plane.

    ``prefill_factory(pool)`` builds one prefill replica (a
    :class:`~.prefill.PrefillWorker`, or a stub in the contract tests);
    ``decode_factory(pool)`` is called once, after the first prefill
    spawns, for the decode-plane worker, built with ``pool=<this pool>``
    so its settles dedup through the shared registry, and its admission is
    off.  ``min`` / ``max`` / ``scale_up_pods`` / ``scale_down_pods``
    govern the prefill plane, the ``decode_*`` twins
    :attr:`decode_pool`'s shards."""

    def __init__(
        self,
        prefill_factory: Callable[["DisaggregatedPool"], Any],
        decode_factory: Callable[["DisaggregatedPool"], Any],
        *,
        min: int,
        max: int,
        decode_min: int = 1,
        decode_max: int | None = None,
        decode_initial: int | None = None,
        decode_scale_up_pods: int = 1,
        decode_scale_down_pods: int = 1,
        decode_steps_per_cycle: int = 2,
        **pool_kwargs,
    ) -> None:
        if decode_steps_per_cycle < 1:
            raise ValueError("decode_steps_per_cycle must be >= 1")
        super().__init__(prefill_factory, min=min, max=max, **pool_kwargs)
        self.decode_steps_per_cycle = decode_steps_per_cycle
        # the inner pool's own registry goes unused: the decode worker
        # settles through this pool's
        self.decode_pool = ShardedWorkerPool(
            lambda _inner: decode_factory(self),
            min=decode_min, max=decode_max, initial=decode_initial,
            scale_up_pods=decode_scale_up_pods,
            scale_down_pods=decode_scale_down_pods, clock=self.clock,
        )
        self.decode = self.decode_pool.worker
        self.decode.admitting = False
        self.kv_handoffs_total = 0

    # -- the cycle: supervise, prefill, handoff, decode -------------------

    def run_cycle(self) -> int:
        """One disaggregated cycle; returns the requests completed on both
        planes.  The prefill replicas step first, the shuttle moves every
        ready row the decode plane has a slot for (draining replicas
        first, then the busiest serving one), the decode plane steps, and
        drained prefill replicas retire once empty."""
        self.cycle += 1
        self._supervise()
        done = 0
        serving: list = []
        draining: list = []
        for replica in self.members:
            if replica.state == SERVING:
                serving.append(replica)
            elif replica.state == DRAINING:
                draining.append(replica)
        serving.sort(key=lambda r: _free_count(r.worker.batcher),
                     reverse=True)
        for replica in serving:
            if self._orphans:
                self._dispatch_orphans(replica)
            done += replica.worker.run_once()
        for replica in draining:
            done += replica.worker.run_once()
        # the decode plane's cadence is its own: it steps
        # decode_steps_per_cycle times a fleet cycle, a shuttle before
        # each step, so slots one gang settle frees refill before the next
        order = draining + serving[::-1]
        self._shuttle(order)
        done += self.decode_pool.run_cycle()
        for _ in range(self.decode_steps_per_cycle - 1):
            self._shuttle(order)
            done += self.decode.run_once()
        for replica in draining:
            if replica.worker.batcher.active == 0:
                self._retire(replica, released=0)
            elif (self.drain_timeout_cycles is not None
                  and replica.drain_started_cycle is not None
                  and self.cycle - replica.drain_started_cycle
                  >= self.drain_timeout_cycles):
                released = replica.worker.release_inflight()
                self.released_total += released
                self._retire(replica, released=released)
        self._prune_retired()
        self._update_metrics()
        return done

    def _shuttle(self, replicas: list) -> int:
        """Move ready prefill rows into decode slots: one
        :meth:`~.engine.DecodePlaneBatcher.submit_handoff` (one device copy)
        per donor replica, capped by the decode plane's free slots, the
        donor rows freed after the copy is enqueued.  Returns the rows
        moved."""
        batcher = self.decode.batcher
        submit = getattr(batcher, "submit_handoff", None)
        if submit is None:  # contract-test stubs have no handoff
            return 0
        free = _free_count(batcher)
        moved = 0
        for replica in replicas:
            worker = replica.worker
            ready = getattr(worker, "ready_handoffs", None)
            if ready is None:
                continue
            all_ready = ready()
            if not all_ready:
                continue
            # rows waiting for a decode slot are backpressure, not a
            # wedge: the progress watchdog must not count them (a hung
            # replica still trips the idle watchdog once its rows leave)
            replica.stalled_cycles = 0
            if free <= 0:
                continue
            records = all_ready[:free]
            submit(worker.batcher, records)
            worker.complete_handoff([rec[0] for rec in records])
            free -= len(records)
            moved += len(records)
            self._event("kv-handoff", replica=replica.index,
                        rows=len(records))
        self.kv_handoffs_total += moved
        return moved

    # -- accounting over both planes ---------------------------------------

    @property
    def processed(self) -> int:
        return super().processed + self.decode.processed

    @property
    def completed_by_tenant(self) -> dict[str, int]:
        totals = dict(super().completed_by_tenant)
        for tenant, count in getattr(self.decode, "completed_by_tenant",
                                     {}).items():
            totals[tenant] = totals.get(tenant, 0) + count
        return totals

    @property
    def idle(self) -> bool:
        # a row awaiting handoff keeps its prefill slot busy, so prefill
        # idleness covers the shuttle
        return (super().idle and self.decode.batcher.active == 0
                and getattr(self.decode, "staged", 0) == 0)

    def stop_all(self) -> None:
        super().stop_all()
        self.decode_pool.stop_all()

    # -- durable state (section DISAGG_SECTION): the reply registry and the
    # drafting mode a restart must not forget; replica and shard counts
    # stay out, the autoscaler derives them again -----------------------------

    def export_state(self) -> dict:
        state = super().export_state()
        state["kv_handoffs_total"] = self.kv_handoffs_total
        draft = getattr(self.decode.batcher, "draft_enabled", None)
        if draft is not None:
            state["draft_enabled"] = bool(draft)
        return state

    def import_state(self, state: dict, *, rebase: float = 0.0,
                     now: float | None = None,
                     max_age_s: float = 0.0) -> int:
        recovered = super().import_state(state)
        self.kv_handoffs_total = int(state.get("kv_handoffs_total", 0) or 0)
        draft = state.get("draft_enabled")
        batcher = self.decode.batcher
        if draft is not None and getattr(batcher, "spec_layers", 0):
            # restored silently: a rehydration is not a knob flip
            batcher.draft_enabled = bool(draft)
        return recovered

    # -- observability -------------------------------------------------------

    def _update_metrics(self) -> None:
        super()._update_metrics()
        if self.metrics is None:
            return
        self.metrics.set_plane_pool_gauges(
            prefill_replicas=self.replicas,
            decode_shards=self.decode_pool.replicas,
            kv_handoffs=self.kv_handoffs_total,
        )

    def attach_metrics(self, metrics) -> None:
        self.decode_pool.metrics = metrics
        super().attach_metrics(metrics)

    def attach_lifecycle(self, registry) -> None:
        """One registry across both planes: a request's chain runs
        arrival -> first_token on a prefill replica, handoff on the decode
        plane and completed -> reply on the decode worker, so split
        registries would each see half a chain."""
        self.decode_pool.attach_lifecycle(registry)
        super().attach_lifecycle(registry)

    def attach_comms(self, comms) -> None:
        """Wire one :class:`~..comms.CollectiveScheduler` through both
        planes' engines (current members; attach before serving): the
        decode plane's and the prefill replicas' settle pulls ride their
        dispatch-ahead windows, and every KV handoff records its bytes."""
        self.comms = comms
        topology = getattr(comms, "topology", None)
        if topology is not None:
            # the handoff endpoints are routable from the first move on
            topology.ensure_node("prefill")
            topology.ensure_node("decode-plane")
        attach = getattr(self.decode.batcher, "attach_comms", None)
        if attach is not None:
            attach(comms)
        for replica in self.members:
            batcher = getattr(replica.worker, "batcher", None)
            attach = getattr(batcher, "attach_comms", None)
            if attach is not None:
                attach(comms)

    # -- real planes -----------------------------------------------------------

    @classmethod
    def serving(  # type: ignore[override]
        cls,
        queue,
        params,
        model_config,
        service_config,
        *,
        min: int,
        max: int,
        decode_shards: int,
        decode_min: int = 1,
        spec_layers: int = 1,
        spec_tokens: int = 4,
        draft_enabled: bool | None = None,
        family: str | None = None,
        result_queue=None,
        now_fn=None,
        tenancy=None,
        device="cuda",
        prefill_engine_source=None,
        decode_engine_source=None,
        **pool_kwargs,
    ) -> "DisaggregatedPool":
        """Real planes over one queue on ``device`` (``"cuda"`` by default;
        a missing card raises): ``min``..``max``
        :class:`~.prefill.PrefillWorker` replicas (params shared, the engine
        adopted from the first, or from ``prefill_engine_source``) feeding a
        ``decode_shards``-shard :class:`~.engine.DecodePlaneBatcher`
        (adopting ``decode_engine_source`` when given).  The decode plane is
        always drafted (``spec_layers >= 1``); plain decode is
        ``draft_enabled=False``, a mode of the same engine."""
        if spec_layers < 1:
            raise ValueError(
                "the decode plane is built drafted (spec_layers >= 1); run "
                "plain via draft_enabled=False, not spec_layers=0"
            )

        def prefill_factory(pool: "DisaggregatedPool"):
            from .prefill import PrefillWorker

            seeded = dataclasses.replace(
                service_config,
                sample_seed=(service_config.sample_seed
                             + pool.next_spawn_ordinal()),
            )
            return PrefillWorker(
                queue, params, model_config, seeded, family=family,
                result_queue=result_queue, pool=pool, tenancy=tenancy,
                now_fn=now_fn, device=device,
                engine_source=pool.engine_donor() or prefill_engine_source,
            )

        def decode_factory(pool: "DisaggregatedPool"):
            from ..fleet.worker import FleetWorker

            seeded = dataclasses.replace(service_config,
                                         shards=decode_shards)
            worker = FleetWorker(
                queue, params, model_config, seeded, family=family,
                result_queue=result_queue, pool=pool, tenancy=tenancy,
                now_fn=now_fn, device=device, sharded=True,
                draft_layers=spec_layers, draft_tokens=spec_tokens,
                engine_source=decode_engine_source,
            )
            if draft_enabled is not None:
                worker.batcher.set_speculative(draft_enabled)
                worker.batcher.spec_flips = 0  # construction, not a flip
            return worker

        return cls(prefill_factory, decode_factory, min=min, max=max,
                   decode_min=decode_min, decode_max=decode_shards,
                   decode_initial=decode_shards, **pool_kwargs)
