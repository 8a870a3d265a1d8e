"""The collective scheduler: transfers as first-class scheduled work.

:class:`CollectiveScheduler` owns a queue of :class:`~.ops.TransferOp`
and decides when the moves start.  The engine calls :meth:`flush`
inside its dispatch-ahead window — immediately AFTER the next decode
block / gang block is dispatched and BEFORE it blocks on the previous
one — so every queued pull starts device-side while the block computes
(the dispatch-ahead overlap budget).  Ops flushed there are counted
``overlapped``; the settle that later consumes a prefetched array is
no longer a blocking host round-trip, which is exactly what the
``host_transfers`` odometer stops counting.

On the card the engines already start every device-to-host copy when
the result is produced (``continuous._HostCopy``: a ``non_blocking``
copy into pinned memory behind a recorded event), so a settle pull's
dispatch issues no second copy: it marks the existing copies started,
and :meth:`finish` waits on their events.

Small same-``(destination, kind)`` ops coalesce into ONE batched
dispatch per flush (size-bucketed — the NCCL chunking idea), so
transfer dispatches stay O(1) per cycle no matter how many deferred
first-token arrays pile up.  A coalesced group SEALS at the
``small_bytes`` threshold: the ops that would push it past dispatch
as one group and a fresh group opens, so one flush window can never
grow a single batched dispatch without bound.

With a :class:`~.topology.Topology` attached the scheduler also picks
WHICH ROUTE: every op gets a concrete
multi-hop route from the :class:`~.routing.RoutePlanner` (large ops
chunked across link-disjoint paths, small ops latency-minimal),
coalescing keys on the FIRST CONTENDED LINK instead of the
destination, and dispatch order is chosen greedily against a
per-link virtual-time :class:`~.routing.LinkLedger` so concurrent
transfers never oversubscribe a modeled link.  Routing off
(``topology=None``) is byte-identical to the WHEN-only scheduler,
counters included.

The scheduler also registers on the ``sched/`` event queue
(:meth:`register`): a recurring ``comms-flush`` event drains anything
an engine window missed, at :data:`~..sched.PRIORITY_CYCLE` like the
serving cycles it rides between.  Those safety-net flushes run with no
block in flight and are counted non-overlapped — the counters never
flatter the overlap.

With no scheduler attached (``engine.comms is None``) every engine
path is byte-identical to the pre-comms code, counters included.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Sequence

from .ops import (
    SMALL_OP_BYTES,
    TRANSFER_KINDS,
    TransferOp,
    settle_pull_op,
    size_bucket,
)


class CollectiveScheduler:
    """Queue, coalesce, dispatch, and account for transfer ops.

    ``lifecycle`` (a :class:`~..obs.lifecycle.LifecycleRegistry`) gets
    paired ``transfer`` / ``transfer_done`` stamps for every rid an op
    serves, which is what renders the op as a span on the request's
    Perfetto ``transfers`` lane — visibly parallel to the decode span
    hiding it.  ``enabled=False`` parks the scheduler: submits return
    ``None`` and flushes are no-ops, so a wired-but-disabled scheduler
    is byte-identical to no scheduler at all.
    """

    def __init__(
        self,
        *,
        lifecycle: Any = None,
        enabled: bool = True,
        small_bytes: int = SMALL_OP_BYTES,
        trace_len: int = 256,
        topology: Any = None,
    ) -> None:
        self.lifecycle = lifecycle
        self.enabled = enabled
        self.small_bytes = small_bytes
        self._pending: list[TransferOp] = []
        #: most recent dispatched ops, for debugging
        self.recent: deque = deque(maxlen=trace_len)
        # the counter family the tests pin
        self.transfer_dispatches = 0
        self.transfer_bytes = 0
        self.overlapped_transfers_total = 0
        self.submitted_ops = 0
        self.dispatched_ops = 0
        self.coalesced_ops = 0
        self.finished_ops = 0
        self.flushes = 0
        self.by_kind = {kind: 0 for kind in TRANSFER_KINDS}
        self.by_bucket: dict[str, int] = {}
        # -- routing (None = the WHEN-only scheduler, exactly) --
        self.topology = topology
        self.planner = None
        self.ledger = None
        #: virtual now of the link ledger: each flush/record reserves
        #: its routes here and advances it to the latest finish, so
        #: sequential flushes never falsely overlap
        self.vt_now = 0.0
        self.routed_ops = 0
        self.route_chunks = 0
        self.local_ops = 0
        if topology is not None:
            from .routing import LinkLedger, RoutePlanner

            self.planner = RoutePlanner(topology, small_bytes=small_bytes)
            self.ledger = LinkLedger(topology)

    def _now(self) -> float:
        now_fn = getattr(self.lifecycle, "now_fn", None)
        return now_fn() if now_fn is not None else time.time()

    def _stamp(self, op: TransferOp, name: str, t: float) -> None:
        lc = self.lifecycle
        if lc is None:
            return
        for rid in op.rids:
            lc.stamp(rid, name, t=t)

    # -- the producer surface -------------------------------------------

    def submit(self, op: TransferOp) -> TransferOp | None:
        """Queue one op for the next flush (None when disabled)."""
        if not self.enabled:
            return None
        self._pending.append(op)
        self.submitted_ops += 1
        return op

    def settle_pull(
        self,
        arrays: Any,
        *,
        wait: Callable[[], Any] | None = None,
        destination: str = "host",
        source: str = "device",
        rids: Sequence[str] = (),
        args: dict | None = None,
    ) -> TransferOp | None:
        """Queue a device→host pull of ``arrays`` (see
        :func:`~.ops.settle_pull_op`)."""
        if not self.enabled:
            return None
        return self.submit(
            settle_pull_op(
                arrays, wait=wait, destination=destination, source=source,
                rids=rids, args=args,
            )
        )

    def record(
        self,
        kind: str,
        destination: str,
        nbytes: int,
        *,
        source: str = "host",
        rids: Sequence[str] = (),
        t0: float | None = None,
        overlapped: bool = False,
        args: dict | None = None,
    ) -> TransferOp | None:
        """Account for a move a kernel already launched (handoff
        gathers, prefix installs, evacuation flushes): one dispatch,
        its bytes, and a closed ``transfer`` span from ``t0`` (default
        now) to now on every rid.  With a topology attached the move's
        route is still planned and charged to the link ledger — the
        bytes crossed the fabric whether or not we chose when."""
        if not self.enabled:
            return None
        now = self._now()
        op = TransferOp(
            kind=kind,
            destination=destination,
            nbytes=int(nbytes),
            source=source,
            rids=tuple(r for r in rids if r),
            args=dict(args or {}),
        )
        op.dispatched = True
        op.dispatched_t = now if t0 is None else t0
        op.overlapped = overlapped
        self.submitted_ops += 1
        self.dispatched_ops += 1
        self.transfer_dispatches += 1
        self.transfer_bytes += op.nbytes
        if overlapped:
            self.overlapped_transfers_total += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        bucket = size_bucket(op.nbytes)
        self.by_bucket[bucket] = self.by_bucket.get(bucket, 0) + 1
        if self.planner is not None:
            self.vt_now = max(self.vt_now, self._route(op, self.vt_now))
        self._stamp(op, "transfer", op.dispatched_t)
        self.recent.append(op)
        self.finish(op, t=now)
        return op

    # -- routing ---------------------------------------------------------

    def _route(self, op: TransferOp, t: float) -> float:
        """Plan ``op``'s route, reserve it on the ledger at virtual
        time ``t``, stamp the hop lists into ``op.args`` and the
        lifecycle traces, and return the modeled finish."""
        plan = self.planner.plan(op.source, op.destination, op.nbytes)
        if plan.local:
            self.local_ops += 1
            finish = t
            hops: list = []
            op.args["route"] = hops
        else:
            finish = t
            for chunk in plan.chunks:
                _, f = self.ledger.reserve(chunk.path, chunk.nbytes, t)
                finish = max(finish, f)
            hops = plan.paths
            op.args["route"] = hops
            op.args["route_chunks"] = len(plan.chunks)
            self.routed_ops += 1
            self.route_chunks += len(plan.chunks)
        # every op appends (an empty list for local moves) so the i-th
        # route lines up with the trace's i-th transfer span
        lc = self.lifecycle
        route_fn = getattr(lc, "route", None) if lc is not None else None
        if route_fn is not None:
            for rid in op.rids:
                route_fn(rid, hops)
        return finish

    def _coalesce_key(self, op: TransferOp) -> tuple:
        """The grouping key: first contended link when routing (ops
        that will fight for the same first hop batch together), the
        ``(destination, kind)`` otherwise."""
        if self.planner is not None:
            first = self.planner.first_hop(
                op.source, op.destination, op.nbytes,
            )
            return (first or op.destination, op.kind)
        return op.coalesce_key()

    # -- the scheduling surface -----------------------------------------

    @property
    def pending(self) -> int:
        return len(self._pending)

    def flush(self, *, overlapped: bool = False) -> int:
        """Dispatch every queued op device-side and return the number
        of DISPATCHES (coalesced groups count once).

        ``overlapped=True`` asserts the caller just dispatched the next
        block — the window the started copies hide in; the safety-net
        ``sched/`` flush passes False.  Small ops sharing a
        ``(destination, kind)`` key batch into one dispatch; each op
        still runs its own ``dispatch`` thunk (the async starts are the
        batch), but the cycle pays one dispatch count per group.
        """
        if not self.enabled or not self._pending:
            return 0
        pending, self._pending = self._pending, []
        self.flushes += 1
        now = self._now()
        sealed: list[list[TransferOp]] = []
        groups: dict[tuple, list[TransferOp]] = {}
        group_bytes: dict[tuple, int] = {}
        singles: list[TransferOp] = []
        for op in pending:
            if op.nbytes <= self.small_bytes:
                key = self._coalesce_key(op)
                group = groups.setdefault(key, [])
                if group and group_bytes[key] + op.nbytes \
                        > self.small_bytes:
                    # the bucket seam: the op that would push a
                    # coalesced group past the small-op threshold
                    # seals it (one dispatch at the threshold) and
                    # opens a fresh group under the same key
                    sealed.append(group)
                    group = []
                    groups[key] = group
                    group_bytes[key] = 0
                group.append(op)
                group_bytes[key] = group_bytes.get(key, 0) + op.nbytes
            else:
                singles.append(op)
        batches = (
            sealed
            + [g for g in groups.values() if g]
            + [[op] for op in singles]
        )
        if self.planner is not None:
            batches = self._routed_order(batches)
        dispatches = 0
        for batch in batches:
            dispatches += 1
            self.transfer_dispatches += 1
            if len(batch) > 1:
                self.coalesced_ops += len(batch)
            for op in batch:
                if op.dispatch is not None:
                    op.dispatch()
                op.dispatched = True
                op.dispatched_t = now
                op.overlapped = overlapped
                self.dispatched_ops += 1
                self.transfer_bytes += op.nbytes
                if overlapped:
                    self.overlapped_transfers_total += 1
                self.by_kind[op.kind] = self.by_kind.get(op.kind, 0) + 1
                bucket = size_bucket(op.nbytes)
                self.by_bucket[bucket] = self.by_bucket.get(bucket, 0) + 1
                self._stamp(op, "transfer", now)
                self.recent.append(op)
        return dispatches

    def _routed_order(
        self, batches: list[list[TransferOp]]
    ) -> list[list[TransferOp]]:
        """Dispatch order against the link ledger: greedily take the
        batch whose first link frees earliest, reserving each batch's
        routes as it is picked — contention serializes on the ledger,
        disjoint routes interleave.  Advances :attr:`vt_now` to the
        latest modeled finish so the NEXT flush starts after this one.
        Returns the batches in chosen order (counter/dispatch work
        stays in :meth:`flush`)."""
        t0 = self.vt_now
        plans = {
            id(batch): self.planner.plan(
                batch[0].source, batch[0].destination,
                sum(op.nbytes for op in batch),
            )
            for batch in batches
        }
        remaining = list(enumerate(batches))
        ordered: list[list[TransferOp]] = []
        finish_vt = t0
        while remaining:
            remaining.sort(key=lambda item: (
                self.ledger.earliest_start(
                    plans[id(item[1])].chunks[0].path
                    if plans[id(item[1])].chunks else (),
                    t0,
                ),
                item[0],
            ))
            index, batch = remaining.pop(0)
            for op in batch:
                finish_vt = max(finish_vt, self._route(op, t0))
            ordered.append(batch)
        self.vt_now = max(self.vt_now, finish_vt)
        return ordered

    def finish(
        self, op: TransferOp | None, *, t: float | None = None
    ) -> None:
        """Close an op's span at the moment its bytes were consumed
        host-side, after waiting for them where the op carries a
        ``wait`` (idempotent; None-safe for unsubmitted ops)."""
        if op is None or op.finished:
            return
        if op.wait is not None:
            op.wait()
        op.finished = True
        op.finished_t = self._now() if t is None else t
        self.finished_ops += 1
        self._stamp(op, "transfer_done", op.finished_t)

    # -- sched/ integration ---------------------------------------------

    def register(
        self,
        scheduler: Any,
        *,
        period: float = 1.0,
        name: str = "comms-flush",
    ) -> Any:
        """Register the safety-net flush as a recurring ``sched/``
        event (PRIORITY_CYCLE — it rides between serving cycles).  The
        event drains ops no engine window flushed; those dispatches run
        with no block in flight, so they count non-overlapped."""
        from ..sched import PRIORITY_CYCLE

        return scheduler.every(
            name, period,
            lambda: self.flush(overlapped=False),
            priority=PRIORITY_CYCLE,
        )

    # -- introspection ---------------------------------------------------

    def counters(self) -> dict:
        """The counter family (assertions and reports).  The
        ``routing`` sub-dict appears ONLY with a topology attached —
        ``topology=None`` counters stay byte-identical to the
        WHEN-only scheduler (the routes parity battery pins the whole
        dict)."""
        out = {
            "transfer_dispatches": self.transfer_dispatches,
            "transfer_bytes": self.transfer_bytes,
            "overlapped_transfers_total": self.overlapped_transfers_total,
            "submitted_ops": self.submitted_ops,
            "dispatched_ops": self.dispatched_ops,
            "coalesced_ops": self.coalesced_ops,
            "finished_ops": self.finished_ops,
            "flushes": self.flushes,
            "pending": len(self._pending),
            "by_kind": dict(self.by_kind),
            "by_bucket": dict(self.by_bucket),
        }
        if self.topology is not None:
            out["routing"] = {
                "routed_ops": self.routed_ops,
                "route_chunks": self.route_chunks,
                "local_ops": self.local_ops,
                "virtual_now_s": self.vt_now,
                "link_bytes": dict(sorted(self.ledger.link_bytes.items())),
            }
        return out

    def topology_snapshot(self) -> dict | None:
        """The ``/debug/topology`` body: the graph, the live ledger,
        and the routing odometers (None without a topology)."""
        if self.topology is None:
            return None
        return {
            "topology": self.topology.snapshot(),
            "ledger": self.ledger.snapshot(),
            "routing": {
                "routed_ops": self.routed_ops,
                "route_chunks": self.route_chunks,
                "local_ops": self.local_ops,
                "virtual_now_s": self.vt_now,
            },
        }

    def export_gauges(self, metrics: Any) -> None:
        """Per-link observability: ``link_bytes_total{link=}`` /
        ``link_utilization{link=}`` into a
        :class:`~..obs.prometheus.WorkloadMetrics` registry (no-op
        without a topology — no phantom series)."""
        if metrics is None or self.topology is None:
            return
        horizon = self.vt_now if self.vt_now > 0 else None
        utilization = self.ledger.utilization(horizon)
        for name, nbytes in sorted(self.ledger.link_bytes.items()):
            metrics.set_gauge(
                "link_bytes_total", nbytes,
                "Modeled bytes routed over each topology link by the "
                "collective scheduler's route planner.",
                labels=(("link", name),), kind="counter",
            )
        for name, frac in utilization.items():
            metrics.set_gauge(
                "link_utilization", frac,
                "Busy fraction of each topology link over the routing "
                "ledger's virtual time.",
                labels=(("link", name),),
            )
