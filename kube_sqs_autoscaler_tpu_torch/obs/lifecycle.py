"""Request-lifecycle tracing: per-phase latency decomposition.

The port's copy of ``kube_sqs_autoscaler_tpu/obs/lifecycle.py``: pure
host code, whose snapshots and exported state equal the reference's dict
for dict on the same stamp sequence.

The flight recorder sees the world in ticks and the fleet exports
aggregate gauges, but neither can answer "where did THIS request's p99
go".  This module is the missing layer: a bounded, host-side registry
of :class:`RequestTrace` records, stamped with monotonic phase
timestamps at each seam a request already crosses —

==============  ======================================================
phase           stamped when
==============  ======================================================
``arrival``     the queue stamped the message (``SentTimestamp``;
                admission time when the queue does not stamp)
``staged``      the request entered a DRR staging sub-queue
                (tenancy only)
``picked``      the DRR pick admitted it out of staging (tenancy only)
``admitted``    the worker committed it to the batched prefill insert
``prefill``     the prefill insert dispatch that covers its row
``first_token`` its first token settled host-side (TTFT)
``handoff``     its KV rows landed in a decode-plane slot
                (disaggregated serving only)
``completed``   its final token settled (the slot freed)
``reply``       the reply was sent / the input deleted — exactly once
==============  ======================================================

plus per-token advance times (:meth:`LifecycleRegistry.token`, fed by
the engine's one ``_emit`` funnel) for inter-token latency, and
free-form notes (``redispatched``, ``resumed``, ``handed_off``,
``duplicate``) at the failover seams.

Every stamp happens at an existing host-visible moment: tracing adds
ZERO device dispatches and ZERO transfers (the engine odometers pin
this), and with no registry attached every producer pays
one ``is None`` check — the engine path is byte-identical off.

The registry is a durable-state section (:class:`~..core.durable`
``StateProvider``): open traces ride the controller snapshot and come
back on restart, and restored registries bump :attr:`epoch` so flow
ids minted after a restart can never collide with pre-crash ones.
Completeness of the resulting chains doubles as a correctness audit of
exactly-once and the KV-handoff path: every answered request must show
a gap-free monotone chain with exactly one ``reply`` stamp, through
kills, re-dispatch, evacuation, redelivery-dedup, and restart
(:func:`validate_chain`; ``chip_smoke.py``'s ``orchestration`` phase
gates it on the card).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

#: Canonical seam order — validation takes each present phase's FIRST
#: occurrence and requires non-decreasing times along this sequence
#: (re-stamps from re-dispatch/redelivery append later and are allowed;
#: a request crosses each seam for the first time in this order).
PHASE_ORDER = (
    "arrival", "staged", "picked", "admitted", "prefill",
    "first_token", "handoff", "completed", "reply",
)

#: Phases every answered-with-tokens request must carry (``staged`` /
#: ``picked`` join when tenancy staged it; ``handoff`` when the decode
#: plane finished it — episode-level knowledge the validator takes as
#: arguments, not per-trace guesses).
REQUIRED_PHASES = (
    "arrival", "admitted", "prefill", "first_token", "completed", "reply",
)

#: Attribution buckets of :func:`phase_durations` /
#: :meth:`LifecycleRegistry.attribute_slo` — where an over-SLO
#: request's budget can go.  ``transfer`` is the scheduled-collective
#: bucket: paired ``transfer``/``transfer_done`` stamps from the
#: ``comms/`` scheduler (and the evacuation/handoff seams), summed —
#: so ``attribute_slo`` can name a transfer-bound request.
DURATION_PHASES = ("queue", "prefill", "handoff", "decode", "settle",
                   "transfer")

#: Per-trace token-time bound: generate budgets are engine-bounded, but
#: a registry must stay bounded against any caller.
MAX_TOKEN_TIMES = 8192


def request_key(message: Any) -> str | None:
    """The trace key for a queue message: its stable ``MessageId``
    (redeliveries keep it — the same identity the reply registry
    dedups on), falling back to the receipt handle.  ``None`` (no
    message context, e.g. bare-batcher submits) means "don't trace"."""
    if not isinstance(message, dict):
        return None
    rid = message.get("MessageId") or message.get("ReceiptHandle")
    return rid if isinstance(rid, str) and rid else None


@dataclass
class RequestTrace:
    """One request's phase chain (host bookkeeping only)."""

    rid: str
    flow_id: int
    tenant: str = ""
    #: ``(phase, t)`` in stamp order — epoch seconds on the registry's
    #: clock (virtual under a FakeClock; ``SentTimestamp``-backdated
    #: arrivals share the base by construction)
    stamps: list = field(default_factory=list)
    #: every token advance's host-settle time (first token included)
    token_times: list = field(default_factory=list)
    #: failover / audit notes: name -> count
    notes: dict = field(default_factory=dict)
    #: per-transfer route hop lists (one entry per routed ``transfer``
    #: stamp, in stamp order — the comms route planner appends them so
    #: Perfetto transfer spans can carry their hops)
    routes: list = field(default_factory=list)
    #: error replies (TTL shed, malformed, overload shed) carry the
    #: error string; a full-result reply leaves it None
    error: str | None = None

    def first(self, phase: str) -> float | None:
        for name, t in self.stamps:
            if name == phase:
                return t
        return None

    def last(self, phase: str) -> float | None:
        found = None
        for name, t in self.stamps:
            if name == phase:
                found = t
        return found

    def count(self, phase: str) -> int:
        return sum(1 for name, _ in self.stamps if name == phase)

    @property
    def phases(self) -> set:
        return {name for name, _ in self.stamps}

    def total_s(self) -> float | None:
        """Arrival → reply wall seconds (None while open)."""
        arrival = self.first("arrival")
        reply = self.last("reply")
        if arrival is None or reply is None:
            return None
        return max(0.0, reply - arrival)

    def inter_token_s(self) -> list[float]:
        """Consecutive token-settle gaps (decode cadence as the
        consumer experiences it).  Gang-settled tokens share a settle
        instant, so zeros are legitimate samples, not noise."""
        times = self.token_times
        return [
            max(0.0, b - a) for a, b in zip(times, times[1:])
        ]

    def tpot_s(self) -> float | None:
        """Time per output token after the first (None under 2 tokens)."""
        times = self.token_times
        if len(times) < 2:
            return None
        return max(0.0, times[-1] - times[0]) / (len(times) - 1)

    def to_dict(self) -> dict:
        out = {
            "rid": self.rid,
            "flow_id": self.flow_id,
            "tenant": self.tenant,
            "stamps": [[name, t] for name, t in self.stamps],
            "token_times": list(self.token_times),
            "notes": dict(self.notes),
            "error": self.error,
        }
        if self.routes:
            out["routes"] = [list(hops) for hops in self.routes]
        return out

    @classmethod
    def from_dict(cls, state: dict) -> "RequestTrace":
        trace = cls(
            rid=str(state.get("rid", "")),
            flow_id=int(state.get("flow_id", 0) or 0),
            tenant=str(state.get("tenant", "") or ""),
            error=state.get("error"),
        )
        for entry in state.get("stamps") or ():
            try:
                name, t = entry[0], float(entry[1])
            except (TypeError, ValueError, IndexError):
                continue
            trace.stamps.append((str(name), t))
        for t in state.get("token_times") or ():
            try:
                trace.token_times.append(float(t))
            except (TypeError, ValueError):
                continue
        notes = state.get("notes")
        if isinstance(notes, dict):
            trace.notes = {str(k): int(v) for k, v in notes.items()}
        for hops in state.get("routes") or ():
            if isinstance(hops, (list, tuple)):
                trace.routes.append(list(hops))
        return trace


def transfer_spans(trace: RequestTrace) -> list[tuple[float, float]]:
    """Paired ``(start, done)`` windows of scheduled collective
    transfers on the trace: each ``transfer`` stamp opens a window the
    next ``transfer_done`` closes (FIFO — coalesced ops stamped at one
    flush all close at their own settle).  An unmatched open stamp
    (the op never finished — e.g. a kill mid-flight) contributes no
    window."""
    spans: list[tuple[float, float]] = []
    open_starts: list[float] = []
    for name, t in trace.stamps:
        if name == "transfer":
            open_starts.append(t)
        elif name == "transfer_done" and open_starts:
            spans.append((open_starts.pop(0), t))
    return spans


def phase_durations(trace: RequestTrace) -> dict[str, float]:
    """The trace decomposed into :data:`DURATION_PHASES` seconds.

    - ``queue``   — arrival → admitted (staging wait included: the
      queue/staging wait is one budget from the consumer's seat)
    - ``prefill`` — admitted → first token (insert dispatch + any
      prefill-plane backpressure)
    - ``handoff`` — first token → KV landed in a decode slot (decode
      free-slot wait + the transfer; absent on fused serving)
    - ``decode``  — handoff (or first token) → final token settled
    - ``settle``  — final token → reply sent
    - ``transfer`` — total seconds inside scheduled-collective windows
      (:func:`transfer_spans`); transfers overlap the phases above by
      design, so this bucket is a parallel attribution axis, not a
      sixth slice of the arrival→reply wall
    """
    out: dict[str, float] = {}
    arrival = trace.first("arrival")
    admitted = trace.first("admitted")
    first_tok = trace.first("first_token")
    handoff = trace.first("handoff")
    completed = trace.last("completed")
    reply = trace.last("reply")
    if arrival is not None and admitted is not None:
        out["queue"] = max(0.0, admitted - arrival)
    if admitted is not None and first_tok is not None:
        out["prefill"] = max(0.0, first_tok - admitted)
    if handoff is not None and first_tok is not None:
        out["handoff"] = max(0.0, handoff - first_tok)
    decode_base = handoff if handoff is not None else first_tok
    if completed is not None and decode_base is not None:
        out["decode"] = max(0.0, completed - decode_base)
    if reply is not None and completed is not None:
        out["settle"] = max(0.0, reply - completed)
    windows = transfer_spans(trace)
    if windows:
        out["transfer"] = sum(max(0.0, b - a) for a, b in windows)
    return out


def validate_chain(
    trace: RequestTrace,
    *,
    require_staged: bool = False,
    require_handoff: bool = False,
) -> list[str]:
    """Problems with the trace's phase chain ([] = gap-free monotone).

    The completeness bar for an ANSWERED request: exactly one ``reply``
    stamp (the exactly-once audit — a duplicate that also replied would
    show two), every required phase present (``staged``/``picked`` when
    the episode staged it, ``handoff`` when the decode plane finished
    it), and first-occurrence times non-decreasing along
    :data:`PHASE_ORDER`.  Error replies (sheds) are answered too but
    never decoded: they need only arrival → reply."""
    problems: list[str] = []
    replies = trace.count("reply")
    if replies != 1:
        problems.append(f"expected exactly one reply stamp, saw {replies}")
    if trace.error is not None:
        required: tuple = ("arrival", "reply")
    else:
        required = REQUIRED_PHASES
        if require_staged:
            required = required + ("staged", "picked")
        if require_handoff:
            required = required + ("handoff",)
    present = trace.phases
    for phase in required:
        if phase not in present:
            problems.append(f"missing {phase} stamp")
    chain = [
        (phase, trace.first(phase))
        for phase in PHASE_ORDER
        if phase in present
    ]
    for (a, ta), (b, tb) in zip(chain, chain[1:]):
        if tb < ta:  # type: ignore[operator]
            problems.append(
                f"non-monotone chain: {b}@{tb:.6f} before {a}@{ta:.6f}"
            )
    if trace.error is None and "completed" in present:
        reply = trace.last("reply")
        completed = trace.last("completed")
        if reply is not None and completed is not None \
                and reply < completed:
            problems.append("reply stamped before the last completion")
    return problems


class LifecycleRegistry:
    """Bounded host-side registry of request traces (see module doc).

    ``now_fn`` is the EPOCH clock the serving worker already uses for
    arrival/TTL bookkeeping (``time.time`` in production, a FakeClock
    in simulated episodes) — one coherent time base with ``SentTimestamp``
    arrivals, so virtual-time episodes produce exact chains.

    ``journal`` (optional, a :class:`~.journal.TickJournal`) persists
    each closed trace as a ``kind="request"`` sidecar event line —
    rotation/torn-tail tolerant like every journal line.

    Thread model: the serving loop writes; HTTP handler threads read
    via :meth:`snapshot`.  Structure mutations take the lock; stamp
    appends on an existing trace are GIL-atomic list appends.
    """

    #: per-tenant Prometheus series bound (mirrors
    #: ``workloads.service.MAX_TENANT_SERIES`` — kept literal here so
    #: ``obs`` stays importable without the workloads package)
    MAX_TENANT_SERIES = 512
    OTHER_TENANTS = "~other"

    def __init__(
        self,
        *,
        capacity: int = 4096,
        now_fn: Callable[[], float] | None = None,
        journal: Any = None,
        keep_done: int | None = None,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.now_fn = now_fn or time.time
        self.journal = journal
        self._lock = threading.Lock()
        self._open: "OrderedDict[str, RequestTrace]" = OrderedDict()
        self._done: deque = deque(maxlen=keep_done or capacity)
        #: restart generation: flow ids are ``(epoch << 32) | seq``, and
        #: import_state sets ``epoch = saved + 1`` — ids minted after a
        #: restart can never collide with restored (or lost) ones
        self.epoch = 0
        self._seq = 0
        self.created = 0
        self.replies = 0
        self.duplicates = 0
        self.evicted = 0
        # drained into WorkloadMetrics histograms by export_metrics
        # (bounded: an unattached registry must not grow)
        self._pending_phase_obs: deque = deque(maxlen=16384)
        self._pending_tenant_obs: deque = deque(maxlen=16384)
        self._tenant_labels: dict[str, bool] = {}

    # -- trace creation / lookup ----------------------------------------

    def _next_flow_id(self) -> int:
        self._seq += 1
        return (self.epoch << 32) | (self._seq & 0xFFFFFFFF)

    def _trace(self, rid: str, tenant: str | None = None) -> RequestTrace:
        trace = self._open.get(rid)
        if trace is None:
            with self._lock:
                trace = self._open.get(rid)
                if trace is None:
                    trace = RequestTrace(
                        rid=rid, flow_id=self._next_flow_id()
                    )
                    self._open[rid] = trace
                    self.created += 1
                    while len(self._open) > self.capacity:
                        _, dropped = self._open.popitem(last=False)
                        self.evicted += 1
                        dropped.notes["evicted"] = (
                            dropped.notes.get("evicted", 0) + 1
                        )
                        self._done.append(dropped)
        if tenant:
            trace.tenant = tenant
        return trace

    # -- producers (all no-ops for rid None) ----------------------------

    def stamp(
        self,
        rid: str | None,
        phase: str,
        *,
        t: float | None = None,
        tenant: str | None = None,
        once: bool = False,
    ) -> None:
        """Append one phase stamp at ``t`` (default: now).  ``once``
        makes re-stamps no-ops — arrival uses it so a redelivered copy
        of a still-open request keeps its original arrival."""
        if rid is None:
            return
        trace = self._trace(rid, tenant)
        if once and phase in trace.phases:
            return
        trace.stamps.append((phase, self.now_fn() if t is None else t))

    def arrival(
        self,
        rid: str | None,
        *,
        sent: float | None = None,
        tenant: str | None = None,
    ) -> None:
        """Stamp queue arrival, backdated to the queue's
        ``SentTimestamp`` when it stamps (``sent``), else admission
        time.  Idempotent per open trace."""
        self.stamp(rid, "arrival", t=sent, tenant=tenant, once=True)

    def token(self, rid: str | None, *, t: float | None = None) -> None:
        """Record one token advance (the engine's ``_emit`` funnel)."""
        if rid is None:
            return
        trace = self._open.get(rid)
        if trace is None:
            trace = self._trace(rid)
        if len(trace.token_times) < MAX_TOKEN_TIMES:
            trace.token_times.append(
                self.now_fn() if t is None else t
            )

    def note(self, rid: str | None, name: str) -> None:
        """Count a failover/audit event on the trace (``redispatched``,
        ``resumed``, ``handed_off``, ``duplicate``...)."""
        if rid is None:
            return
        trace = self._trace(rid)
        trace.notes[name] = trace.notes.get(name, 0) + 1

    #: per-trace route-record bound (a trace must stay bounded against
    #: any routed-transfer producer)
    MAX_ROUTES = 64

    def route(self, rid: str | None, hops: list) -> None:
        """Record the hop lists the comms route planner assigned to
        this trace's next ``transfer`` span (appended in stamp order —
        :func:`~.trace.request_trace_events` zips them onto the paired
        transfer windows)."""
        if rid is None:
            return
        trace = self._trace(rid)
        if len(trace.routes) < self.MAX_ROUTES:
            trace.routes.append([list(h) for h in hops])

    def settle(
        self, rid: str | None, *, error: str | None = None
    ) -> None:
        """Stamp ``reply`` and close the trace — called ONLY on the
        path that actually answered (sent the reply / deleted the
        input).  The dedup path calls :meth:`duplicate` instead, so a
        second reply stamp on one rid is impossible by construction and
        its absence is what the completeness gate audits."""
        if rid is None:
            return
        trace = self._trace(rid)
        trace.stamps.append(("reply", self.now_fn()))
        trace.error = error
        with self._lock:
            self._open.pop(rid, None)
            self._done.append(trace)
            self.replies += 1
        if error is None:
            self._observe(trace)
        if self.journal is not None:
            try:
                self.journal.append_event("request", trace.to_dict())
            except Exception:  # journal loss must never fail a settle
                pass

    def duplicate(self, rid: str | None) -> None:
        """Close (without a reply stamp) the open trace of a consumed
        duplicate copy — the redelivered/re-dispatched input of a
        request some earlier settle already answered."""
        if rid is None:
            return
        with self._lock:
            trace = self._open.pop(rid, None)
            self.duplicates += 1
        if trace is not None:
            trace.notes["duplicate"] = trace.notes.get("duplicate", 0) + 1
            with self._lock:
                self._done.append(trace)

    # -- metrics (drained on the worker's gauge-refresh cadence) --------

    def _bounded_tenant(self, tenant: str) -> str:
        if tenant in self._tenant_labels:
            return tenant
        if len(self._tenant_labels) >= self.MAX_TENANT_SERIES:
            return self.OTHER_TENANTS
        self._tenant_labels[tenant] = True
        return tenant

    def _observe(self, trace: RequestTrace) -> None:
        for phase, seconds in phase_durations(trace).items():
            self._pending_phase_obs.append((phase, seconds))
        # per-tenant TTFT histograms stay with the engine (its
        # _pending_ttft_obs drain — they must exist with tracing off);
        # the registry owns what only a full trace can measure: the
        # per-token cadence past the first token
        tenant = self._bounded_tenant(trace.tenant) if trace.tenant else ""
        if tenant:
            for gap in trace.inter_token_s():
                self._pending_tenant_obs.append(("itl", tenant, gap))
            tpot = trace.tpot_s()
            if tpot is not None:
                self._pending_tenant_obs.append(("tpot", tenant, tpot))

    def export_metrics(self, metrics: Any) -> None:
        """Drain pending observations into a
        :class:`~.prometheus.WorkloadMetrics` registry as cumulative
        histograms (``request_phase_seconds{phase=...}`` and the
        per-tenant TTFT/ITL/TPOT families)."""
        if metrics is None:
            return
        while self._pending_phase_obs:
            phase, seconds = self._pending_phase_obs.popleft()
            metrics.observe_histogram(
                "request_phase_seconds", seconds,
                "Per-request wall seconds spent in each lifecycle "
                "phase (queue wait, prefill, KV-handoff stall, decode, "
                "reply settle) — the critical-path decomposition "
                "behind attribute_slo().",
                labels=(("phase", phase),),
            )
        families = {
            "itl": (
                "tenant_inter_token_seconds",
                "Gap between consecutive token settles, per tenant — "
                "the per-token SLO measurement layer (gang-settled "
                "tokens legitimately share an instant).",
            ),
            "tpot": (
                "tenant_time_per_output_token_seconds",
                "Mean seconds per output token after the first, per "
                "request, per tenant.",
            ),
        }
        while self._pending_tenant_obs:
            kind, tenant, seconds = self._pending_tenant_obs.popleft()
            name, help_text = families[kind]
            metrics.observe_histogram(
                name, seconds, help_text, labels=(("tenant", tenant),),
            )

    # -- introspection ---------------------------------------------------

    @property
    def open_count(self) -> int:
        return len(self._open)

    def open_traces(self) -> list[RequestTrace]:
        with self._lock:
            return list(self._open.values())

    def done_traces(self, last: int | None = None) -> list[RequestTrace]:
        with self._lock:
            done = list(self._done)
        return done if last is None else done[-last:]

    def traces_of(self, rid: str) -> list[RequestTrace]:
        """Every closed trace of ``rid`` (a redelivered duplicate makes
        a second one) plus the open trace if any — the audit surface."""
        with self._lock:
            out = [t for t in self._done if t.rid == rid]
            if rid in self._open:
                out.append(self._open[rid])
        return out

    def snapshot(self, last: int = 100) -> dict:
        """The ``/debug/requests`` body: counters + the most recent
        closed traces (+ open ones, newest last)."""
        with self._lock:
            done = list(self._done)[-max(0, last):]
            open_traces = list(self._open.values())[-max(0, last):]
        return {
            "epoch": self.epoch,
            "open": self.open_count,
            "created": self.created,
            "replies": self.replies,
            "duplicates": self.duplicates,
            "evicted": self.evicted,
            "requests": [t.to_dict() for t in done],
            "open_requests": [t.to_dict() for t in open_traces],
        }

    def attribute_slo(
        self,
        slo_s: float,
        traces: Iterable[RequestTrace] | None = None,
        *,
        worst: int = 5,
    ) -> dict:
        """The critical-path analyzer: for every answered-with-tokens
        request over ``slo_s`` total (arrival → reply), which phase ate
        the budget.  Returns per-phase over-SLO counts, the dominant
        phase overall, and the ``worst`` offenders with their full
        decompositions — "the p99 is queue wait" vs "the decode plane
        is contended" from one artifact."""
        if traces is None:
            traces = [
                t for t in self.done_traces()
                if t.error is None and "reply" in t.phases
            ]
        by_phase: dict[str, int] = {}
        offenders: list[dict] = []
        scored = 0
        for trace in traces:
            total = trace.total_s()
            if total is None:
                continue
            scored += 1
            if total <= slo_s:
                continue
            durations = phase_durations(trace)
            if not durations:
                continue
            dominant = max(durations, key=lambda k: durations[k])
            by_phase[dominant] = by_phase.get(dominant, 0) + 1
            offenders.append({
                "rid": trace.rid,
                "tenant": trace.tenant,
                "total_s": total,
                "dominant": dominant,
                "durations_s": durations,
            })
        offenders.sort(key=lambda o: -o["total_s"])
        return {
            "slo_s": slo_s,
            "requests": scored,
            "over_slo": sum(by_phase.values()),
            "by_phase": dict(sorted(by_phase.items())),
            "dominant": (
                max(by_phase, key=lambda k: by_phase[k])
                if by_phase else None
            ),
            "worst": offenders[:worst],
        }

    # -- durable-state surface (core/durable.py StateProvider) -----------
    #
    # Open traces are the state a restart must not lose: their requests
    # are still in flight (queue redelivery will re-drive them), and a
    # cold registry would re-open them with fresh flow ids AND lose the
    # pre-crash half of their chains — the exact gap the completeness
    # audit exists to catch.  Closed traces ride along (bounded) for
    # postmortem continuity; counters ride so the audit numbers survive.

    def export_state(self) -> dict:
        with self._lock:
            open_traces = [t.to_dict() for t in self._open.values()]
            done = [t.to_dict() for t in list(self._done)[-256:]]
        return {
            "records": len(open_traces) + len(done),
            "epoch": self.epoch,
            "seq": self._seq,
            "created": self.created,
            "replies": self.replies,
            "duplicates": self.duplicates,
            "evicted": self.evicted,
            "open": open_traces,
            "done": done,
        }

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: float | None = None, max_age_s: float = 0.0,
    ) -> int:
        def _shift(trace: RequestTrace) -> RequestTrace:
            if rebase:
                trace.stamps = [(n, t + rebase) for n, t in trace.stamps]
                trace.token_times = [
                    t + rebase for t in trace.token_times
                ]
            return trace

        recovered = 0
        with self._lock:
            # the NEXT life's ids start one epoch past the saved one:
            # flow ids never collide across restart episodes even when
            # the snapshot missed this registry's newest traces
            self.epoch = int(state.get("epoch", 0) or 0) + 1
            self._seq = 0
            self.created = int(state.get("created", 0) or 0)
            self.replies = int(state.get("replies", 0) or 0)
            self.duplicates = int(state.get("duplicates", 0) or 0)
            self.evicted = int(state.get("evicted", 0) or 0)
            for entry in state.get("done") or ():
                if isinstance(entry, dict):
                    self._done.append(_shift(RequestTrace.from_dict(entry)))
                    recovered += 1
            cutoff = None
            if max_age_s > 0 and now is not None:
                cutoff = now - max_age_s
            for entry in state.get("open") or ():
                if not isinstance(entry, dict):
                    continue
                trace = _shift(RequestTrace.from_dict(entry))
                if not trace.rid:
                    continue
                if cutoff is not None and trace.stamps and max(
                    t for _, t in trace.stamps
                ) < cutoff:
                    self.evicted += 1
                    continue
                trace.notes["restored"] = trace.notes.get("restored", 0) + 1
                self._open[trace.rid] = trace
                recovered += 1
        return recovered
