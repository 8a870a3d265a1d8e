"""Route planning and the per-link virtual-time ledger.

Given a :class:`~.topology.Topology`, :class:`RoutePlanner` turns
every transfer into a concrete multi-hop route:

- SMALL ops (at or under the coalescing threshold) take the
  latency-minimal path — the same regime split the NCCL analysis
  motivates for protocol choice;
- LARGE ops are CHUNKED across up to ``max_paths`` link-disjoint
  paths, bytes split proportional to each path's bottleneck
  bandwidth, and each path's share further cut into
  ``pipeline_bytes`` sub-chunks so multi-hop store-and-forward
  pipelines instead of paying ``hops x full-payload`` (the SCCL-style
  bandwidth-optimal shape for the big evacuation/handoff KV moves).

:class:`LinkLedger` is the contention model: per-link ``busy_until``
virtual time, advanced store-and-forward as chunks reserve hops.  A
link serves one chunk at a time — two transfers sharing a link
serialize ON THE LEDGER, disjoint routes proceed in parallel — and
every reservation is recorded so the property test can audit that no
schedule ever oversubscribes a link (:func:`assert_no_oversubscription`).

:func:`simulate_schedule` replays a batch of ops through the model
twice-comparable ways: ``routed=True`` (chunked disjoint paths,
greedy earliest-first-link dispatch order) versus ``routed=False``
(the WHEN-only baseline: FIFO order, single shortest path, no
chunking); the tests compare their modeled completion times on a
contended torus episode.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

from .ops import SMALL_OP_BYTES
from .topology import Link, Topology

#: Pipelining grain for large chunked transfers: each disjoint path's
#: share is cut into sub-chunks of at most this many bytes so a
#: multi-hop path overlaps its hops.
PIPELINE_BYTES = 1 << 20


@dataclass(frozen=True)
class RouteChunk:
    """One pipelined unit: ``nbytes`` pushed along ``path``."""

    path: tuple[Link, ...]
    nbytes: int

    @property
    def hops(self) -> list[str]:
        return [link.name for link in self.path]


@dataclass
class RoutePlan:
    """Every chunk of one op's route (empty for a local move)."""

    src: str
    dst: str
    nbytes: int
    chunks: tuple[RouteChunk, ...] = ()

    @property
    def local(self) -> bool:
        return not self.chunks

    @property
    def paths(self) -> list[list[str]]:
        """Distinct hop lists, in chunk order (the trace/span payload)."""
        seen: list[list[str]] = []
        for chunk in self.chunks:
            hops = chunk.hops
            if hops not in seen:
                seen.append(hops)
        return seen

    def first_link(self) -> str | None:
        return self.chunks[0].path[0].name if self.chunks else None


class RoutePlanner:
    """Assign routes per the size regime (see module doc)."""

    def __init__(
        self,
        topology: Topology,
        *,
        small_bytes: int = SMALL_OP_BYTES,
        max_paths: int = 4,
        pipeline_bytes: int = PIPELINE_BYTES,
    ) -> None:
        self.topology = topology
        self.small_bytes = small_bytes
        self.max_paths = max(1, max_paths)
        self.pipeline_bytes = max(1, pipeline_bytes)
        self._path_cache: dict[tuple, Any] = {}

    def _shortest(self, src: str, dst: str) -> list[Link] | None:
        key = ("s", src, dst)
        if key not in self._path_cache:
            self._path_cache[key] = self.topology.shortest_path(src, dst)
        return self._path_cache[key]

    def _disjoint(
        self, src: str, dst: str, nbytes: int
    ) -> list[list[Link]]:
        key = ("d", src, dst)
        if key not in self._path_cache:
            self._path_cache[key] = self.topology.disjoint_paths(
                src, dst, k=self.max_paths, nbytes=nbytes,
            )
        return self._path_cache[key]

    def plan(self, src: str, dst: str, nbytes: int) -> RoutePlan:
        """The op's route.  ``src == dst`` (or an unreachable pair,
        which :meth:`~.topology.Topology.ensure_node` makes impossible
        on connected graphs) plans as a local no-hop move."""
        nbytes = max(0, int(nbytes))
        if src == dst:
            return RoutePlan(src, dst, nbytes)
        if nbytes <= self.small_bytes:
            path = self._shortest(src, dst)
            if not path:
                return RoutePlan(src, dst, nbytes)
            return RoutePlan(
                src, dst, nbytes,
                (RouteChunk(tuple(path), nbytes),),
            )
        paths = [p for p in self._disjoint(src, dst, nbytes) if p]
        if not paths:
            return RoutePlan(src, dst, nbytes)
        weights = [min(link.bandwidth for link in p) for p in paths]
        total_w = sum(weights)
        shares = [int(nbytes * w / total_w) for w in weights]
        shares[0] += nbytes - sum(shares)
        chunks: list[RouteChunk] = []
        for path, share in zip(paths, shares):
            if share <= 0:
                continue
            remaining = share
            while remaining > 0:
                cut = min(remaining, self.pipeline_bytes)
                chunks.append(RouteChunk(tuple(path), cut))
                remaining -= cut
        return RoutePlan(src, dst, nbytes, tuple(chunks))

    def first_hop(self, src: str, dst: str, nbytes: int) -> str | None:
        """The first link the op will contend on — the first-hop-aware
        coalescing key (None for local moves)."""
        return self.plan(src, dst, nbytes).first_link()


class LinkLedger:
    """Per-link virtual-time occupancy: ``busy_until``, byte and
    busy-second odometers, and a bounded record of reserved intervals
    (the oversubscription audit surface)."""

    def __init__(
        self, topology: Topology, *, max_records: int = 4096
    ) -> None:
        self.topology = topology
        self.max_records = max_records
        self.busy_until: dict[str, float] = {}
        self.link_bytes: dict[str, int] = {}
        self.busy_seconds: dict[str, float] = {}
        #: per-link ``(start, finish)`` reservation intervals, oldest
        #: dropped past ``max_records`` total
        self.records: dict[str, list[tuple[float, float]]] = {}
        self._recorded = 0

    def reserve(
        self, path: Sequence[Link], nbytes: int, t: float
    ) -> tuple[float, float]:
        """Push ``nbytes`` along ``path`` store-and-forward starting no
        earlier than ``t``: each hop starts when the chunk has arrived
        AND the link is free, holds the link for ``latency +
        nbytes/bandwidth``, and hands off to the next hop.  Returns the
        ``(start, finish)`` of the whole traversal."""
        arrival = t
        start0: float | None = None
        for link in path:
            start = max(arrival, self.busy_until.get(link.name, 0.0))
            if start0 is None:
                start0 = start
            finish = start + link.transfer_s(nbytes)
            self.busy_until[link.name] = finish
            self.link_bytes[link.name] = (
                self.link_bytes.get(link.name, 0) + int(nbytes)
            )
            self.busy_seconds[link.name] = (
                self.busy_seconds.get(link.name, 0.0) + (finish - start)
            )
            if self._recorded < self.max_records:
                self.records.setdefault(link.name, []).append(
                    (start, finish)
                )
                self._recorded += 1
            arrival = finish
        if start0 is None:  # empty path: a local move
            return (t, t)
        return (start0, arrival)

    def earliest_start(self, path: Sequence[Link], t: float) -> float:
        """When the first hop of ``path`` could begin, given current
        occupancy (the greedy dispatch-order metric)."""
        if not path:
            return t
        return max(t, self.busy_until.get(path[0].name, 0.0))

    def utilization(self, horizon: float | None = None) -> dict[str, float]:
        """Busy fraction per link over ``horizon`` (default: the
        ledger's own high-water virtual time)."""
        if horizon is None:
            horizon = max(self.busy_until.values(), default=0.0)
        if horizon <= 0.0:
            return {name: 0.0 for name in self.busy_seconds}
        return {
            name: min(1.0, busy / horizon)
            for name, busy in sorted(self.busy_seconds.items())
        }

    def snapshot(self) -> dict:
        """The ``/debug/topology`` ledger body."""
        horizon = max(self.busy_until.values(), default=0.0)
        return {
            "virtual_now": horizon,
            "busy_until": dict(sorted(self.busy_until.items())),
            "link_bytes": dict(sorted(self.link_bytes.items())),
            "utilization": self.utilization(horizon),
        }


def assert_no_oversubscription(ledger: LinkLedger) -> None:
    """Audit every recorded reservation: on each link the intervals
    must be non-overlapping (one chunk at a time — the contention
    contract the scheduler's dispatch order promises).  Raises
    AssertionError naming the first violating link."""
    for name, intervals in ledger.records.items():
        ordered = sorted(intervals)
        for (s0, f0), (s1, f1) in zip(ordered, ordered[1:]):
            eps = 1e-12
            if s1 < f0 - eps:
                raise AssertionError(
                    f"link {name} oversubscribed: "
                    f"[{s0:.9f},{f0:.9f}] overlaps [{s1:.9f},{f1:.9f}]"
                )


@dataclass
class ScheduleResult:
    """One simulated dispatch schedule (see :func:`simulate_schedule`)."""

    ops: list = field(default_factory=list)
    makespan: float = 0.0
    link_utilization: dict = field(default_factory=dict)
    link_bytes: dict = field(default_factory=dict)
    ledger: LinkLedger | None = None

    def to_dict(self) -> dict:
        return {
            "makespan_s": self.makespan,
            "ops": list(self.ops),
            "link_utilization": dict(self.link_utilization),
            "link_bytes": dict(self.link_bytes),
        }


def _op_view(op: Any) -> tuple[str, str, str, int]:
    """(kind, source, destination, nbytes) of a TransferOp or dict."""
    if isinstance(op, dict):
        return (
            str(op.get("kind", "transfer")),
            str(op.get("source", "host")),
            str(op.get("destination", "host")),
            int(op.get("nbytes", 0)),
        )
    return (
        op.kind,
        getattr(op, "source", "host"),
        op.destination,
        int(op.nbytes),
    )


def simulate_schedule(
    ops: Iterable[Any],
    topology: Topology,
    *,
    routed: bool = True,
    small_bytes: int = SMALL_OP_BYTES,
    max_paths: int = 4,
    pipeline_bytes: int = PIPELINE_BYTES,
    start_t: float = 0.0,
) -> ScheduleResult:
    """Model a batch of concurrent transfers on the topology.

    ``routed=True`` is the routed scheduler: every op planned
    (chunked/pipelined disjoint paths for large, latency-minimal for
    small) and dispatched greedily — at each step the op whose first
    link frees earliest goes next, so contention serializes on the
    ledger and disjoint routes run in parallel.  ``routed=False`` is
    the WHEN-only baseline given the same cost model: submission
    (FIFO) order, one shortest path each, no chunking.  Completion =
    ``makespan`` = latest chunk finish minus ``start_t``.
    """
    planner = RoutePlanner(
        topology,
        small_bytes=small_bytes if routed else (1 << 62),
        max_paths=max_paths if routed else 1,
        pipeline_bytes=pipeline_bytes if routed else (1 << 62),
    )
    ledger = LinkLedger(topology)
    entries = []
    for index, op in enumerate(ops):
        kind, src, dst, nbytes = _op_view(op)
        plan = planner.plan(src, dst, nbytes)
        entries.append({
            "index": index, "kind": kind, "src": src, "dst": dst,
            "nbytes": nbytes, "plan": plan,
        })
    order = list(entries)
    scheduled = []
    makespan = 0.0
    while order:
        if routed:
            order.sort(key=lambda e: (
                ledger.earliest_start(
                    e["plan"].chunks[0].path if e["plan"].chunks else (),
                    start_t,
                ),
                e["index"],
            ))
        entry = order.pop(0)
        plan = entry["plan"]
        op_start = None
        op_finish = start_t
        for chunk in plan.chunks:
            s, f = ledger.reserve(chunk.path, chunk.nbytes, start_t)
            op_start = s if op_start is None else min(op_start, s)
            op_finish = max(op_finish, f)
        scheduled.append({
            "kind": entry["kind"],
            "src": entry["src"],
            "dst": entry["dst"],
            "nbytes": entry["nbytes"],
            "start_s": (start_t if op_start is None else op_start)
            - start_t,
            "finish_s": op_finish - start_t,
            "chunks": len(plan.chunks),
            "hops": plan.paths,
        })
        makespan = max(makespan, op_finish - start_t)
    horizon = makespan if makespan > 0 else None
    return ScheduleResult(
        ops=scheduled,
        makespan=makespan,
        link_utilization=ledger.utilization(horizon),
        link_bytes=dict(sorted(ledger.link_bytes.items())),
        ledger=ledger,
    )
