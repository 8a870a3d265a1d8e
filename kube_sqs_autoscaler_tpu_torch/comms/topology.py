"""Topology — the device fleet as a link graph.

The scheduler gave every byte move a typed :class:`~.ops.TransferOp` and a
scheduler that picks WHEN it dispatches; this module supplies the
other half of ROADMAP item 2: WHICH ROUTE.  A :class:`Topology` is a
directed graph of :class:`Link` edges with modeled bandwidth (B/s) and
latency (s), over which :mod:`.routing` plans concrete multi-hop
routes and charges a per-link virtual-time ledger.

Node naming matches the destinations the producers already emit:
``shard:N`` for the gang's engine shards, ``host`` for host staging,
and anything else (``prefill``, ``decode-plane``, ``device``) joins
lazily via :meth:`Topology.ensure_node` with host-grade links, so
planning never crashes on an endpoint the constructor didn't anticipate.

Builders model the three shapes the serving stack actually runs on:

- :func:`ring_topology` — bidirectional ICI ring (1D torus);
- :func:`mesh2d_topology` — 2D mesh, optionally wrapped into a torus
  (the TPU-pod shape SCCL's synthesized schedules target);
- :func:`two_tier_topology` — ICI islands bridged over DCN through
  host staging (BLITZSCALE's multicast-chain setting).

The host attaches through a small set of GATEWAY shards, not to every
shard: evacuations and handoffs must cross the fabric to reach
staging, which is what makes routing (and the contended-link ledger)
mean something.  Link constants are modeling constants for the
virtual-time cost model, not measurements — only RATIOS of modeled
times are compared, never wall seconds.

:func:`topology_from_geometry` derives the graph from the live
``--shards`` / ``--model-parallel`` geometry, with the ``--topology``
CLI flag picking the shape.
"""

from __future__ import annotations

from dataclasses import dataclass

#: Shapes ``topology_from_geometry`` / the ``--topology`` flag accept.
TOPOLOGY_KINDS = ("ring", "mesh2d", "torus", "two-tier")

#: Modeled link grades (bandwidth B/s, latency s): intra-island ICI,
#: cross-island DCN, and the host staging hop (DMA over PCIe-class).
#: These are the reference's modeled TPU link costs, kept unchanged so
#: that routes equal the reference's; they are constants of the cost
#: model, never measurements of the card the port runs on.
ICI_BANDWIDTH = 100e9
ICI_LATENCY = 1e-6
DCN_BANDWIDTH = 10e9
DCN_LATENCY = 10e-6
HOST_BANDWIDTH = 16e9
HOST_LATENCY = 5e-6


@dataclass(frozen=True)
class Link:
    """One directed edge: ``src -> dst`` at a bandwidth/latency grade."""

    src: str
    dst: str
    bandwidth: float
    latency: float

    @property
    def name(self) -> str:
        return f"{self.src}->{self.dst}"

    def transfer_s(self, nbytes: int) -> float:
        """Modeled seconds to push ``nbytes`` across this link."""
        return self.latency + (nbytes / self.bandwidth if nbytes else 0.0)


class Topology:
    """A directed link graph with shortest/disjoint path queries."""

    def __init__(self, kind: str = "custom") -> None:
        self.kind = kind
        self._links: dict[tuple[str, str], Link] = {}
        self._out: dict[str, list[Link]] = {}

    # -- construction ----------------------------------------------------

    def add_node(self, node: str) -> None:
        self._out.setdefault(node, [])

    def add_link(
        self,
        src: str,
        dst: str,
        *,
        bandwidth: float,
        latency: float,
        bidirectional: bool = True,
    ) -> None:
        """Add ``src -> dst`` (and the reverse unless told otherwise).
        Re-adding an existing edge overwrites its grade."""
        if src == dst:
            raise ValueError(f"self-link on {src!r}")
        for a, b in ((src, dst), (dst, src)) if bidirectional \
                else ((src, dst),):
            link = Link(a, b, float(bandwidth), float(latency))
            old = self._links.get((a, b))
            self._links[(a, b)] = link
            self.add_node(a)
            self.add_node(b)
            if old is not None:
                self._out[a] = [
                    l for l in self._out[a] if l.dst != b
                ]
            self._out[a].append(link)

    def ensure_node(self, node: str) -> None:
        """Lazily admit an endpoint the constructor didn't model: wire it
        to ``host`` at host grade so every route query has an answer."""
        if node in self._out and self._out[node]:
            return
        if node == "host":
            self.add_node(node)
            return
        self.add_node("host")
        self.add_link(
            node, "host",
            bandwidth=HOST_BANDWIDTH, latency=HOST_LATENCY,
        )

    # -- queries ---------------------------------------------------------

    @property
    def nodes(self) -> list[str]:
        return sorted(self._out)

    @property
    def links(self) -> list[Link]:
        return [self._links[key] for key in sorted(self._links)]

    def link(self, src: str, dst: str) -> Link | None:
        return self._links.get((src, dst))

    def out_links(self, node: str) -> list[Link]:
        return list(self._out.get(node, ()))

    def shortest_path(
        self,
        src: str,
        dst: str,
        *,
        nbytes: int = 0,
        blocked: frozenset | set | None = None,
    ) -> list[Link] | None:
        """Dijkstra over modeled per-link cost ``latency +
        nbytes/bandwidth`` (pure latency for ``nbytes=0`` — the
        small-op metric).  ``blocked`` excludes edges by ``(src, dst)``
        key (the disjoint-path residual).  None when unreachable;
        ``[]`` when ``src == dst``."""
        self.ensure_node(src)
        self.ensure_node(dst)
        if src == dst:
            return []
        import heapq

        blocked = blocked or frozenset()
        dist: dict[str, float] = {src: 0.0}
        back: dict[str, Link] = {}
        heap: list[tuple[float, str]] = [(0.0, src)]
        seen: set[str] = set()
        while heap:
            cost, node = heapq.heappop(heap)
            if node in seen:
                continue
            seen.add(node)
            if node == dst:
                break
            for link in self._out.get(node, ()):
                if (link.src, link.dst) in blocked:
                    continue
                next_cost = cost + link.transfer_s(nbytes)
                if next_cost < dist.get(link.dst, float("inf")):
                    dist[link.dst] = next_cost
                    back[link.dst] = link
                    heapq.heappush(heap, (next_cost, link.dst))
        if dst not in back:
            return None
        path: list[Link] = []
        node = dst
        while node != src:
            link = back[node]
            path.append(link)
            node = link.src
        path.reverse()
        return path

    def disjoint_paths(
        self, src: str, dst: str, *, k: int = 4, nbytes: int = 0
    ) -> list[list[Link]]:
        """Up to ``k`` link-disjoint ``src -> dst`` paths, greedily:
        take the cheapest path, remove its edges (both directions — a
        full-duplex link carries one chunk stream per direction but we
        keep the planner conservative), repeat on the residual.  Always
        at least one path when connected."""
        paths: list[list[Link]] = []
        blocked: set[tuple[str, str]] = set()
        for _ in range(max(1, k)):
            path = self.shortest_path(
                src, dst, nbytes=nbytes, blocked=blocked,
            )
            if path is None:
                break
            paths.append(path)
            if not path:  # src == dst
                break
            for link in path:
                blocked.add((link.src, link.dst))
                blocked.add((link.dst, link.src))
        return paths

    def snapshot(self) -> dict:
        """The ``/debug/topology`` graph body."""
        return {
            "kind": self.kind,
            "nodes": self.nodes,
            "links": [
                {
                    "src": link.src,
                    "dst": link.dst,
                    "bandwidth_bps": link.bandwidth,
                    "latency_s": link.latency,
                }
                for link in self.links
            ],
        }


def _default_gateways(n: int) -> tuple[int, ...]:
    """Which shards carry a host-staging link: one on tiny fleets, two
    on opposite sides of larger ones (disjoint entries into staging —
    what lets a big evacuation chunk across both)."""
    return (0,) if n < 4 else (0, n // 2)


def _attach_host(
    topo: Topology, gateways: tuple[int, ...]
) -> None:
    topo.add_node("host")
    for g in gateways:
        topo.add_link(
            f"shard:{g}", "host",
            bandwidth=HOST_BANDWIDTH, latency=HOST_LATENCY,
        )


def ring_topology(
    n: int, *, gateways: tuple[int, ...] | None = None
) -> Topology:
    """``n`` shards on a bidirectional ICI ring, host-staged through
    ``gateways`` (default :func:`_default_gateways`)."""
    if n < 1:
        raise ValueError("ring needs at least one shard")
    topo = Topology("ring")
    for i in range(n):
        topo.add_node(f"shard:{i}")
    if n > 1:
        for i in range(n):
            topo.add_link(
                f"shard:{i}", f"shard:{(i + 1) % n}",
                bandwidth=ICI_BANDWIDTH, latency=ICI_LATENCY,
            )
    _attach_host(topo, gateways or _default_gateways(n))
    return topo


def mesh2d_topology(
    rows: int,
    cols: int,
    *,
    torus: bool = False,
    gateways: tuple[int, ...] | None = None,
) -> Topology:
    """``rows x cols`` shards on a 2D ICI mesh (``torus=True`` wraps
    both axes), host-staged through ``gateways``.  Shard ``r*cols + c``
    sits at ``(r, c)``."""
    if rows < 1 or cols < 1:
        raise ValueError("mesh needs positive extents")
    topo = Topology("torus" if torus else "mesh2d")
    n = rows * cols

    def shard(r: int, c: int) -> str:
        return f"shard:{(r % rows) * cols + (c % cols)}"

    for i in range(n):
        topo.add_node(f"shard:{i}")
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols or (torus and cols > 2):
                topo.add_link(
                    shard(r, c), shard(r, c + 1),
                    bandwidth=ICI_BANDWIDTH, latency=ICI_LATENCY,
                )
            if r + 1 < rows or (torus and rows > 2):
                topo.add_link(
                    shard(r, c), shard(r + 1, c),
                    bandwidth=ICI_BANDWIDTH, latency=ICI_LATENCY,
                )
    _attach_host(topo, gateways or _default_gateways(n))
    return topo


def two_tier_topology(
    islands: int,
    per_island: int,
    *,
    gateways_per_island: int = 1,
) -> Topology:
    """``islands`` ICI rings of ``per_island`` shards each, bridged
    over DCN through host staging: every island's first
    ``gateways_per_island`` shards link to ``host`` at DCN grade, so
    cross-island traffic is island-ICI -> DCN -> host -> DCN ->
    island-ICI.  Shard ``i*per_island + j`` is island ``i``'s ``j``-th
    chip."""
    if islands < 1 or per_island < 1:
        raise ValueError("two-tier needs positive extents")
    topo = Topology("two-tier")
    topo.add_node("host")
    for i in range(islands):
        base = i * per_island
        for j in range(per_island):
            topo.add_node(f"shard:{base + j}")
        if per_island > 1:
            for j in range(per_island):
                topo.add_link(
                    f"shard:{base + j}",
                    f"shard:{base + (j + 1) % per_island}",
                    bandwidth=ICI_BANDWIDTH, latency=ICI_LATENCY,
                )
        for j in range(max(1, min(gateways_per_island, per_island))):
            topo.add_link(
                f"shard:{base + j}", "host",
                bandwidth=DCN_BANDWIDTH, latency=DCN_LATENCY,
            )
    return topo


def _near_square(n: int) -> tuple[int, int]:
    """Factor ``n`` as ``rows x cols`` with the axes as close as they
    get (falls back to ``1 x n`` for primes)."""
    best = (1, n)
    r = 1
    while r * r <= n:
        if n % r == 0:
            best = (r, n // r)
        r += 1
    return best


def topology_from_geometry(
    kind: str,
    *,
    shards: int,
    model_parallel: int = 1,
) -> Topology:
    """The graph of the live serving geometry: ``shards`` engine
    shards (the routable endpoints), shaped per ``kind``.

    - ``ring``   — one ICI ring over the shards;
    - ``mesh2d`` / ``torus`` — shards factored near-square into a 2D
      mesh (wrapped for ``torus``);
    - ``two-tier`` — each shard is an island of ``model_parallel``
      chips... except the routable unit here is the SHARD, so islands
      group shards: ``model_parallel`` shards per ICI island, bridged
      over DCN (one island total when ``shards <= model_parallel``).
    """
    if kind not in TOPOLOGY_KINDS:
        raise ValueError(
            f"unknown topology {kind!r} (choose from {TOPOLOGY_KINDS})"
        )
    shards = max(1, int(shards))
    model_parallel = max(1, int(model_parallel))
    if kind == "ring":
        return ring_topology(shards)
    if kind in ("mesh2d", "torus"):
        rows, cols = _near_square(shards)
        return mesh2d_topology(rows, cols, torus=(kind == "torus"))
    per_island = min(model_parallel, shards)
    islands = max(1, (shards + per_island - 1) // per_island)
    return two_tier_topology(islands, per_island)
