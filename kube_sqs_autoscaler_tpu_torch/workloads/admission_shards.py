"""The sharded admission plane: N crash-tolerant admission shards.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/admission_shards.py``
(without the request-lifecycle stamps), held against it by
``tests/test_torch_admission_shards.py``.  Pure host bookkeeping on the
port's :mod:`.tenancy` classes; it imports no torch.  A lone
:class:`~.tenancy.FairAdmission` pays every refill cycle's serial staging
work for all tenants and is a failure domain of its own; this module
splits it:

- :class:`HashRing`: consistent hashing with virtual nodes (crc32, stable
  across processes) maps tenants to shards; growing N moves about 1/N of
  them, and a sticky home map pins a tenant where it first staged;
- :class:`AdmissionShard`: one slice of the plane, with its own
  :class:`~.tenancy.FairAdmission` over its tenants and, when
  ``shed_tiers`` asks for one, its own :class:`~.tenancy.OverloadLadder`;
- :class:`AdmissionCoordinator`: fairness across shards as DRR credits
  work.  A busy shard earns pick credit in proportion to its staged
  tenants' weight, its debt resets when it goes idle, and it may pick
  past its share only through a rate-bounded borrow bucket, so a flooded
  shard's debt never exceeds ``BORROW_CAP``;
- :class:`ShardedAdmission`: the facade over ``FairAdmission``'s surface
  (``note_cycle``, ``room``, ``stage``, ``pick``, ``over_share``,
  ``drr``, ``depths``, the durable-state pair) that the worker talks to.
  ``admission_shards=1`` never builds this module.

Crash tolerance: :meth:`ShardedAdmission.kill_shard` keeps a tombstone of
the shard's accounting, hands every staged request back to the queue
through the caller's ``handback`` (at-least-once: the queue redelivers,
and the fleet's reply registry dedups), and the next
:meth:`~ShardedAdmission.note_cycle` rehydrates the shard from its
tombstone and the peers' gossip, not cold.  Flood classifications gossip
between connected shards each ladder cycle, and each one that spreads is
journaled once as a ``kind="admission"`` line on a
:class:`~..obs.journal.TickJournal`; a partitioned shard keeps admitting
but neither sends nor receives gossip until healed.
"""

from __future__ import annotations

import bisect
import time
import zlib
from collections import OrderedDict, deque
from typing import Any

from .tenancy import FairAdmission, OverloadLadder, TenancyConfig, _PoolEvent


class HashRing:
    """Consistent tenant-to-shard hashing with ``vnodes`` virtual points a
    shard, on crc32 (Python's ``hash`` is salted per process; a restarted
    plane must route every tenant to the same home)."""

    VNODES = 64

    def __init__(self, shards: int, vnodes: int = VNODES) -> None:
        if shards < 1:
            raise ValueError(f"shards={shards} must be >= 1")
        self.shards = shards
        points = sorted(
            (zlib.crc32(f"admission-shard:{shard}:{v}".encode()), shard)
            for shard in range(shards) for v in range(vnodes)
        )
        self._hashes = [h for h, _ in points]
        self._owners = [s for _, s in points]

    def shard_of(self, tenant: str, alive=None) -> int:
        """The tenant's shard; ``alive`` (a set of shard indices, None =
        all) walks the ring past dead owners, so a killed shard's tenants
        fail over to the next alive point deterministically."""
        h = zlib.crc32(str(tenant).encode())
        start = bisect.bisect_right(self._hashes, h)
        n = len(self._owners)
        for step in range(n):
            owner = self._owners[(start + step) % n]
            if alive is None or owner in alive:
                return owner
        raise ValueError("no alive admission shard to route to")


class AdmissionShard:
    """One slice of the plane: its staging, classifier and optional
    overload ladder, and the liveness flags the chaos seams flip."""

    def __init__(self, index: int, tenancy: TenancyConfig, *,
                 per_tenant_limit: int, total_limit: int) -> None:
        self.index = index
        self.tenancy = tenancy
        self.per_tenant_limit = per_tenant_limit
        self.total_limit = total_limit
        self.fair = self._fresh_fair()
        self.ladder = (OverloadLadder(tenancy.shed_tiers)
                       if tenancy.shed_tiers > 0 else None)
        self.alive = True
        self.partitioned = False
        self.kills = 0
        self.rehydrations = 0
        # records the last rehydration recovered ("rehydrated, not cold")
        self.rehydrated_records = 0
        # the state exported at the kill, consumed at the restart
        self.tombstone: dict | None = None

    def _fresh_fair(self) -> FairAdmission:
        return FairAdmission(self.tenancy,
                             per_tenant_limit=self.per_tenant_limit,
                             total_limit=self.total_limit)


class AdmissionCoordinator:
    """Fairness across admission shards, DRR-style: each pick cycle every
    busy shard earns ``k * weight share`` credit and spends one a pick;
    an idle shard's balance resets (DRR's reset-on-empty).  Capacity the
    entitled shards leave unused goes to shards with demand left, in
    rotating order, each extra grant paid from the shard's borrow bucket
    (refilled ``BORROW_REFILL`` a cycle up to ``BORROW_CAP``) and charged
    as debt, which never exceeds ``BORROW_CAP``."""

    BORROW_REFILL = 1.0
    BORROW_CAP = 4.0

    def __init__(self, shards: int) -> None:
        if shards < 1:
            raise ValueError(f"shards={shards} must be >= 1")
        self.shards = shards
        self._credit = [0.0] * shards
        self._borrow = [self.BORROW_CAP] * shards
        self._cursor = 0
        self.borrows_total = 0

    def debt(self, shard: int) -> float:
        """How far ``shard`` has picked past its earned share in this busy
        period (>= 0, at most ``BORROW_CAP``)."""
        return max(0.0, -self._credit[shard])

    def allocate(self, k: int, demands, weights) -> list[int]:
        """Split ``k`` pick slots across shards given their staged
        ``demands`` and staged-tenant ``weights``; the grants sum to at
        most ``min(k, sum(demands))``."""
        n = self.shards
        grants = [0] * n
        busy = [s for s in range(n) if demands[s] > 0]
        for s in range(n):
            self._borrow[s] = min(self.BORROW_CAP,
                                  self._borrow[s] + self.BORROW_REFILL)
            if demands[s] <= 0:
                # the busy period is over: neither credit nor debt banks
                # across an idle gap
                self._credit[s] = 0.0
        if not busy or k <= 0:
            return grants
        wtotal = sum(max(0.0, weights[s]) for s in busy) or float(len(busy))
        remaining = k
        for s in busy:
            share = (max(0.0, weights[s]) or 1.0) / wtotal
            self._credit[s] += k * share
            # banked credit may exceed this cycle's slice: never grant
            # past what is left of k (the engine's free slots)
            grant = min(demands[s], int(self._credit[s]), remaining)
            if grant > 0:
                grants[s] = grant
                self._credit[s] -= grant
                remaining -= grant
        # work conservation: leftover capacity to shards with demand left,
        # rate-bounded and charged as debt
        leftover = k - sum(grants)
        spin = 0
        while leftover > 0 and spin < 2 * len(busy):
            s = busy[self._cursor % len(busy)]
            self._cursor += 1
            spin += 1
            if demands[s] - grants[s] <= 0 or self._borrow[s] < 1.0:
                continue
            self._borrow[s] -= 1.0
            self._credit[s] = max(-self.BORROW_CAP, self._credit[s] - 1.0)
            grants[s] += 1
            self.borrows_total += 1
            leftover -= 1
            spin = 0
        return grants

    def export_state(self) -> dict:
        return {
            "records": self.shards,
            "credit": list(self._credit),
            "borrow": list(self._borrow),
            "cursor": self._cursor,
            "borrows_total": self.borrows_total,
        }

    def import_state(self, state: dict) -> int:
        recovered = 0
        for name, dest, default in (("credit", self._credit, 0.0),
                                    ("borrow", self._borrow,
                                     self.BORROW_CAP)):
            values = state.get(name)
            if not isinstance(values, (list, tuple)):
                continue
            for s, value in enumerate(values[: self.shards]):
                try:
                    dest[s] = float(value)
                except (TypeError, ValueError):
                    dest[s] = default
                recovered += 1
        self._cursor = int(state.get("cursor", 0) or 0)
        self.borrows_total = int(state.get("borrows_total", 0) or 0)
        return recovered


class _ShardedDrr:
    """The ``.drr`` facade the worker reaches into (push, refund, the
    shed loops' pops): each call goes to the tenant's home shard, so a
    charge lands on the scheduler that staged the request."""

    def __init__(self, plane: "ShardedAdmission") -> None:
        self._plane = plane

    def _drr_of(self, tenant: str):
        return self._plane.shard_of(tenant).fair.drr

    def push(self, tenant: str, item: Any,
             deadline: float | None = None) -> None:
        self._drr_of(tenant).push(tenant, item, deadline=deadline)

    def refund(self, tenant: str, item: Any = None) -> None:
        self._drr_of(tenant).refund(tenant, item)

    def depth(self, tenant: str) -> int:
        return self._drr_of(tenant).depth(tenant)

    def depths(self) -> dict:
        merged: dict[str, int] = {}
        for shard in self._plane.shards:
            for tenant, depth in shard.fair.drr.depths().items():
                merged[tenant] = merged.get(tenant, 0) + depth
        return merged

    def pop_over_deadline(self, now: float,
                          eligible=None) -> tuple[str, Any] | None:
        for shard in self._plane.shards:
            if not shard.alive:
                continue
            popped = shard.fair.drr.pop_over_deadline(now, eligible=eligible)
            if popped is not None:
                return popped
        return None

    def pop_tail(self, tenant: str) -> Any | None:
        return self._drr_of(tenant).pop_tail(tenant)

    @property
    def staged(self) -> int:
        return sum(s.fair.drr.staged for s in self._plane.shards)

    @property
    def urgent_picks(self) -> int:
        return sum(s.fair.drr.urgent_picks for s in self._plane.shards)


class ShardedAdmission:
    """N :class:`AdmissionShard` behind one ``FairAdmission``-shaped
    facade (see the module docstring)."""

    PREMIUM_FLOOD_FACTOR = FairAdmission.PREMIUM_FLOOD_FACTOR
    OVER_SHARE_MIN_RATE = FairAdmission.OVER_SHARE_MIN_RATE
    HOME_LIMIT = 8192

    def __init__(self, tenancy: TenancyConfig, *, per_tenant_limit: int,
                 total_limit: int) -> None:
        n = tenancy.admission_shards
        if n < 2:
            raise ValueError(
                "ShardedAdmission needs admission_shards >= 2; the single "
                "plane is plain FairAdmission"
            )
        if per_tenant_limit < 1 or total_limit < 1:
            raise ValueError("staging limits must be >= 1")
        self.tenancy = tenancy
        self.per_tenant_limit = per_tenant_limit
        # the global staging bound is unchanged by sharding: each shard
        # owns an equal slice (rounded up, so no shard gets 0)
        self.total_limit = total_limit
        per_shard = max(2, -(-total_limit // n))
        self.ring = HashRing(n)
        self.shards = [
            AdmissionShard(i, tenancy, per_tenant_limit=per_tenant_limit,
                           total_limit=per_shard)
            for i in range(n)
        ]
        self.coordinator = AdmissionCoordinator(n)
        self.drr = _ShardedDrr(self)
        # tenant -> shard, pinned at first stage and carried in the
        # durable state (ring changes move only unpinned tenants)
        self._homes: OrderedDict = OrderedDict()
        # incremented by the worker, one series for the whole plane
        self.overflow_total = 0
        self._journal = None
        # classifications already gossiped (journaled once each)
        self._gossiped: set[str] = set()
        # admission-kill / admission-rehydrate instants, shaped for
        # obs.trace.instant_trace_events
        self.events: deque = deque(maxlen=1024)
        self._lifecycle = None

    # -- routing -----------------------------------------------------------

    def _alive(self) -> set:
        return {s.index for s in self.shards if s.alive}

    def shard_of(self, tenant: str) -> AdmissionShard:
        """The tenant's shard: its sticky home while that shard is alive,
        else the ring walked past dead owners (the home re-pins there)."""
        alive = self._alive()
        home = self._homes.get(tenant)
        if home is not None and home in alive:
            self._homes.move_to_end(tenant)
            return self.shards[home]
        owner = self.ring.shard_of(tenant, alive=alive or None)
        self._homes[tenant] = owner
        self._homes.move_to_end(tenant)
        while len(self._homes) > self.HOME_LIMIT:
            self._homes.popitem(last=False)
        return self.shards[owner]

    # -- the FairAdmission surface -----------------------------------------

    @property
    def lifecycle(self):
        return self._lifecycle

    @lifecycle.setter
    def lifecycle(self, registry) -> None:
        """The request-lifecycle registry, wired into every shard's
        staging (a killed shard's fresh staging gets it too)."""
        self._lifecycle = registry
        for shard in self.shards:
            shard.fair.lifecycle = registry

    @property
    def staged(self) -> int:
        return sum(s.fair.staged for s in self.shards)

    @property
    def room(self) -> int:
        """Receive sizing: the alive shards' free staging (a full or dead
        shard's tenants bounce through ``stage() -> False``, the
        hand-back path: backpressure, not loss)."""
        return sum(max(0, s.total_limit - s.fair.staged)
                   for s in self.shards if s.alive)

    @property
    def arrival_rate(self) -> dict:
        """Offered rates merged over the shards (each shard still
        classifies on its own)."""
        merged: dict[str, float] = {}
        for shard in self.shards:
            for tenant, rate in shard.fair.arrival_rate.items():
                merged[tenant] = merged.get(tenant, 0.0) + rate
        return merged

    @property
    def host_ops(self) -> int:
        """Serial host work summed over the shards."""
        return sum(s.fair.host_ops for s in self.shards)

    def host_ops_by_shard(self) -> tuple[int, ...]:
        return tuple(s.fair.host_ops for s in self.shards)

    def note_cycle(self) -> None:
        """One refill cycle: restart every killed shard (rehydrated, not
        cold), then decay every alive shard's classifier."""
        for shard in self.shards:
            if not shard.alive:
                self.restart_shard(shard.index)
        for shard in self.shards:
            if shard.alive:
                shard.fair.note_cycle()

    def stage(self, tenant: str, item: Any, deadline: float | None = None,
              message_id: str | None = None) -> bool:
        return self.shard_of(tenant).fair.stage(
            tenant, item, deadline=deadline, message_id=message_id)

    def pick(self, k: int, now: float | None = None) -> list[tuple[str, Any]]:
        """This cycle's admission batch: the coordinator splits ``k``
        across the shards, and each shard's own DRR picks its grant."""
        demands = [s.fair.staged if s.alive else 0 for s in self.shards]
        weights = []
        for s in self.shards:
            if not s.alive or s.fair.staged == 0:
                weights.append(0.0)
                continue
            weights.append(sum(self.tenancy.weight_of(t)
                               for t, d in s.fair.drr.depths().items()
                               if d > 0))
        grants = self.coordinator.allocate(k, demands, weights)
        picked: list = []
        for shard, grant in zip(self.shards, grants):
            if grant > 0:
                picked += shard.fair.pick(grant, now=now)
        return picked

    def over_share(self) -> frozenset:
        """The flood set over the alive shards after a gossip exchange: a
        coalition classified anywhere is degraded everywhere (except
        across a partition)."""
        self.gossip()
        flood: set = set()
        for shard in self.shards:
            if shard.alive:
                flood |= set(shard.fair.over_share())
        return frozenset(flood)

    def depths(self) -> dict:
        depths = {t: 0 for t in self.tenancy.tenants}
        for tenant, depth in self.drr.depths().items():
            depths[tenant] = depths.get(tenant, 0) + depth
        return depths

    # -- gossip --------------------------------------------------------------

    def attach_journal(self, journal) -> None:
        """Record gossip, kills, rehydrations and partitions as
        ``kind="admission"`` lines on a :class:`~..obs.journal.TickJournal`
        (None detaches; the exchange never depends on it)."""
        self._journal = journal

    def _journal_event(self, payload: dict) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append_event("admission", payload)
        except (OSError, ValueError):  # a failed write never stops gossip
            pass

    def gossip(self) -> None:
        """Exchange flood classifications between alive, unpartitioned
        shards: every peer adopts the union (sticky, with the restore
        grace), and each classification is journaled once, when it first
        spreads."""
        connected = [s for s in self.shards if s.alive and not s.partitioned]
        if len(connected) < 2:
            return
        union: set = set()
        for shard in connected:
            union |= shard.fair._flood_sticky
        if not union:
            return
        for shard in connected:
            shard.fair.adopt_flood(union)
        fresh = union - self._gossiped
        if fresh:
            self._gossiped |= fresh
            self._journal_event({
                "event": "gossip", "flood": sorted(fresh),
                "shards": [s.index for s in connected],
            })

    # -- chaos seams (FleetFaultPlan admission faults) ---------------------

    def kill_shard(self, shard: int, handback=None) -> int:
        """Kill one admission shard: tombstone its accounting, hand every
        staged request back through ``handback(message)`` (the worker
        wires ``change_message_visibility(0)``) and mark it dead until
        :meth:`restart_shard` or the next cycle's restart.  Returns the
        number handed back."""
        target = self.shards[shard]
        if not target.alive:
            return 0
        target.tombstone = target.fair.export_state()
        released = 0
        drr = target.fair.drr
        for tenant in list(drr.depths()):
            while (item := drr.pop_tail(tenant)) is not None:
                released += 1
                if handback is not None:
                    handback(item[3])
        target.fair = target._fresh_fair()
        target.fair.lifecycle = self._lifecycle
        target.alive = False
        target.kills += 1
        self.events.append(_PoolEvent(
            "admission-kill", time.perf_counter(),
            {"shard": shard, "handed_back": released}))
        self._journal_event({"event": "kill", "shard": shard,
                             "handed_back": released})
        return released

    def restart_shard(self, shard: int) -> int:
        """Restart a killed shard from its tombstone, then adopt the
        connected peers' flood classifications.  Returns the records
        recovered."""
        target = self.shards[shard]
        if target.alive:
            return 0
        recovered = 0
        if target.tombstone is not None:
            recovered = target.fair.import_state(target.tombstone)
            target.tombstone = None
        target.alive = True
        target.partitioned = False
        peers_flood: set = set()
        for peer in self.shards:
            if peer.alive and not peer.partitioned and peer is not target:
                peers_flood |= peer.fair._flood_sticky
        if peers_flood:
            target.fair.adopt_flood(peers_flood)
        target.rehydrations += 1
        target.rehydrated_records = recovered
        self.events.append(_PoolEvent(
            "admission-rehydrate", time.perf_counter(),
            {"shard": shard, "records": recovered}))
        self._journal_event({"event": "rehydrate", "shard": shard,
                             "records": recovered})
        return recovered

    def partition_shard(self, shard: int, partitioned: bool = True) -> None:
        """Flip one shard's gossip partition: it keeps admitting its slice
        but is left out of the exchange both ways."""
        self.shards[shard].partitioned = bool(partitioned)
        self._journal_event({"event": "partition" if partitioned else "heal",
                             "shard": shard})

    # -- durable state: rides the worker's export_admission_state "fair" ---

    def export_state(self) -> dict:
        shards = []
        for shard in self.shards:
            entry = {
                "fair": shard.fair.export_state(),
                "alive": shard.alive,
                "kills": shard.kills,
                "rehydrations": shard.rehydrations,
            }
            if shard.ladder is not None:
                entry["ladder"] = shard.ladder.export_state()
            shards.append(entry)
        return {
            "sharded": True,
            "shards": shards,
            "coordinator": self.coordinator.export_state(),
            "homes": [[tenant, int(shard)]
                      for tenant, shard in self._homes.items()],
            "overflow_total": self.overflow_total,
            "records": (sum(e["fair"].get("records", 0) for e in shards)
                        + len(self._homes)),
        }

    def import_state(self, state: dict, *, rebase: float = 0.0,
                     now: float | None = None,
                     max_age_s: float = 0.0) -> int:
        recovered = 0
        for shard, entry in zip(self.shards, state.get("shards") or ()):
            if not isinstance(entry, dict):
                continue
            fair = entry.get("fair")
            if isinstance(fair, dict):
                recovered += shard.fair.import_state(
                    fair, rebase=rebase, now=now, max_age_s=max_age_s)
            ladder = entry.get("ladder")
            if shard.ladder is not None and isinstance(ladder, dict):
                recovered += shard.ladder.import_state(ladder)
            shard.kills = int(entry.get("kills", 0) or 0)
            shard.rehydrations = int(entry.get("rehydrations", 0) or 0)
        coordinator = state.get("coordinator")
        if isinstance(coordinator, dict):
            recovered += self.coordinator.import_state(coordinator)
        for entry in state.get("homes") or ():
            try:
                tenant, shard = entry
                tenant, shard = str(tenant), int(shard)
            except (TypeError, ValueError):
                continue
            if not 0 <= shard < len(self.shards):
                continue
            self._homes[tenant] = shard
            self._homes.move_to_end(tenant)
            recovered += 1
            while len(self._homes) > self.HOME_LIMIT:
                self._homes.popitem(last=False)
        self.overflow_total = int(state.get("overflow_total", 0) or 0)
        return recovered
