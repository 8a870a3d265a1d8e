"""Multi-tenant fair admission and the per-tenant prefix pool.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/tenancy.py``, with the
same classes and the same decisions on the same inputs:

- :class:`TenancyConfig`: the per-tenant policy (names, weights, TTFT
  SLOs, the pool's size, the overload ladder's tiers), validated at
  construction with the reference's messages;
- :class:`DeficitRoundRobin` and :class:`FairAdmission`: per-tenant
  staging sub-queues between the queue and the batcher, each refill's
  admission batch picked by deficit round robin with an EDF jump for
  requests near their TTFT deadline (bounded by a per-tenant urgency
  budget), staging caps per tenant and in all, and the flood classifier
  (:meth:`FairAdmission.over_share`) that the overload ladder reads;
- :class:`OverloadLadder`: the hysteretic tier machine (1 degrades the
  over-share tenants' budgets, 2 also evicts cold pool entries, 3 also
  sheds their staged requests with error replies);
- :class:`PrefixPool`: N resident per-tenant prefix caches in one stacked
  buffer per layer entry, in the batcher's cache layout.  A miss prefills
  the prefix once (the family's ``prefill_prefix``, its prompt pass
  through the CUDA flash forward on the card) and copies it into its pool
  row in place; a hit touches the LRU only.  The batcher's pooled insert
  gathers each row's prefix from the stacked rows on the device.

Everything but the pool's buffers is host bookkeeping, plain Python, and
the pick adds no device work: a refill still admits as one insert.  The
pool has one partition per engine shard of the sharded plane (one on the
single plane); the sharded admission plane over these classes is
:mod:`.admission_shards`.  The pool's mesh placement and the
request-lifecycle stamps are not ported.
Torch is imported by the pool alone, so the control plane may read these
classes without it.
"""

from __future__ import annotations

import heapq
import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any


@dataclass(frozen=True)
class _PoolEvent:
    """One prefix-pool decision (install/evict), timestamped — shaped
    like a :class:`~..fleet.pool.FleetEvent` so
    :func:`~..obs.trace.instant_trace_events` exports it onto the same
    Chrome-trace timeline as the fleet's supervisor decisions."""

    name: str
    t: float
    args: dict = field(default_factory=dict)


# the smallest admissible weight/quantum — AND their product: one DRR
# round earns quantum*weight of deficit, so admitting one request costs
# ~1/(quantum*weight) scheduler rounds; flooring the product (validated
# in TenancyConfig) bounds that at 100 rounds
MIN_WEIGHT = 0.01

# the overload ladder's tier count: 1 = degrade, 2 = + evict cold
# prefix entries, 3 = + shed with explicit error replies
MAX_SHED_TIERS = 3


@dataclass(frozen=True)
class TenancyConfig:
    """The multi-tenant admission policy.

    ``tenants`` names the KNOWN tenants (weights/SLOs align by index);
    unknown tenant labels arriving on the queue are still served, at
    weight 1.0 — fairness must not require pre-registration, only
    priority does.  ``weights`` empty = all 1.0.

    ``prefix_pool`` > 0 enables the per-tenant prefix-cache pool with
    that many resident entries PER SHARD; ``prefix_len`` is the pool's
    static prefix bucket (every pooled prefix must be exactly this many
    tokens — the compiled insert closes over it; the worker defaults it
    to ``seq_len``).  ``sticky`` toggles affinity-first routing on the
    sharded plane (off = today's freest-first, the FIFO-routing
    baseline the bench compares against); ``sticky_imbalance`` is how
    many free slots the freest shard may lead the home shard by before
    stickiness yields (0 = auto: the shard's slot count, i.e. yield
    only when the home shard is full).  ``fair`` toggles the DRR pick
    (off = arrival order through the same staging machinery — the FIFO
    admission baseline).  ``ttft_slo_s`` aligns per-tenant TTFT SLOs
    with ``tenants`` (empty = no SLO); the bench scores
    time-over-TTFT-SLO per tenant from it.
    """

    tenants: tuple[str, ...]
    weights: tuple[float, ...] = ()
    prefix_pool: int = 0
    prefix_len: int = 0
    sticky: bool = True
    sticky_imbalance: int = 0
    fair: bool = True
    quantum: float = 1.0
    ttft_slo_s: tuple[float, ...] = ()
    # deadline-aware admission (EDF blended into the DRR pick): a staged
    # request whose arrival-based TTFT deadline (SentTimestamp +
    # ttft_slo_s) falls within ``urgency_window_s`` of now may jump the
    # quantum — charged against its tenant's deficit, which may go at
    # most ``urgency_budget`` requests negative (the bounded borrow that
    # keeps deadline jumps from starving compliant tenants).  0 = off:
    # the pick is byte-identical to pure DRR, deadlines or not.
    urgency_window_s: float = 0.0
    urgency_budget: float = 2.0
    # tiered load shedding under measured overload pressure (see
    # OverloadLadder): 0 = off (the TTL shed stays the only tier);
    # 1 = degrade over-share tenants to a smaller generate_tokens;
    # 2 = + evict cold prefix-pool entries; 3 = + shed staged requests
    # from the most-over-share tenants with explicit error replies.
    shed_tiers: int = 0
    # the fair-admission staging (lookahead) window, in requests:
    # 0 = auto (per-tenant one engine-full, total two engine-fulls —
    # the defaults).  A deeper window lets DRR/EDF reorder more
    # of the backlog (a victim's request must be STAGED before any
    # admission policy can prefer it), at bounded extra memory: the
    # queue itself remains the real backlog.
    staging_per_tenant: int = 0
    staging_total: int = 0
    # sharded admission plane: N >= 2 splits the staging
    # plane into N crash-tolerant AdmissionShard workers — tenants map
    # to shards by consistent hash (sticky, so a tenant's prefix home
    # and DRR state live on one shard), global fairness reconciled via
    # rate-bounded cross-shard credit borrowing.  1 = the single staging
    # plane, the only one ported.
    admission_shards: int = 1
    # decode-phase deadline (seconds of decode budget per generated
    # token): once a request has produced its first token, it must
    # sustain decode_slo_s per remaining token or be shed with an
    # explicit error reply (reason="decode_deadline").  0 = off — the
    # TTFT deadline remains the only enforced SLO.
    decode_slo_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.tenants:
            raise ValueError("tenancy needs at least one tenant name")
        if len(set(self.tenants)) != len(self.tenants):
            raise ValueError(f"duplicate tenant names in {self.tenants}")
        for name in self.tenants:
            if not name or not isinstance(name, str):
                raise ValueError(f"tenant names must be non-empty strings "
                                 f"(got {name!r})")
        if self.weights and len(self.weights) != len(self.tenants):
            raise ValueError(
                f"{len(self.weights)} weight(s) for {len(self.tenants)} "
                "tenant(s) — counts must match"
            )
        for w in self.weights:
            if not w >= MIN_WEIGHT:
                # a round earns quantum*weight of deficit: a vanishing
                # weight makes the DRR spin ~1/(quantum*weight) full
                # rounds per admitted request inside the refill loop —
                # a legal-looking config must not be able to stall the
                # serving worker, so tiny weights are a usage error
                raise ValueError(
                    f"tenant weights must be >= {MIN_WEIGHT} (got {w}; "
                    "express shares by raising the other weights "
                    "instead of vanishing this one)"
                )
        if self.prefix_pool < 0:
            raise ValueError(
                f"prefix_pool={self.prefix_pool} must be >= 0 (0 = off)"
            )
        if self.prefix_len < 0:
            raise ValueError(
                f"prefix_len={self.prefix_len} must be >= 0"
            )
        if self.sticky_imbalance < 0:
            raise ValueError(
                f"sticky_imbalance={self.sticky_imbalance} must be >= 0 "
                "(0 = auto)"
            )
        if not self.quantum >= MIN_WEIGHT:
            raise ValueError(
                f"quantum={self.quantum} must be >= {MIN_WEIGHT} "
                "(a vanishing quantum spins the scheduler)"
            )
        if self.weights and self.quantum * min(self.weights) < MIN_WEIGHT:
            # the two floors compose: a round earns quantum*weight, so
            # quantum=0.01 with weight=0.01 would still cost ~10,000
            # rounds per admitted request — the PRODUCT is what bounds
            # the scheduler's work, so the product gets the floor
            raise ValueError(
                f"quantum * min(weight) = "
                f"{self.quantum * min(self.weights):g} must be >= "
                f"{MIN_WEIGHT} (each DRR round earns quantum*weight of "
                "deficit; a vanishing product spins the refill loop)"
            )
        if self.ttft_slo_s and len(self.ttft_slo_s) != len(self.tenants):
            raise ValueError(
                f"{len(self.ttft_slo_s)} TTFT SLO(s) for "
                f"{len(self.tenants)} tenant(s) — counts must match"
            )
        for slo in self.ttft_slo_s:
            if slo < 0:
                raise ValueError(f"TTFT SLOs must be >= 0 (got {slo})")
        if self.urgency_window_s < 0:
            raise ValueError(
                f"urgency_window_s={self.urgency_window_s} must be >= 0 "
                "(0 = off)"
            )
        if self.urgency_budget < 0:
            raise ValueError(
                f"urgency_budget={self.urgency_budget} must be >= 0"
            )
        if not 0 <= self.shed_tiers <= MAX_SHED_TIERS:
            raise ValueError(
                f"shed_tiers={self.shed_tiers} must be in "
                f"[0, {MAX_SHED_TIERS}] (0 = off)"
            )
        if self.staging_per_tenant < 0 or self.staging_total < 0:
            raise ValueError(
                "staging_per_tenant and staging_total must be >= 0 "
                "(0 = auto)"
            )
        if self.admission_shards < 1:
            raise ValueError(
                f"admission_shards={self.admission_shards} must be >= 1 "
                "(1 = the single staging plane)"
            )
        if self.decode_slo_s < 0:
            raise ValueError(
                f"decode_slo_s={self.decode_slo_s} must be >= 0 (0 = off)"
            )

    # weight_of runs once per tenant per DRR round on the refill hot
    # path: dict lookups, built once (cached_property assigns through
    # the instance __dict__, which frozen dataclasses allow)
    @cached_property
    def _weight_by_tenant(self) -> "dict[str, float]":
        return dict(zip(self.tenants, self.weights))

    @cached_property
    def _slo_by_tenant(self) -> "dict[str, float]":
        return dict(zip(self.tenants, self.ttft_slo_s))

    def weight_of(self, tenant: str) -> float:
        """Configured weight, or 1.0 for tenants not pre-registered."""
        return self._weight_by_tenant.get(tenant, 1.0)

    def slo_of(self, tenant: str) -> float:
        """Configured TTFT SLO seconds, or 0.0 (= none)."""
        return self._slo_by_tenant.get(tenant, 0.0)

    def deadline_of(
        self, tenant: str, arrived_epoch: "float | None"
    ) -> "float | None":
        """The request's arrival-based TTFT deadline (epoch seconds), or
        None when the tenant has no SLO or the queue did not stamp an
        arrival — an undeadlined request never jumps the quantum."""
        slo = self.slo_of(tenant)
        if slo <= 0 or arrived_epoch is None:
            return None
        return arrived_epoch + slo


class DeficitRoundRobin:
    """Deficit-round-robin over per-tenant sub-queues, EDF-blendable.

    The classic Shreedhar/Varghese scheduler with per-request cost 1:
    each round visits tenants in first-seen order starting at a rotating
    cursor; a visited non-empty tenant earns ``quantum * weight`` of
    deficit and pops requests while its deficit covers them.  An
    emptied queue resets its deficit (credit never banks while there is
    nothing to spend it on), which also bounds any tenant's wait at a
    weight-proportional number of rounds.  ``pick`` keeps cycling
    rounds until ``k`` requests are picked or every queue is empty —
    the work-conservation invariant (a free slot is never left idle
    while any tenant has a staged request).  No randomness anywhere: a
    fixed arrival stream picks identically every run.

    **EDF blend** (``urgency_window_s > 0`` and ``pick(..., now=...)``):
    before the fair rounds, staged HEAD requests whose deadline falls
    within the urgency window of ``now`` are picked earliest-deadline-
    first.  Two bounds keep the blend fair:

    - every jump is *charged* to its tenant's deficit, which may go at
      most ``urgency_budget`` requests negative and resets with the
      queue on empty (per-busy-period borrow — kept debt would turn
      steady trickle traffic's jumps into loans repaid in extra wait);
    - every jump also spends one urgency CREDIT from a token bucket of
      capacity ``urgency_budget`` refilling at ``quantum * weight``
      per fair round — the tenant's fair-share rate — so a sustained
      urgent stream cannot jump faster than its share no matter how it
      shapes bursts (deficit reset alone would let a drain-and-refill
      abuser re-arm unlimited jumps).

    A tenant at either cap falls back to fair order, so the combined
    invariant holds: ``-urgency_budget <= deficit <= quantum * weight
    + 1``, sustained jump rate <= fair share, and a compliant
    backlogged tenant keeps its share whatever the deadline traffic
    does.  With no deadlines staged (or the window at 0) the pick is
    byte-identical to pure DRR — all of it property-tested in
    the reference's ``tests/test_admission.py``.
    """

    def __init__(self, weight_of=None, quantum: float = 1.0,
                 keep=(), urgency_window_s: float = 0.0,
                 urgency_budget: float = 0.0) -> None:
        if not quantum > 0:
            raise ValueError(f"quantum={quantum} must be > 0")
        if urgency_window_s < 0 or urgency_budget < 0:
            raise ValueError(
                "urgency_window_s and urgency_budget must be >= 0"
            )
        self._weight_of = weight_of or (lambda tenant: 1.0)
        self.quantum = quantum
        self.urgency_window_s = urgency_window_s
        self.urgency_budget = urgency_budget
        # tenants whose (empty) sub-queues stay registered forever —
        # the CONFIGURED tenants.  Unknown labels arrive from untrusted
        # message bodies, so their entries are pruned the moment they
        # drain: scheduler state stays bounded by keep + staging depth
        # no matter how many distinct labels an adversary invents.
        self._keep = frozenset(keep)
        self._queues: dict[str, deque] = {}
        self._deficit: dict[str, float] = {}
        self._order: list[str] = []  # first-seen tenant order
        self._cursor = 0
        self._ordinal = 0  # arrival stamp (the fair=False pick order)
        # deadline jumps taken out of fair order (introspection/gauges)
        self.urgent_picks = 0
        # the urgency-credit token bucket: jumps spend from a per-tenant
        # credit (capacity = urgency_budget) that refills at quantum *
        # weight per completed fair ROUND — i.e. at the tenant's fair-
        # share rate.  The deficit charge alone is not enough: deficit
        # resets when a queue empties (per-busy-period budgets, which
        # steady trickle traffic needs), so a drain-and-refill abuser
        # could re-arm unlimited jumps by sending its urgent requests
        # two at a time.  Credit persists across busy periods and
        # refills only as rounds pass, bounding sustained jump rate to
        # the fair share however the abuser shapes its bursts.
        # _rounds counts fair-phase rotations FRACTIONALLY (a pick
        # truncated after visiting i of n tenants advances i/n), so
        # credits keep refilling even when every pick is smaller than
        # one rotation — the common case under many-tenant contention.
        self._rounds = 0.0
        self._credit: dict[str, float] = {}
        self._credit_round: dict[str, float] = {}
        # object ids of the MOST RECENT pick()'s urgent items —
        # refund() consults it so a shed urgent pick gives back its
        # credit too, attributed to the exact item (a count per tenant
        # would let a shed FAIR pick return a credit that an admitted
        # urgent jump in the same pick legitimately spent)
        self._last_urgent_ids: set[int] = set()

    def push(self, tenant: str, item: Any,
             deadline: "float | None" = None) -> None:
        """Stage one item.  ``deadline`` (epoch seconds) is the
        request's TTFT deadline; None = no SLO — the item can never
        jump the quantum."""
        queue = self._queues.get(tenant)
        if queue is None:
            queue = self._queues[tenant] = deque()
            self._deficit[tenant] = 0.0
            self._credit.setdefault(tenant, self.urgency_budget)
            self._credit_round.setdefault(tenant, self._rounds)
            self._order.append(tenant)
        queue.append((self._ordinal, deadline, item))
        self._ordinal += 1

    def depth(self, tenant: str) -> int:
        queue = self._queues.get(tenant)
        return len(queue) if queue is not None else 0

    def depths(self) -> dict[str, int]:
        """Per-tenant staged depth: every configured tenant (a drained
        one's gauge reads 0 instead of disappearing) plus whatever
        unknown labels are currently staged — drained unknowns are
        pruned, so the gauge cardinality stays bounded."""
        return {t: len(q) for t, q in self._queues.items()}

    @property
    def staged(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def deficit(self, tenant: str) -> float:
        """Introspection for the property tests."""
        return self._deficit.get(tenant, 0.0)

    def _prune(self) -> None:
        """Drop drained non-configured tenants (their deficit is already
        0 by the bounded-deficit reset, so removal changes no future
        pick; a re-arrival re-registers at the order's tail exactly like
        a first arrival).  The cursor is remapped to the same next-round
        tenant, so pruning never skips anyone's turn.  A tenant whose
        urgency credit is still refilling is kept too: pruning it
        would hand its re-registration a FULL bucket — the exact
        drain-and-refill re-arm the credit exists to prevent.  (In the
        worker only configured tenants can ever spend credit —
        unregistered labels have no SLO, so no deadline, so no jumps —
        which keeps this no-cardinality-leak: an adversarial unique
        label always drains with a full, prunable bucket.)"""
        dead = {
            t for t in self._order
            if not self._queues[t] and t not in self._keep
            and self._deficit[t] == 0.0
            and self._refill_credit(t) >= self.urgency_budget
        }
        if not dead:
            return
        n = len(self._order)
        survivors = [t for t in self._order if t not in dead]
        cursor = 0
        for i in range(n):
            tenant = self._order[(self._cursor + i) % n]
            if tenant not in dead:
                cursor = survivors.index(tenant)
                break
        for tenant in dead:
            del self._queues[tenant]
            del self._deficit[tenant]
            self._credit.pop(tenant, None)
            self._credit_round.pop(tenant, None)
        self._order = survivors
        self._cursor = cursor

    def refund(self, tenant: str, item: Any = None) -> None:
        """Give back one picked request's charges (most recent pick).

        The redelivery/TTL skew fix: a picked item that is then SHED
        (expired while staged, or a redelivered copy of an already-
        answered request) consumed no slot — without the refund its
        tenant paid a full request of deficit (and, for an urgent
        pick, an urgency credit) for nothing, so a flood of
        expired/redelivered copies would silently shrink a tenant's
        future share — or strip an SLO tenant's jump budget.  Pass
        the picked ``item`` so the credit refund is attributed to the
        exact urgent pick that spent it (fair picks spent none — a
        per-tenant count would let a shed fair pick return a credit an
        ADMITTED urgent jump in the same pick legitimately consumed);
        without the item only the deficit is refunded.  The deficit
        refund is only meaningful while the tenant still has backlog
        (an emptied queue resets anyway).  Neither refund can exceed
        its bound: each returns exactly what the pick charged."""
        if item is not None and id(item) in self._last_urgent_ids:
            self._last_urgent_ids.discard(id(item))
            if tenant in self._credit:
                self._credit[tenant] = min(
                    self.urgency_budget, self._credit[tenant] + 1.0
                )
        if self._queues.get(tenant):
            self._deficit[tenant] = self._deficit.get(tenant, 0.0) + 1.0

    def pop_over_deadline(
        self, now: float, eligible=None,
    ) -> "tuple[str, Any] | None":
        """Pop the staged HEAD item most over its deadline at ``now``
        (ties by arrival), or None when nothing staged is past due —
        the ladder's tier-3 most-over-SLO shed order.  ``eligible``
        (a set of tenant names, or None = all) restricts candidates:
        the worker passes the over-share set so a COMPLIANT tenant's
        late request is served late rather than shed."""
        best = None
        for tenant in self._order:
            if eligible is not None and tenant not in eligible:
                continue
            queue = self._queues[tenant]
            if not queue:
                continue
            ordinal, deadline, _ = queue[0]
            if deadline is None or deadline >= now:
                continue
            cand = (deadline, ordinal, tenant)
            if best is None or cand < best:
                best = cand
        if best is None:
            return None
        tenant = best[2]
        item = self._queues[tenant].popleft()[2]
        if not self._queues[tenant]:
            self._deficit[tenant] = 0.0
        return tenant, item

    def pop_tail(self, tenant: str) -> "Any | None":
        """Pop the NEWEST staged item of ``tenant`` (the ladder's tier-3
        over-share shed order: the oldest staged requests keep their
        place; the latest arrivals of the over-share tenant absorb the
        shed), or None when nothing is staged."""
        queue = self._queues.get(tenant)
        if not queue:
            return None
        item = queue.pop()[2]
        if not queue:
            self._deficit[tenant] = 0.0
        return item

    # ------------------------------------------------------------------
    # Durable-state surface (core/durable.py StateProvider).  Staged
    # QUEUES are deliberately NOT serialized: staged messages are live
    # receipt handles that die with the process and redeliver through
    # the queue's visibility timeout — for queue contents, a crash is
    # the start of a new busy period.  The ACCOUNTING must survive,
    # though: urgency debt and the credit token bucket are exactly what
    # a drain-and-refill abuser re-arms by forcing a restart, and
    # deficits in debt are loans a crash must not forgive.
    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        tenants = {
            t: {
                "deficit": self._deficit.get(t, 0.0),
                "credit": self._credit.get(t, self.urgency_budget),
                "credit_round": self._credit_round.get(t, self._rounds),
            }
            for t in self._order
        }
        return {
            "records": len(tenants),
            "tenants": tenants,
            "order": list(self._order),
            "cursor": self._cursor,
            "rounds": self._rounds,
            "urgent_picks": self.urgent_picks,
        }

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: "float | None" = None, max_age_s: float = 0.0,
    ) -> int:
        """Restore the scheduler's accounting (round clock, cursor,
        per-tenant deficits and urgency credits) into empty sub-queues.
        Tenants with nothing owed and a full bucket prune away on the
        next pick, exactly as live drained tenants do."""
        del rebase, now, max_age_s  # nothing here is clock-based
        order = [t for t in state.get("order", ()) if isinstance(t, str)]
        tenants = state.get("tenants") or {}
        self._rounds = float(state.get("rounds", self._rounds) or 0.0)
        recovered = 0
        for tenant in order:
            saved = tenants.get(tenant)
            if not isinstance(saved, dict):
                continue
            if tenant not in self._queues:
                self._queues[tenant] = deque()
                self._order.append(tenant)
            try:
                self._deficit[tenant] = float(saved.get("deficit", 0.0))
                self._credit[tenant] = min(
                    self.urgency_budget,
                    float(saved.get("credit", self.urgency_budget)),
                )
                self._credit_round[tenant] = min(
                    self._rounds,
                    float(saved.get("credit_round", self._rounds)),
                )
            except (TypeError, ValueError):
                continue
            recovered += 1
        cursor = state.get("cursor")
        if self._order and isinstance(cursor, int):
            self._cursor = cursor % len(self._order)
        self.urgent_picks = int(state.get("urgent_picks", 0) or 0)
        return recovered

    def pick(self, k: int, *, fair: bool = True,
             now: "float | None" = None) -> list[tuple[str, Any]]:
        """Pop up to ``k`` ``(tenant, item)`` pairs by deficit order.

        ``fair=False`` degrades to global arrival order across the same
        sub-queues (the FIFO-admission baseline the bench contrasts) —
        same staging, same bounds, no deficit accounting.  ``now``
        (epoch seconds) arms the EDF blend: staged deadlines within
        ``urgency_window_s`` of it may jump the quantum, charged
        against the bounded urgency budget.  ``now=None`` or a zero
        window is pure DRR, byte for byte.
        """
        self._last_urgent_ids = set()
        try:
            return self._pick(k, fair, now)
        finally:
            self._prune()

    def _refill_credit(self, tenant: str) -> float:
        """Lazily refill the tenant's urgency credit: quantum * weight
        per fair round elapsed since its last refill, capped at the
        budget."""
        elapsed = self._rounds - self._credit_round[tenant]
        if elapsed > 0:
            self._credit[tenant] = min(
                self.urgency_budget,
                self._credit[tenant]
                + elapsed * self.quantum * self._weight_of(tenant),
            )
            self._credit_round[tenant] = self._rounds
        return self._credit[tenant]

    def _pick_urgent(self, k: int, now: float,
                     out: list[tuple[str, Any]]) -> None:
        """The EDF phase: pop staged heads whose deadline falls within
        the urgency window, earliest deadline first (ties by arrival).
        Every jump spends one urgency CREDIT (the fair-share-rate
        token bucket) AND charges the tenant's deficit down to the
        ``-urgency_budget`` debt cap.  Runs before the fair rounds, so
        an SLO tenant about to blow its TTFT jumps the quantum — but
        its sustained jump rate can never exceed its fair share, and
        its per-busy-period borrow never exceeds the budget."""
        horizon = now + self.urgency_window_s
        while len(out) < k:
            best = None
            for tenant in self._order:
                queue = self._queues[tenant]
                if not queue:
                    continue
                ordinal, deadline, _ = queue[0]
                if deadline is None or deadline > horizon:
                    continue
                if self._deficit[tenant] - 1.0 < -self.urgency_budget:
                    continue  # debt cap: back to fair order
                if self._refill_credit(tenant) < 1.0:
                    continue  # jump rate cap: back to fair order
                cand = (deadline, ordinal, tenant)
                if best is None or cand < best:
                    best = cand
            if best is None:
                return
            tenant = best[2]
            item = self._queues[tenant].popleft()[2]
            out.append((tenant, item))
            self._deficit[tenant] -= 1.0
            self._credit[tenant] -= 1.0
            self._last_urgent_ids.add(id(item))
            self.urgent_picks += 1
            if not self._queues[tenant]:
                # the classic reset-on-empty applies to urgency debt
                # too: the budget is PER BUSY PERIOD.  A drained tenant
                # consumed no more than it arrived with, so carrying
                # its debt forward would turn every future urgent
                # request into a loan repaid in extra waiting — under
                # steady trickle arrivals that makes EDF *worse* than
                # pure DRR once the budget exhausts.  An abuser cannot
                # farm resets: refreshing the budget requires its own
                # queue to empty, i.e. it stopped flooding.
                self._deficit[tenant] = 0.0

    def _pick(self, k: int, fair: bool,
              now: "float | None") -> list[tuple[str, Any]]:
        out: list[tuple[str, Any]] = []
        if k <= 0 or not self._order:
            return out
        if not fair:
            # arrival order: items carry a monotone stage ordinal
            while len(out) < k:
                oldest, best = None, None
                for tenant in self._order:
                    queue = self._queues[tenant]
                    if queue and (best is None or queue[0][0] < best):
                        best, oldest = queue[0][0], tenant
                if oldest is None:
                    break
                out.append((oldest, self._queues[oldest].popleft()[2]))
            return out
        if self.urgency_window_s > 0 and now is not None:
            self._pick_urgent(k, now, out)
        n = len(self._order)
        while len(out) < k and any(
            self._queues[t] for t in self._order
        ):
            for i in range(n):
                tenant = self._order[(self._cursor + i) % n]
                queue = self._queues[tenant]
                if not queue:
                    # bounded deficit: an empty queue banks nothing
                    # (and urgency debt resets with it — per-busy-
                    # period budgets, see _pick_urgent)
                    self._deficit[tenant] = 0.0
                    continue
                if self._deficit[tenant] < 1.0:
                    # earn once per serviced round: a visit that merely
                    # RESUMES spending credit left over from a
                    # k-truncated pick must not earn again, or deficits
                    # grow without bound and weighted shares collapse
                    # toward equal whenever the per-refill pick is
                    # smaller than a tenant's round quantum.  A tenant
                    # in urgency debt earns its way back toward 1.0
                    # over several rounds — the repayment that keeps
                    # deadline jumps from compounding.
                    self._deficit[tenant] += (
                        self.quantum * self._weight_of(tenant)
                    )
                while queue and self._deficit[tenant] >= 1.0 \
                        and len(out) < k:
                    out.append((tenant, queue.popleft()[2]))
                    self._deficit[tenant] -= 1.0
                if not queue:
                    self._deficit[tenant] = 0.0
                if len(out) >= k:
                    # the rotation that keeps a small k from always
                    # favoring the first-seen tenant: resume the NEXT
                    # pick one past the tenant that filled this one —
                    # UNLESS its turn is unfinished (backlog left and
                    # deficit still ≥ 1): then the cursor stays put so
                    # the next pick resumes the same turn, or a
                    # high-weight tenant would spend each round's
                    # credit at the same one-visit-per-pick rate as
                    # weight-1 tenants and shares would collapse
                    unfinished = bool(queue) and \
                        self._deficit[tenant] >= 1.0
                    self._cursor = (
                        self._cursor + i + (0 if unfinished else 1)
                    ) % n
                    # a truncated pick still advances the round clock
                    # by the fraction of the rotation it visited
                    self._rounds += (i + 1) / n
                    return out
            # one full rotation completed: urgency credits accrue one
            # round of fair-share refill (see _refill_credit)
            self._rounds += 1
        return out


class FairAdmission:
    """The worker-side staging area between the queue and the batcher.

    Receives go into per-tenant sub-queues (bounded — the queue itself
    is the backlog; staging is only the one-refill lookahead DRR needs
    to see across tenants), and each refill cycle's admission batch is
    picked by :class:`DeficitRoundRobin`.  Per-tenant staging is capped
    at ``per_tenant_limit`` so one flooding tenant cannot monopolize the
    lookahead window either: overflow messages are *handed back* to the
    queue by the worker (``change_message_visibility(0)``) instead of
    staged — at-least-once backpressure, never a drop.

    The staging layer also keeps the overload ladder's flood
    classifier: a per-tenant exponentially-decayed STAGED-ARRIVAL rate
    (:meth:`note_cycle` decays, :meth:`stage` counts).  Instantaneous
    staged depth cannot tell a coordinated coalition from normal load
    (the staging caps flatten every backlogged tenant to a similar
    depth), but sustained arrival rate can — and a victim trickling
    one request every few cycles can never cross the rate floor.
    """

    #: per-cycle decay of the arrival-rate EWMA (steady state for a
    #: tenant staging r requests/cycle is r / (1 - decay) = 5r)
    ARRIVAL_DECAY = 0.8
    #: rate entries below this decay out entirely (bounds the dict)
    ARRIVAL_FLOOR = 0.05
    #: over-share = rate share > margin x weight share, AND the
    #: absolute rate is at least the floor below — both tuned so a
    #: coalition member modestly over its share still classifies while
    #: a trickling SLO victim never can
    OVER_SHARE_MARGIN = 1.25
    OVER_SHARE_MIN_RATE = 3.0
    #: how many times the min rate an SLO-carrying tenant must sustain
    #: before the shed tier may treat it as flooding (an SLO is close
    #: to a no-shed contract: only an unambiguous premium flood loses
    #: requests, and then only already-expired ones)
    PREMIUM_FLOOD_FACTOR = 3.0
    #: distinct message ids remembered for rate dedup (see stage())
    SEEN_IDS = 8192

    def __init__(
        self,
        tenancy: TenancyConfig,
        *,
        per_tenant_limit: int,
        total_limit: int,
    ) -> None:
        if per_tenant_limit < 1 or total_limit < 1:
            raise ValueError("staging limits must be >= 1")
        self.tenancy = tenancy
        self.per_tenant_limit = per_tenant_limit
        self.total_limit = total_limit
        self.drr = DeficitRoundRobin(
            weight_of=tenancy.weight_of, quantum=tenancy.quantum,
            keep=tenancy.tenants,
            urgency_window_s=tenancy.urgency_window_s,
            urgency_budget=tenancy.urgency_budget,
        )
        # messages actually handed back to the queue on a staging-cap
        # hit — the CALLER increments it when its
        # change_message_visibility(0) went through, so the counter
        # never claims a backpressure event that did not happen
        self.overflow_total = 0
        # the request-lifecycle registry (obs/lifecycle.py): the worker's
        # attach_lifecycle wires it, and staging stamps "staged"
        self.lifecycle = None
        # serial host work done (rate decays, stagings, flood scans): a
        # sharded admission plane's shards run concurrently, so a cost
        # model charges the max over its shards
        self.host_ops = 0
        # tenant -> decayed staged-arrivals-per-cycle (the ladder's
        # flood classifier input; pure bookkeeping — nothing on the
        # admission path reads it unless a ladder asks).  Rated by
        # UNIQUE message id: a backlogged victim's messages redeliver
        # every cycle while staging is contended, and counting each
        # redelivery would read exactly like a flood — only NEW work
        # is offered load.
        self.arrival_rate: dict[str, float] = {}
        self._seen_ids: OrderedDict = OrderedDict()
        # classification is STICKY while the flood's backlog persists:
        # a flood that stops sending drops below the rate floor within
        # a few decay cycles, but its queued backlog keeps drowning
        # everyone behind it — a classified tenant stays classified
        # until its staged queue actually drains
        self._flood_sticky: set[str] = set()
        # restart grace: a rehydrated classification has NO staged
        # backlog yet (staging dies with the process; the flood's
        # messages are still redelivering), so restored sticky entries
        # survive this many cycles without depth before the ordinary
        # drains-means-done rule applies again (import_state arms it)
        self._sticky_grace: dict[str, int] = {}

    def note_cycle(self) -> None:
        """Decay the arrival-rate EWMA one refill cycle (entries under
        :attr:`ARRIVAL_FLOOR` drop out, so the dict stays bounded by
        recent stagers no matter how many labels an adversary mints)."""
        self.host_ops += 1 + len(self.arrival_rate)
        decay = self.ARRIVAL_DECAY
        self.arrival_rate = {
            tenant: rate * decay
            for tenant, rate in self.arrival_rate.items()
            if rate * decay >= self.ARRIVAL_FLOOR
        }
        if self._sticky_grace:
            self._sticky_grace = {
                t: n - 1 for t, n in self._sticky_grace.items() if n > 1
            }

    def over_share(self) -> frozenset:
        """Tenants whose decayed staged-arrival-rate share exceeds
        their weight share by :attr:`OVER_SHARE_MARGIN` and whose
        absolute rate clears :attr:`OVER_SHARE_MIN_RATE` — the
        overload ladder's flood set.  Empty under uniform load, for a
        lone trickler, or when nothing has staged recently.  Sticky:
        a classified tenant stays in the set while its staged queue
        is non-empty even after its measured rate decays (the attack
        stopped SENDING, but its backlog is still the overload), and
        drops out the moment its backlog clears."""
        self.host_ops += len(self.arrival_rate)
        fresh: set[str] = set()
        rates = self.arrival_rate
        if len(rates) >= 2:
            total = sum(rates.values())
            if total > 0:
                weights = {
                    t: self.tenancy.weight_of(t) for t in rates
                }
                wtotal = sum(weights.values())
                fresh = {
                    tenant for tenant, rate in rates.items()
                    if rate >= self.OVER_SHARE_MIN_RATE
                    and rate * wtotal
                    > self.OVER_SHARE_MARGIN * weights[tenant] * total
                }
        self._flood_sticky = fresh | {
            t for t in self._flood_sticky
            if self.drr.depth(t) > 0 or self._sticky_grace.get(t, 0) > 0
        }
        return frozenset(self._flood_sticky)

    def adopt_flood(self, tenants) -> None:
        """Adopt peer-gossiped flood classifications (the sharded
        admission plane's gossip receive side): sticky, armed with the
        restore grace — this shard has no local backlog or offered-rate
        history for the tenant yet, so without the grace the ordinary
        drains-means-done rule would immediately un-classify a flooder
        the moment it fails over here."""
        fresh = {str(t) for t in tenants} - self._flood_sticky
        if not fresh:
            return
        self._flood_sticky |= fresh
        for tenant in fresh:
            self._sticky_grace[tenant] = self.STICKY_RESTORE_GRACE

    @property
    def staged(self) -> int:
        return self.drr.staged

    @property
    def room(self) -> int:
        """How many more messages staging can hold right now."""
        return max(0, self.total_limit - self.staged)

    def _note_offered(self, tenant: str, message_id: "str | None") -> None:
        """Count one unit of OFFERED load into the tenant's rate —
        once per distinct message id (redeliveries of the same message
        are not new work; ``message_id=None`` always counts)."""
        if message_id is not None:
            if message_id in self._seen_ids:
                self._seen_ids.move_to_end(message_id)
                return
            self._seen_ids[message_id] = True
            while len(self._seen_ids) > self.SEEN_IDS:
                self._seen_ids.popitem(last=False)
        self.arrival_rate[tenant] = (
            self.arrival_rate.get(tenant, 0.0) + 1.0
        )

    def stage(self, tenant: str, item: Any,
              deadline: "float | None" = None,
              message_id: "str | None" = None) -> bool:
        """Stage one parsed request; False = per-tenant/total cap hit
        (the caller hands the message back to the queue and counts it
        in :attr:`overflow_total` — only when the hand-back actually
        happened).  ``deadline`` is the request's arrival-based TTFT
        deadline (epoch seconds; None = no SLO), carried so the EDF
        blend can see it at pick time; ``message_id`` dedups the
        offered-load rate under redelivery."""
        self.host_ops += 1
        if self.drr.depth(tenant) >= self.per_tenant_limit:
            # offered past its OWN cap: the per-tenant flood signature
            # — counted into the rate even though nothing stages (a
            # saturated flooder's successful stages are throttled to
            # the drain rate, which would blind the classifier to the
            # sustained offered load behind them)
            self._note_offered(tenant, message_id)
            return False
        if self.staged >= self.total_limit:
            # the TOTAL cap is shared congestion, not tenant behavior:
            # counting it would accrue flood-rate onto whoever happens
            # to arrive (e.g. a victim redelivering behind a stampede)
            return False
        self.drr.push(tenant, item, deadline=deadline)
        self._note_offered(tenant, message_id)
        if self.lifecycle is not None:
            self.lifecycle.stamp(message_id, "staged", tenant=tenant)
        return True

    def pick(self, k: int,
             now: "float | None" = None) -> list[tuple[str, Any]]:
        return self.drr.pick(k, fair=self.tenancy.fair, now=now)

    def depths(self) -> dict[str, int]:
        depths = {t: 0 for t in self.tenancy.tenants}
        depths.update(self.drr.depths())
        return depths

    # ------------------------------------------------------------------
    # Durable-state surface (core/durable.py StateProvider): the flood
    # classifier.  A crash used to UN-classify an active flooder — the
    # restarted worker saw zero offered-rate history, so a coalition
    # mid-attack got a fresh innocence window while its backlog drowned
    # every victim behind it.  The decayed rates, the sticky set, and
    # the seen-message-id dedup window all come back; the sticky set
    # additionally survives the first post-restart over_share() calls
    # via a redelivery grace (staged queues restart empty, and dropping
    # classification before the flood's backlog redelivers would be the
    # exact un-classify bug this section exists to fix).
    # ------------------------------------------------------------------

    #: post-restart cycles a restored sticky classification survives
    #: without backlog (the visibility-timeout redelivery window)
    STICKY_RESTORE_GRACE = 64

    def export_state(self) -> dict:
        state = {
            "drr": self.drr.export_state(),
            "arrival_rate": dict(self.arrival_rate),
            "flood_sticky": sorted(self._flood_sticky),
            "seen_ids": list(self._seen_ids),
            "overflow_total": self.overflow_total,
        }
        state["records"] = (
            state["drr"].get("records", 0)
            + len(self.arrival_rate) + len(self._flood_sticky)
        )
        return state

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: "float | None" = None, max_age_s: float = 0.0,
    ) -> int:
        recovered = 0
        drr = state.get("drr")
        if isinstance(drr, dict):
            recovered += self.drr.import_state(
                drr, rebase=rebase, now=now, max_age_s=max_age_s
            )
        rates = state.get("arrival_rate")
        if isinstance(rates, dict):
            for tenant, rate in rates.items():
                try:
                    rate = float(rate)
                except (TypeError, ValueError):
                    continue
                if rate >= self.ARRIVAL_FLOOR:
                    self.arrival_rate[str(tenant)] = rate
                    recovered += 1
        sticky = state.get("flood_sticky") or ()
        restored_sticky = {str(t) for t in sticky}
        if restored_sticky:
            self._flood_sticky |= restored_sticky
            self._sticky_grace = {
                t: self.STICKY_RESTORE_GRACE for t in restored_sticky
            }
            recovered += len(restored_sticky)
        for mid in state.get("seen_ids") or ():
            self._seen_ids[str(mid)] = True
            while len(self._seen_ids) > self.SEEN_IDS:
                self._seen_ids.popitem(last=False)
        self.overflow_total = int(state.get("overflow_total", 0) or 0)
        return recovered


#: Per-tier (enter, exit) pressure thresholds — enter at or above the
#: first, leave below the second.  The gap is the hysteresis band: a
#: pressure oscillating inside it neither enters nor exits, so the
#: ladder cannot flap tier actions at the noise floor.
TIER_THRESHOLDS: tuple[tuple[float, float], ...] = (
    (0.50, 0.35),  # tier 1: degrade over-share tenants
    (0.75, 0.60),  # tier 2: + evict cold prefix-pool entries
    (0.90, 0.75),  # tier 3: + shed with explicit error replies
)


class OverloadLadder:
    """The graceful-degradation state machine between "serving normally"
    and "cliff-edge failure".

    The worker measures a scalar overload pressure each refill cycle
    (staged-backlog fraction gated by slot occupancy — see
    ``ContinuousWorker._overload_pressure``) and feeds it here; the
    ladder answers with the active tier.  Transitions are hysteretic
    per tier (:data:`TIER_THRESHOLDS`): entry jumps straight to the
    highest tier whose enter threshold the pressure clears (a cliff
    must be answered immediately); exit descends through every tier
    whose exit threshold the pressure has fallen below (one transition
    event records the whole descent), and holds inside a tier's
    hysteresis band.
    ``tiers`` caps how far the ladder may climb (the ``shed_tiers``
    knob); every transition is recorded as an ``overload-*`` event for
    the Chrome-trace timeline and counted for the Prometheus side.

    What the tiers DO lives in the worker (degrade / evict / shed) —
    the ladder only decides WHEN, so the decision logic stays a pure,
    clock-free, property-testable function of the pressure stream.
    """

    def __init__(self, tiers: int,
                 thresholds=TIER_THRESHOLDS,
                 smoothing: float = 0.5) -> None:
        if not 1 <= tiers <= len(thresholds):
            raise ValueError(
                f"tiers={tiers} must be in [1, {len(thresholds)}]"
            )
        for enter, exit_ in thresholds:
            if not 0.0 < exit_ < enter <= 1.0:
                raise ValueError(
                    f"need 0 < exit < enter <= 1 per tier "
                    f"(got enter={enter}, exit={exit_})"
                )
        if not 0.0 < smoothing <= 1.0:
            raise ValueError(
                f"smoothing={smoothing} must be in (0, 1] (1 = none)"
            )
        self.tiers = tiers
        self.thresholds = tuple(thresholds)
        # EWMA weight of the newest pressure sample: tier actions
        # (especially tier 3's shed) drop the raw pressure the very
        # next cycle, so acting on the instantaneous value would flap
        # enter/exit every few cycles no matter how wide the
        # hysteresis band — the smoothed pressure is what transitions
        # compare against
        self.smoothing = smoothing
        self.tier = 0
        self.last_pressure = 0.0
        self._ewma: "float | None" = None
        self.transitions = 0
        # per-tier entry counters (index 1..tiers; 0 unused)
        self.entered_total = [0] * (len(thresholds) + 1)
        self.events: deque[_PoolEvent] = deque(maxlen=1024)

    def exit_threshold(self, tier: int) -> float:
        return self.thresholds[tier - 1][1]

    def update(self, pressure: float,
               now: "float | None" = None) -> int:
        """Advance the ladder one observation; returns the active tier.

        ``now`` timestamps the transition events; the default
        (``time.perf_counter()``) matches every other trace-event
        producer's timebase, so merged Chrome traces line up — only
        pass a clock that shares it (tests pin exact instants with
        explicit values)."""
        self._ewma = (
            pressure if self._ewma is None
            else self.smoothing * pressure
            + (1.0 - self.smoothing) * self._ewma
        )
        pressure = self._ewma
        self.last_pressure = pressure
        target = self.tier
        for tier in range(1, self.tiers + 1):
            if pressure >= self.thresholds[tier - 1][0]:
                target = max(target, tier)
        if target > self.tier:
            self._transition(self.tier, target, pressure, now)
            self.tier = target
        else:
            tier = self.tier
            while tier > 0 and pressure < self.exit_threshold(tier):
                tier -= 1
            if tier != self.tier:
                self._transition(self.tier, tier, pressure, now)
                self.tier = tier
        return self.tier

    def _transition(self, old: int, new: int, pressure: float,
                    now: "float | None") -> None:
        self.transitions += 1
        if new > old:
            self.entered_total[new] += 1
        self.events.append(_PoolEvent(
            "overload-enter" if new > old else "overload-exit",
            time.perf_counter() if now is None else now,
            {"from": old, "to": new, "pressure": round(pressure, 4)},
        ))

    def trace_events(self, time_origin: float | None = None) -> list[dict]:
        """Tier transitions as Chrome-trace instants (``overload-*``
        names land in their own ``"overload"`` category, mergeable into
        a tick trace via ``to_chrome_trace(..., extra_events=...)``)."""
        from ..obs.trace import instant_trace_events

        return instant_trace_events(self.events, time_origin)

    # ------------------------------------------------------------------
    # Durable-state surface (core/durable.py StateProvider): a crash
    # used to reset the ladder to tier 0 — a controller that died UNDER
    # overload came back serving the same overload at full budgets for
    # the whole EWMA warm-up, the exact moment shedding mattered.
    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        return {
            "records": 1,
            "tier": self.tier,
            "ewma": self._ewma,
            "last_pressure": self.last_pressure,
            "transitions": self.transitions,
            "entered_total": list(self.entered_total),
        }

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: "float | None" = None, max_age_s: float = 0.0,
    ) -> int:
        del rebase, now, max_age_s  # pressure is cycle-based, not clocked
        tier = state.get("tier")
        if not isinstance(tier, int) or not 0 <= tier <= self.tiers:
            return 0
        self.tier = tier
        ewma = state.get("ewma")
        self._ewma = float(ewma) if ewma is not None else None
        self.last_pressure = float(state.get("last_pressure", 0.0) or 0.0)
        self.transitions = int(state.get("transitions", 0) or 0)
        entered = state.get("entered_total")
        if isinstance(entered, list) and len(entered) == len(self.entered_total):
            self.entered_total = [int(n) for n in entered]
        return 1


def export_tenant_homes(homes) -> dict:
    """Sticky-home map → JSON-able state (``core/durable.py``): the
    ``(tenant, prefix-crc32)`` → home-shard assignments, LRU order
    preserved.  Losing these on restart sent every tenant through a
    fresh freest-first assignment — re-installing (and LRU-thrashing)
    its prefix on whatever shard happened to be free, the exact scatter
    sticky routing exists to prevent."""
    return {
        "records": len(homes),
        "homes": [
            [tenant, int(crc), int(shard)]
            for (tenant, crc), shard in homes.items()
        ],
    }


def import_tenant_homes(homes, state: dict, *, shards: int,
                        limit: int = 4096) -> int:
    """Inverse of :func:`export_tenant_homes` into a live OrderedDict;
    assignments pointing past the new plane's shard count are dropped
    (trust the observed world: a smaller restart plane has no shard to
    go home to)."""
    recovered = 0
    for entry in state.get("homes") or ():
        try:
            tenant, crc, shard = entry
            tenant, crc, shard = str(tenant), int(crc), int(shard)
        except (TypeError, ValueError):
            continue
        if not 0 <= shard < shards:
            continue
        homes[(tenant, crc)] = shard
        homes.move_to_end((tenant, crc))
        recovered += 1
        while len(homes) > limit:
            homes.popitem(last=False)
    return recovered


def prefix_pool_key(tenant: str, prefix_ids) -> tuple[str, int]:
    """The pool's entry key: (tenant, content checksum).  A tenant that
    rotates its system prompt gets a fresh entry instead of silently
    decoding against the stale cached KV; crc32 keeps the key
    deterministic across runs (Python's ``hash`` is salted)."""
    import numpy as np

    ids = np.asarray(prefix_ids, np.int32).reshape(-1)
    return (tenant, zlib.crc32(ids.tobytes()))


class PrefixPool:
    """N resident prefix-cache entries per shard, LRU-evicted.

    The device side is one stacked cache buffer per layer entry,
    ``[shards * entries, heads, max_seq_len, head_dim]`` rows (and the
    ``[.., max_seq_len]`` scales of the int8 layout) in the batcher's
    exact cache layout, GPT or llama, so the admission insert can gather
    each request's prefix rows by entry index.  The host side is one
    ``OrderedDict`` per shard mapping an entry key to its local pool slot:
    a **hit** touches the LRU and returns the global row (no forward, no
    transfer); a **miss** prefills the prefix once through the family's
    and the layout's ``prefill_prefix`` (the CUDA flash forward on the
    card) and copies it into the victim's pool row in place, in stream
    order behind every insert that read the row before.

    Entries are keyed by (tenant, prefix checksum), so two tenants with
    byte-identical prefixes still get separate entries: one tenant's
    eviction pressure never revokes another's hit, and nothing decoded
    from one tenant's entry is visible to another tenant's requests.
    """

    def __init__(
        self,
        params: Any,
        config: Any,
        *,
        entries: int,
        prefix_len: int,
        shards: int = 1,
        family: "str | None" = None,
        quantized_kv: bool = False,
        device: Any = "cuda",
        mesh: Any = None,
    ) -> None:
        import torch

        from ..device import resolve_device
        from .family import family_of, rank_layout

        if entries < 1:
            raise ValueError(f"entries={entries} must be >= 1")
        if prefix_len < 1:
            raise ValueError(f"prefix_len={prefix_len} must be >= 1")
        if shards < 1:
            raise ValueError(f"shards={shards} must be >= 1")
        if prefix_len > config.max_seq_len:
            raise ValueError(
                f"prefix_len={prefix_len} exceeds max_seq_len="
                f"{config.max_seq_len}"
            )
        model_family = family_of(config, family)
        self.params = params
        self.config = config
        self.entries = entries
        self.prefix_len = prefix_len
        self.shards = shards
        self.family = model_family.name
        self.quantized_kv = quantized_kv
        # mesh-sharded pool rows: a rank holds its heads over "model" of
        # every entry (the entry axis whole; the reference's
        # layer_shardings), and the install prefill runs at those heads on
        # every data rank
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self._layout = model_family.layout(quantized_kv)
        if mesh is not None:
            from .train import tensor_parallel

            self._layout = rank_layout(self._layout, tensor_parallel(mesh))
        # the install prefill's prompt pass (the flash forward on the card)
        self._attention_fn = model_family.attention_fn_for(
            config, prefix_len, self.device)
        # the stacked device rows, in the batcher's cache layout
        with torch.inference_mode():
            self.layers = self._layout.init_cache(
                config, shards * entries, self.device)["layers"]
        # key -> local slot, per shard, in LRU order (oldest first)
        self._lru: list[OrderedDict] = [
            OrderedDict() for _ in range(shards)
        ]
        # slots handed back by evict_cold, reused lowest-first; fresh
        # slots are minted from _next_slot while any remain (after a cold
        # eviction len(lru) no longer names the next fresh slot, so an
        # install never derives its slot from it: a collision would share
        # one row between two tenants)
        self._free_slots: list[list[int]] = [[] for _ in range(shards)]
        self._next_slot: list[int] = [0] * shards
        # residency ceiling within the allocated rows (set_capacity)
        self.capacity = entries
        self.hits = 0
        self.misses = 0
        self.installs = 0
        self.evictions = 0
        self.events: deque[_PoolEvent] = deque(maxlen=1024)
        # a comms CollectiveScheduler, when attached: each install is
        # recorded as a prefix_install transfer
        self.comms = None

    def resident(self, shard: int, key) -> bool:
        """Residency probe; never touches the LRU."""
        return key in self._lru[shard]

    def resident_keys(self, shard: int) -> list:
        return list(self._lru[shard])

    def _prefill_entry(self, prefix_ids):
        """The one-time prefix prefill (the cost a hit saves), through the
        family's and the layout's ``prefill_prefix``."""
        import torch

        ids = torch.from_numpy(prefix_ids.astype("int64"))
        with torch.inference_mode():
            return self._layout.prefill_prefix(
                self.params, ids.to(self.device), self.config,
                self._attention_fn)

    def _write_entry(self, entry_cache, index: int) -> None:
        """Copy a batch-1 prefix cache into pool row ``index`` in place:
        one indexed copy a layer entry (the counterpart of the
        reference's donated ``dynamic_update_slice``)."""
        import torch

        with torch.inference_mode():
            for pool_layer, entry in zip(self.layers,
                                         entry_cache["layers"]):
                for name, buf in pool_layer.items():
                    buf[index].copy_(entry[name][0])

    def acquire(self, shard: int, key, prefix_ids) -> int:
        """Return the global pool row holding ``key``'s prefix on
        ``shard``, installing (and LRU-evicting) on a miss.  The index
        feeds the admission insert's gather on the device."""
        import numpy as np

        if not 0 <= shard < self.shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.shards})")
        lru = self._lru[shard]
        slot = lru.get(key)
        if slot is not None:
            lru.move_to_end(key)
            self.hits += 1
            return shard * self.entries + slot
        self.misses += 1
        ids = np.asarray(prefix_ids, np.int32).reshape(-1)
        if ids.size != self.prefix_len:
            raise ValueError(
                f"pooled prefixes are a static {self.prefix_len}-token "
                f"bucket; got {ids.size} tokens (the worker prepends "
                "off-bucket prefixes to the prompt instead)"
            )
        if len(lru) >= self.capacity:
            # at the residency ceiling: evict the LRU victim.  Same-batch
            # safety holds because the batcher keeps entries >= its slots
            victim, slot = lru.popitem(last=False)
            self.evictions += 1
            self.events.append(_PoolEvent(
                "prefix-evict", time.perf_counter(),
                {"shard": shard, "tenant": victim[0], "slot": slot},
            ))
        elif self._free_slots[shard]:
            slot = heapq.heappop(self._free_slots[shard])
        else:
            slot = self._next_slot[shard]
            self._next_slot[shard] += 1
        entry = self._prefill_entry(ids)
        self._write_entry(entry, shard * self.entries + slot)
        lru[key] = slot
        self.installs += 1
        self.events.append(_PoolEvent(
            "prefix-install", time.perf_counter(),
            {"shard": shard, "tenant": key[0], "slot": slot},
        ))
        if self.comms is not None and self.comms.enabled:
            from ..comms.ops import PREFIX_INSTALL, array_nbytes

            self.comms.record(
                PREFIX_INSTALL, f"pool:{shard}",
                nbytes=array_nbytes(entry["layers"]),
                args={"shard": shard, "slot": slot},
            )
        return shard * self.entries + slot

    def evict_cold(self, keep: int) -> int:
        """Evict LRU-cold entries down to ``keep`` resident per shard (the
        overload ladder's tier-2 action).  Returns the number evicted;
        idempotent once resident <= keep.  Host bookkeeping only: the rows
        are simply reusable again, and an insert already queued on the
        stream reads them before any later install writes them."""
        if keep < 0:
            raise ValueError(f"keep={keep} must be >= 0")
        evicted = 0
        for shard, lru in enumerate(self._lru):
            while len(lru) > keep:
                victim, slot = lru.popitem(last=False)
                heapq.heappush(self._free_slots[shard], slot)
                self.evictions += 1
                evicted += 1
                self.events.append(_PoolEvent(
                    "prefix-evict", time.perf_counter(),
                    {"shard": shard, "tenant": victim[0], "slot": slot,
                     "reason": "pressure"},
                ))
        return evicted

    def set_capacity(self, capacity: int) -> int:
        """Move the residency ceiling within the allocated rows: shrinking
        evicts LRU-cold entries down to it now (returns how many), growing
        reopens headroom up to the allocation."""
        capacity = int(capacity)
        if not 1 <= capacity <= self.entries:
            raise ValueError(
                f"capacity={capacity} must be in [1, {self.entries}] "
                "(the allocated arena)"
            )
        self.capacity = capacity
        return self.evict_cold(capacity)

    def trace_events(self, time_origin: float | None = None) -> list[dict]:
        """The pool's install and evict decisions as Chrome-trace instant
        events (category ``"prefix"``)."""
        from ..obs.trace import instant_trace_events

        return instant_trace_events(self.events, time_origin)

    def stats(self) -> dict:
        return {
            "entries_per_shard": self.entries,
            "shards": self.shards,
            "prefix_len": self.prefix_len,
            "hits": self.hits,
            "misses": self.misses,
            "installs": self.installs,
            "evictions": self.evictions,
            "resident": [len(lru) for lru in self._lru],
        }
