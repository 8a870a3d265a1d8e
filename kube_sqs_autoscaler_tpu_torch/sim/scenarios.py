"""Time-varying arrival processes for the closed-loop simulator.

The seed simulator modeled one world: a constant arrival rate.  Real
queue-fed fleets see steps (a product launch), ramps (organic growth,
cache warm-up), diurnal cycles (user traffic), and bursts (retry storms,
cron fan-out) — the scenarios the predictive-vs-reactive evaluation in
:mod:`.evaluate` runs head-to-head.

Each process exposes the instantaneous ``rate_at(t)`` and the *exact*
integral ``arrivals_between(t0, t1)``: the simulator integrates arrivals
analytically over each poll interval, so no quadrature error enters the
dynamics at any poll cadence.  One caveat the constant-rate seed world
does not share: the empty-queue floor is applied once per observation
interval, so if the queue empties mid-interval *and* the rate then rises
within that same interval, drain capacity idled while empty is credited
against the later arrivals — depth can be understated by at most one
interval's drain.  (With a constant rate the net rate cannot change sign
inside an interval, so the seed's lump-sum floor is genuinely exact.)

The port's copy of ``kube_sqs_autoscaler_tpu/sim/scenarios.py`` (pure
Python: the same processes, variants and seeded token streams).
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Any, Protocol, Sequence, runtime_checkable


@runtime_checkable
class ArrivalProcess(Protocol):
    """A deterministic message-arrival intensity over simulated time."""

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate (msg/s) at time ``t``."""
        ...

    def arrivals_between(self, t0: float, t1: float) -> float:
        """Exact ``∫ rate dt`` over ``[t0, t1]`` (``t1 >= t0``)."""
        ...


@dataclass(frozen=True)
class ConstantArrival:
    """The seed's world: a flat rate."""

    rate: float

    def rate_at(self, t: float) -> float:
        del t
        return self.rate

    def arrivals_between(self, t0: float, t1: float) -> float:
        return self.rate * (t1 - t0)


@dataclass(frozen=True)
class StepArrival:
    """``before`` msg/s until ``at``, ``after`` msg/s from then on."""

    before: float
    after: float
    at: float

    def rate_at(self, t: float) -> float:
        return self.after if t >= self.at else self.before

    def arrivals_between(self, t0: float, t1: float) -> float:
        if t1 <= self.at:
            return self.before * (t1 - t0)
        if t0 >= self.at:
            return self.after * (t1 - t0)
        return self.before * (self.at - t0) + self.after * (t1 - self.at)


@dataclass(frozen=True)
class RampArrival:
    """Linear ramp from ``start_rate`` at ``t_start`` to ``end_rate`` at
    ``t_end``; clamped flat outside the ramp."""

    start_rate: float
    end_rate: float
    t_start: float
    t_end: float

    def __post_init__(self):
        if self.t_end <= self.t_start:
            raise ValueError("t_end must be > t_start")

    def rate_at(self, t: float) -> float:
        if t <= self.t_start:
            return self.start_rate
        if t >= self.t_end:
            return self.end_rate
        frac = (t - self.t_start) / (self.t_end - self.t_start)
        return self.start_rate + frac * (self.end_rate - self.start_rate)

    def arrivals_between(self, t0: float, t1: float) -> float:
        # Piecewise: flat | linear | flat.  The linear segment integrates
        # exactly as the trapezoid of its endpoint rates.
        total = 0.0
        if t0 < self.t_start:
            flat_end = min(t1, self.t_start)
            total += self.start_rate * (flat_end - t0)
            t0 = flat_end
        if t0 < min(t1, self.t_end):
            seg_end = min(t1, self.t_end)
            total += 0.5 * (self.rate_at(t0) + self.rate_at(seg_end)) * (
                seg_end - t0
            )
            t0 = seg_end
        if t0 < t1:
            total += self.end_rate * (t1 - t0)
        return total


@dataclass(frozen=True)
class DiurnalArrival:
    """Sinusoidal daily cycle: ``base + amplitude·sin(2π(t−phase)/period)``.

    Requires ``amplitude <= base`` so the rate never clips at zero and the
    closed-form integral is exact everywhere.
    """

    base: float
    amplitude: float
    period: float
    phase: float = 0.0

    def __post_init__(self):
        if self.period <= 0:
            raise ValueError("period must be positive")
        if self.amplitude > self.base:
            raise ValueError(
                "amplitude must be <= base (rate would clip at zero and the"
                " analytic integral would be wrong)"
            )

    def _omega(self) -> float:
        return 2.0 * math.pi / self.period

    def rate_at(self, t: float) -> float:
        return self.base + self.amplitude * math.sin(self._omega() * (t - self.phase))

    def arrivals_between(self, t0: float, t1: float) -> float:
        w = self._omega()
        return self.base * (t1 - t0) + (self.amplitude / w) * (
            math.cos(w * (t0 - self.phase)) - math.cos(w * (t1 - self.phase))
        )


@dataclass(frozen=True)
class BurstArrival:
    """Rectangular bursts: ``burst_rate`` for ``burst_len`` seconds at the
    start of every ``period``, ``base`` in between."""

    base: float
    burst_rate: float
    period: float
    burst_len: float
    first_burst: float = 0.0

    def __post_init__(self):
        if not 0 < self.burst_len <= self.period:
            raise ValueError("need 0 < burst_len <= period")

    def _in_burst(self, t: float) -> bool:
        if t < self.first_burst:
            return False
        return (t - self.first_burst) % self.period < self.burst_len

    def rate_at(self, t: float) -> float:
        return self.burst_rate if self._in_burst(t) else self.base

    def arrivals_between(self, t0: float, t1: float) -> float:
        # base everywhere + the burst surplus over every overlapped window.
        total = self.base * (t1 - t0)
        surplus = self.burst_rate - self.base
        k = max(0, math.floor((t0 - self.first_burst) / self.period))
        burst_start = self.first_burst + k * self.period
        while burst_start < t1:
            overlap = min(t1, burst_start + self.burst_len) - max(t0, burst_start)
            if overlap > 0:
                total += surplus * overlap
            burst_start += self.period
        return total


@dataclass(frozen=True)
class PulseArrival:
    """A one-shot rectangular surge: ``rate`` msg/s on ``[start, start +
    width)``, zero outside — the flash-crowd primitive.  On its own it is
    a degenerate world (nothing before or after the pulse); composed over
    a base process via :class:`ComposedArrival` it is a product launch /
    retry storm landing on organic traffic."""

    rate: float
    start: float
    width: float

    def __post_init__(self):
        if self.width <= 0:
            raise ValueError("width must be positive")
        if self.rate < 0:
            raise ValueError("rate must be >= 0")

    def rate_at(self, t: float) -> float:
        return self.rate if self.start <= t < self.start + self.width else 0.0

    def arrivals_between(self, t0: float, t1: float) -> float:
        overlap = min(t1, self.start + self.width) - max(t0, self.start)
        return self.rate * max(0.0, overlap)


@dataclass(frozen=True)
class ComposedArrival:
    """The sum of component processes — arbitrary shapes stack (base +
    pulse, diurnal + bursts, ...).  Exact by construction: the integral
    of a sum is the sum of the component integrals, each of which is
    already exact."""

    parts: "tuple[ArrivalProcess, ...]"

    def __post_init__(self):
        if not self.parts:
            raise ValueError("ComposedArrival needs at least one part")

    def rate_at(self, t: float) -> float:
        return sum(p.rate_at(t) for p in self.parts)

    def arrivals_between(self, t0: float, t1: float) -> float:
        return sum(p.arrivals_between(t0, t1) for p in self.parts)


@dataclass(frozen=True)
class RegimeSwitchArrival:
    """Piecewise regimes: ``regimes[i] = (start_i, process_i)`` with
    ``process_i`` active on ``[start_i, start_{i+1})`` (the last regime
    runs forever).  Each regime's process is evaluated on its LOCAL
    clock ``t - start_i`` — a burst regime restarts its burst phase at
    the switch instant, which is what "the workload changed character"
    means.  The integral splits exactly at the boundaries, so the shape
    stays quadrature-free like every other process here."""

    regimes: "tuple[tuple[float, ArrivalProcess], ...]"

    def __post_init__(self):
        if not self.regimes:
            raise ValueError("RegimeSwitchArrival needs at least one regime")
        starts = [s for s, _ in self.regimes]
        if starts[0] != 0.0:
            raise ValueError("the first regime must start at t=0")
        if any(b <= a for a, b in zip(starts, starts[1:])):
            raise ValueError("regime starts must be strictly increasing")

    def _spans(self) -> "list[tuple[float, float, ArrivalProcess]]":
        starts = [s for s, _ in self.regimes]
        ends = starts[1:] + [math.inf]
        return [
            (s, e, p) for (s, p), e in zip(self.regimes, ends)
        ]

    def rate_at(self, t: float) -> float:
        for start, end, process in self._spans():
            if start <= t < end:
                return process.rate_at(t - start)
        # t before 0: the first regime's local clock extends backwards
        start, _, process = self._spans()[0]
        return process.rate_at(t - start)

    def arrivals_between(self, t0: float, t1: float) -> float:
        total = 0.0
        for start, end, process in self._spans():
            a, b = max(t0, start), min(t1, end)
            if b > a:
                total += process.arrivals_between(a - start, b - start)
        return total


def heavy_tail_lengths(
    tag: str, n: int, lo: int, hi: int, alpha: float = 1.2
) -> "list[int]":
    """``n`` integer lengths from a bounded-Pareto tail on ``[lo, hi]``.

    ``P(L >= k) ∝ k^-alpha``: most draws sit near ``lo``, a deterministic
    rare few reach toward ``hi`` — the prompt/output-length shape real
    serving traffic has and uniform budgets hide.  Seeded with sha256 of
    ``tag`` (the :func:`seeded_token_ids` convention), so a (tag, n, lo,
    hi, alpha) tuple always draws the identical sequence on any host —
    the serving twin and the real plane consume the SAME concrete
    integers, never "the same distribution"."""
    if not 1 <= lo <= hi:
        raise ValueError(f"need 1 <= lo <= hi, got lo={lo} hi={hi}")
    if alpha <= 0:
        raise ValueError(f"alpha={alpha} must be > 0")
    digest = hashlib.sha256(f"lengths:{tag}".encode()).digest()
    rng = random.Random(int.from_bytes(digest[:8], "big"))
    ratio = (lo / hi) ** alpha
    out = []
    for _ in range(n):
        u = rng.random()
        # inverse CDF of the bounded Pareto(alpha) on [lo, hi]
        x = lo / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)
        out.append(max(lo, min(hi, int(x))))
    return out


def as_process(arrival: "float | int | ArrivalProcess") -> ArrivalProcess:
    """Coerce a plain number (the seed's config style) to a process."""
    if isinstance(arrival, (int, float)):
        return ConstantArrival(float(arrival))
    return arrival


# ---------------------------------------------------------------------------
# Seeded scenario variants: principled train-vs-held-out splits.
# ---------------------------------------------------------------------------
#
# A policy tuned against the exact battery worlds (sweep winners, learned
# policies) must be scored on worlds it did NOT see, or the score is just
# memorization.  Variants jitter each arrival shape's parameters —
# rates, step instants, ramp slopes, diurnal phases, burst timings —
# within declared multiplicative bounds, seeded so a (seed, name, index)
# triple always produces the same world on any host/process (the seed is
# hashed with sha256, never Python's per-process ``hash``).  Every
# variant is an instance of the same analytic process class, so
# ``arrivals_between`` stays the *exact* integral of ``rate_at`` by
# construction — the property the simulators lean on.


def _variant_rng(seed: int, name: str, index: int) -> random.Random:
    """Process-stable RNG for one variant (sha256, not ``hash``)."""
    digest = hashlib.sha256(f"{seed}:{name}:{index}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def variant_bounds(
    process: ArrivalProcess, jitter: float = 0.2
) -> dict[str, tuple[float, float]]:
    """Declared per-parameter bounds a variant of ``process`` must obey.

    Multiplicative ``×(1 ± jitter)`` on every rate and timing parameter,
    except the diurnal ``phase`` which redraws uniformly over one (jittered)
    period — a phase shift is the whole point of a diurnal variant.  The
    generator additionally enforces each class's own validity invariants
    (``amplitude <= base``, ``0 < burst_len <= period``) by clamping
    *within* these bounds, so ``variant_bounds`` is the complete contract
    the property tests check.
    """
    lo, hi = 1.0 - jitter, 1.0 + jitter

    def band(value: float) -> tuple[float, float]:
        return (value * lo, value * hi)

    if isinstance(process, ConstantArrival):
        return {"rate": band(process.rate)}
    if isinstance(process, StepArrival):
        return {
            "before": band(process.before),
            "after": band(process.after),
            "at": band(process.at),
        }
    if isinstance(process, RampArrival):
        ramp_len = process.t_end - process.t_start
        return {
            "start_rate": band(process.start_rate),
            "end_rate": band(process.end_rate),
            "t_start": band(process.t_start),
            # the *slope* jitters through the ramp duration: t_end moves
            # with t_start plus a jittered length
            "ramp_len": band(ramp_len),
        }
    if isinstance(process, DiurnalArrival):
        return {
            "base": band(process.base),
            "amplitude": band(process.amplitude),
            "period": band(process.period),
            "phase": (0.0, process.period * hi),
        }
    if isinstance(process, BurstArrival):
        return {
            "base": band(process.base),
            "burst_rate": band(process.burst_rate),
            "period": band(process.period),
            "burst_len": band(process.burst_len),
            "first_burst": band(process.first_burst),
        }
    if isinstance(process, PulseArrival):
        return {
            "rate": band(process.rate),
            "start": band(process.start),
            "width": band(process.width),
        }
    if isinstance(process, ComposedArrival):
        # composite shapes declare bounds per part; the generator
        # recurses with a per-part name so sibling parts draw
        # independent jitters
        bounds: dict[str, tuple[float, float]] = {}
        for i, part in enumerate(process.parts):
            for key, value in variant_bounds(part, jitter).items():
                bounds[f"part{i}.{key}"] = value
        return bounds
    if isinstance(process, RegimeSwitchArrival):
        bounds = {}
        for i, (start, part) in enumerate(process.regimes):
            if i > 0:  # the first regime's start is pinned at 0
                bounds[f"regime{i}.start"] = band(start)
            for key, value in variant_bounds(part, jitter).items():
                bounds[f"regime{i}.{key}"] = value
        return bounds
    raise TypeError(
        f"no variant rule for arrival process {type(process).__name__}"
    )


def arrival_variant(
    process: "float | int | ArrivalProcess",
    seed: int,
    name: str,
    index: int,
    jitter: float = 0.2,
) -> ArrivalProcess:
    """One seeded variant of ``process`` within :func:`variant_bounds`."""
    process = as_process(process)
    rng = _variant_rng(seed, name, index)
    bounds = variant_bounds(process, jitter)

    def draw(key: str) -> float:
        lo, hi = bounds[key]
        return rng.uniform(lo, hi)

    if isinstance(process, ConstantArrival):
        return ConstantArrival(rate=draw("rate"))
    if isinstance(process, StepArrival):
        return StepArrival(
            before=draw("before"), after=draw("after"), at=draw("at")
        )
    if isinstance(process, RampArrival):
        t_start = draw("t_start")
        return RampArrival(
            start_rate=draw("start_rate"),
            end_rate=draw("end_rate"),
            t_start=t_start,
            t_end=t_start + max(draw("ramp_len"), 1e-6),
        )
    if isinstance(process, DiurnalArrival):
        base = draw("base")
        period = draw("period")
        return DiurnalArrival(
            base=base,
            # amplitude <= base keeps the closed-form integral exact
            # (class invariant); the clamp stays inside the declared band
            # because amplitude's lower bound is below base's
            amplitude=min(draw("amplitude"), base),
            period=period,
            phase=rng.uniform(0.0, period),
        )
    if isinstance(process, BurstArrival):
        period = draw("period")
        return BurstArrival(
            base=draw("base"),
            burst_rate=draw("burst_rate"),
            period=period,
            burst_len=min(draw("burst_len"), period),
            first_burst=draw("first_burst"),
        )
    if isinstance(process, PulseArrival):
        return PulseArrival(
            rate=draw("rate"),
            start=draw("start"),
            width=max(draw("width"), 1e-6),
        )
    if isinstance(process, ComposedArrival):
        return ComposedArrival(
            parts=tuple(
                arrival_variant(part, seed, f"{name}#p{i}", index, jitter)
                for i, part in enumerate(process.parts)
            )
        )
    if isinstance(process, RegimeSwitchArrival):
        regimes = []
        prev = -math.inf
        for i, (start, part) in enumerate(process.regimes):
            # the start jitter draws from its OWN key — sharing the
            # part's key would consume the part's first draw and
            # perfectly correlate "when the regime switches" with its
            # first parameter, collapsing the variant space
            rng_i = _variant_rng(seed, f"{name}#r{i}.start", index)
            lo_hi = bounds.get(f"regime{i}.start")
            new_start = 0.0 if i == 0 else rng_i.uniform(*lo_hi)
            # boundaries must stay strictly increasing; clamp within the
            # declared band like the diurnal amplitude clamp
            new_start = max(new_start, prev + 1e-6)
            prev = new_start
            regimes.append(
                (
                    new_start,
                    arrival_variant(part, seed, f"{name}#r{i}", index,
                                    jitter),
                )
            )
        return RegimeSwitchArrival(regimes=tuple(regimes))
    raise TypeError(  # pragma: no cover — variant_bounds rejects first
        f"no variant rule for arrival process {type(process).__name__}"
    )


def scenario_variants(
    scenarios: "Sequence[Any]",
    n_variants: int,
    seed: int,
    jitter: float = 0.2,
) -> "list[Any]":
    """``n_variants`` seeded world-variants of each scenario.

    ``scenarios`` are :class:`~.evaluate.Scenario`-shaped frozen
    dataclasses (anything with ``name`` + ``arrival`` fields); each
    variant keeps every non-arrival field and appends ``~v{i}s{seed}`` to
    the name, so train (one seed) and held-out (another) splits are
    disjoint, reproducible, and self-describing in score rows.
    """
    import dataclasses

    out = []
    for scenario in scenarios:
        for index in range(n_variants):
            out.append(
                dataclasses.replace(
                    scenario,
                    name=f"{scenario.name}~v{index}s{seed}",
                    arrival=arrival_variant(
                        scenario.arrival, seed, scenario.name, index, jitter
                    ),
                )
            )
    return out


# ---------------------------------------------------------------------------
# Multi-tenant serving scenarios: deterministic per-cycle request schedules
# ---------------------------------------------------------------------------
#
# The arrival processes above drive the FLUID autoscaling world (messages
# per second into a depth integral).  The tenant battery instead drives
# the REAL serving engine cycle by cycle, so its schedules are integer
# send counts at exact engine cycles — adversarial shapes (one tenant
# floods, victims must keep their TTFT) stay bit-reproducible without
# any arrival quadrature.


@dataclass(frozen=True)
class TenantTraffic:
    """One tenant's deterministic send schedule within a scenario.

    The tenant sends ``per_cycle`` requests at every cycle ``c`` with
    ``start_cycle <= c < end_cycle`` and ``(c - start_cycle) % every ==
    0`` (``end_cycle=None`` = the scenario's full span).  ``weight`` is
    the DRR share the episode configures for it; ``ttft_slo_s`` its
    TTFT SLO (0 = none); ``flood=True`` marks the adversary the
    isolation gates exclude from the victim set."""

    tenant: str
    weight: float = 1.0
    per_cycle: int = 1
    every: int = 1
    start_cycle: int = 0
    end_cycle: "int | None" = None
    ttft_slo_s: float = 0.0
    flood: bool = False

    def __post_init__(self) -> None:
        if self.per_cycle < 0:
            raise ValueError("per_cycle must be >= 0")
        if self.every < 1:
            raise ValueError("every must be >= 1")
        if self.start_cycle < 0:
            raise ValueError("start_cycle must be >= 0")
        if self.end_cycle is not None and self.end_cycle < self.start_cycle:
            raise ValueError("end_cycle must be >= start_cycle")

    def sends_at(self, cycle: int, span: int) -> int:
        """Requests this tenant sends at engine cycle ``cycle`` of a
        ``span``-cycle schedule."""
        end = span if self.end_cycle is None else min(self.end_cycle, span)
        if not self.start_cycle <= cycle < end:
            return 0
        if (cycle - self.start_cycle) % self.every:
            return 0
        return self.per_cycle


@dataclass(frozen=True)
class TenantScenario:
    """A named multi-tenant traffic shape over ``cycles`` engine cycles."""

    name: str
    cycles: int
    traffics: "tuple[TenantTraffic, ...]"
    description: str = ""

    def __post_init__(self) -> None:
        if self.cycles < 1:
            raise ValueError("cycles must be >= 1")
        names = [t.tenant for t in self.traffics]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenants in scenario {self.name}")

    @property
    def tenants(self) -> "tuple[str, ...]":
        return tuple(t.tenant for t in self.traffics)

    @property
    def victims(self) -> "tuple[str, ...]":
        return tuple(t.tenant for t in self.traffics if not t.flood)

    def total_requests(self) -> int:
        return sum(
            t.sends_at(c, self.cycles)
            for t in self.traffics
            for c in range(self.cycles)
        )

    def schedule(self) -> "list[list[tuple[str, int]]]":
        """``schedule()[c]`` = this cycle's ``(tenant, send_count)``
        pairs in declared tenant order — the bench interleaves these
        sends with real engine cycles."""
        return [
            [
                (t.tenant, t.sends_at(c, self.cycles))
                for t in self.traffics
                if t.sends_at(c, self.cycles)
            ]
            for c in range(self.cycles)
        ]


def seeded_token_ids(tag: str, n: int, vocab: int) -> "list[int]":
    """``n`` token ids drawn from a sha256-of-``tag``-seeded stream —
    the one seeding convention every deterministic token stream in the
    tenant battery uses (prefixes here, per-request suffixes in the
    bench), so the two can never silently desynchronize."""
    digest = hashlib.sha256(tag.encode()).digest()
    rng = random.Random(int.from_bytes(digest[:8], "big"))
    return [rng.randrange(1, max(2, vocab)) for _ in range(n)]


def tenant_prefix_ids(
    tenant: str, prefix_len: int, vocab: int, seed: int = 0
) -> "list[int]":
    """The tenant's shared prompt prefix: ``prefix_len`` token ids drawn
    from a hash-seeded stream, so every (tenant, seed) pair gets a
    distinct, reproducible prefix without any shared RNG state."""
    return seeded_token_ids(
        f"tenant-prefix:{tenant}:{seed}", prefix_len, vocab
    )


def flood_scenario(
    *, victims: int = 2, cycles: int = 40, flood_start: int = 4,
    flood_cycles: int = 8, flood_per_cycle: int = 8,
) -> TenantScenario:
    """One adversary floods a burst while victims trickle steadily —
    the isolation shape: with FIFO admission every victim request
    arriving during (or after) the burst waits behind the whole flood
    backlog; with DRR each refill still hands the victims their share."""
    traffics = [
        TenantTraffic(
            tenant="flood", weight=1.0, per_cycle=flood_per_cycle,
            start_cycle=flood_start,
            end_cycle=flood_start + flood_cycles, flood=True,
        )
    ]
    for v in range(victims):
        traffics.append(
            TenantTraffic(tenant=f"victim{v}", weight=1.0, per_cycle=1,
                          every=4, start_cycle=v)
        )
    return TenantScenario(
        name="flood-isolation", cycles=cycles, traffics=tuple(traffics),
        description=(
            "one tenant bursts %d req/cycle for %d cycles; %d victims "
            "send 1 req every 4 cycles throughout"
            % (flood_per_cycle, flood_cycles, victims)
        ),
    )


def prefix_share_scenario(
    *, tenants: int = 6, cycles: int = 48, every: int = 2,
) -> TenantScenario:
    """Many tenants, each reusing its own shared prefix — the locality
    shape the sticky-vs-freest routing comparison runs on: more tenants
    than one shard's pool entries, so scattered routing re-installs and
    LRU-thrashes prefixes that sticky routing keeps resident."""
    return TenantScenario(
        name="prefix-share", cycles=cycles,
        traffics=tuple(
            TenantTraffic(tenant=f"tenant{i}", per_cycle=1, every=every,
                          start_cycle=i % every)
            for i in range(tenants)
        ),
        description=(
            "%d prefix-sharing tenants, 1 req each every %d cycles"
            % (tenants, every)
        ),
    )


def default_tenant_battery() -> "list[TenantScenario]":
    """The adversarial-tenant battery ``bench.py --suite tenants``
    scores: flood isolation plus the prefix-sharing locality shape
    (the no-flood control is derived from the flood scenario by
    dropping its flood traffic — see the bench)."""
    return [flood_scenario(), prefix_share_scenario()]


def coordinated_flood_scenario(
    *, floods: int = 4, victims: int = 2, flood_per_cycle: int = 3,
    flood_start: int = 4, flood_cycles: int = 10,
    victim_every: int = 3, slo_s: float = 0.35,
    cycles: "int | None" = None,
) -> TenantScenario:
    """``floods`` distinct adversaries burst the SAME window — the
    shape pure DRR handles worst: fairness splits capacity evenly over
    the whole flood coalition, so each victim's share shrinks to
    ``1/(floods+victims)`` while every flooder individually looks
    legitimate.  Victims carry TTFT SLOs; the deadline-aware plane must
    keep their p99/time-over-SLO strictly better than pure DRR."""
    if cycles is None:
        cycles = flood_start + flood_cycles + 14
    traffics = [
        TenantTraffic(
            tenant=f"flood{f}", per_cycle=flood_per_cycle,
            start_cycle=flood_start,
            end_cycle=flood_start + flood_cycles, flood=True,
        )
        for f in range(floods)
    ]
    traffics += [
        TenantTraffic(tenant=f"victim{v}", per_cycle=1,
                      every=victim_every, start_cycle=v,
                      ttft_slo_s=slo_s)
        for v in range(victims)
    ]
    return TenantScenario(
        name="coordinated-flood", cycles=cycles,
        traffics=tuple(traffics),
        description=(
            "%d tenants flood %d req/cycle each for %d cycles in the "
            "same window; %d SLO victims send 1 req every %d cycles"
            % (floods, flood_per_cycle, flood_cycles, victims,
               victim_every)
        ),
    )


def zipf_scenario(
    *, tenants: int = 2000, heads: int = 2, head_per_cycle: int = 3,
    victims: int = 2, victim_every: int = 3, slo_s: float = 0.4,
    s: float = 1.0, cycles: int = 40, tail_keep: int = 5,
) -> TenantScenario:
    """Zipf-distributed traffic over a large open tenant population.

    Rank-``k`` of the ``tenants`` background tenants sends one request
    every ``ceil((k+1)**s)`` cycles — the classic 1/k rate curve, so a
    handful of head tenants dominate volume while a long tail of
    mostly-one-shot tenants churns the scheduler's registration state
    (they arrive unregistered, weight 1.0, and are pruned when
    drained).  The ``heads`` heaviest ranks send ``head_per_cycle``
    every cycle and are marked as the flood (the attack IS the zipf
    head); ``victims`` registered SLO tenants trickle throughout.
    ``tail_keep`` thins the one-shot deep tail to a deterministic
    1-in-``tail_keep`` (5 = the historical default; the admission-
    scale battery raises it so a 100k–1M population keeps a few
    thousand actual senders instead of tens of thousands)."""
    if tenants < heads:
        raise ValueError("tenants must be >= heads")
    if tail_keep < 1:
        raise ValueError(f"tail_keep={tail_keep} must be >= 1")
    traffics = []
    for k in range(tenants):
        if k < heads:
            traffics.append(TenantTraffic(
                tenant=f"z{k}", per_cycle=head_per_cycle, flood=True,
            ))
            continue
        every = min(cycles, max(1, math.ceil((k + 1) ** s)))
        if every >= cycles and k % tail_keep:
            # deep-tail thinning: keep a deterministic 1-in-tail_keep
            # of the one-shot tail so a huge tenant population does
            # not mean that many requests all landing at once
            continue
        traffics.append(TenantTraffic(
            tenant=f"z{k}", per_cycle=1, every=every,
            start_cycle=k % max(1, min(cycles, every)),
        ))
    traffics += [
        TenantTraffic(tenant=f"victim{v}", per_cycle=1,
                      every=victim_every, start_cycle=v,
                      ttft_slo_s=slo_s)
        for v in range(victims)
    ]
    return TenantScenario(
        name="zipf", cycles=cycles, traffics=tuple(traffics),
        description=(
            "%d-tenant zipf(s=%g) population, %d flooding head(s) at "
            "%d req/cycle, %d SLO victims"
            % (tenants, s, heads, head_per_cycle, victims)
        ),
    )


def flash_crowd_scenario(
    *, crowd: int = 1600, crowd_start: int = 6, crowd_span: int = 4,
    victims: int = 2, victim_every: int = 3, slo_s: float = 0.4,
    cycles: "int | None" = None,
) -> TenantScenario:
    """Tenant-population churn at its sharpest: ``crowd`` NEVER-seen
    tenants each send exactly one request inside a ``crowd_span``-cycle
    window (a product launch / retry storm), then vanish.  Stresses
    the open-population paths — unregistered staging, DRR registration
    churn and pruning, label-cardinality bounds — while the registered
    SLO victims must keep their TTFT through the stampede."""
    if cycles is None:
        cycles = crowd_start + crowd_span + 18
    traffics = [
        TenantTraffic(
            tenant=f"crowd{i}", per_cycle=1,
            start_cycle=crowd_start + (i % crowd_span),
            end_cycle=crowd_start + (i % crowd_span) + 1,
            flood=True,
        )
        for i in range(crowd)
    ]
    traffics += [
        TenantTraffic(tenant=f"victim{v}", per_cycle=1,
                      every=victim_every, start_cycle=v,
                      ttft_slo_s=slo_s)
        for v in range(victims)
    ]
    return TenantScenario(
        name="flash-crowd", cycles=cycles, traffics=tuple(traffics),
        description=(
            "%d one-shot tenants stampede over %d cycles from cycle "
            "%d; %d SLO victims trickle throughout"
            % (crowd, crowd_span, crowd_start, victims)
        ),
    )


def overload_battery(
    *, scale: float = 1.0,
) -> "list[TenantScenario]":
    """The adversarial overload battery ``bench.py --suite overload``
    scores: a coordinated multi-tenant flood, a
    zipf-population attack with thousands of distinct tenants, and a
    flash crowd.  ``scale`` shrinks the tenant POPULATIONS for the
    tier-1 smoke (1.0 = the full battery); the per-cycle attack
    intensity is deliberately NOT scaled — a smoke whose "flood" fits
    the engine's capacity would never engage the ladder and the
    battery would gate nothing."""
    def pop(value: int, floor: int) -> int:
        return max(floor, int(round(value * scale)))

    return [
        coordinated_flood_scenario(floods=pop(4, 4)),
        zipf_scenario(tenants=pop(2000, 40)),
        flash_crowd_scenario(crowd=pop(1600, 30)),
    ]


def admission_scale_scenario(
    *, tenants: int = 100_000, heads: int = 4, head_per_cycle: int = 4,
    victims: int = 2, victim_every: int = 2, slo_s: float = 0.4,
    cycles: int = 32,
) -> TenantScenario:
    """The sharded-admission stress shape: a 100k+-tenant zipf
    population whose COORDINATED head flood hammers the staging
    plane's O(active tenants) host work while SLO victims trickle —
    the regime where N admission shards beat one (each shard pays only
    its slice of the classifier/decay work, and they run
    concurrently).  The deep tail is thinned to ~``tenants/500``
    actual one-shot senders (deterministically), so the POPULATION
    scales to a million without the request count following it."""
    import dataclasses

    return dataclasses.replace(
        zipf_scenario(
            tenants=tenants, heads=heads,
            head_per_cycle=head_per_cycle, victims=victims,
            victim_every=victim_every, slo_s=slo_s, cycles=cycles,
            tail_keep=max(5, tenants // 500),
        ),
        name=f"admission-zipf-{tenants // 1000}k",
    )


def admission_scale_battery(
    *, scale: float = 1.0,
) -> "list[TenantScenario]":
    """The 100k–1M zipf battery ``bench.py --suite admission-scale``
    scores.  ``scale`` shrinks the tenant POPULATIONS
    for the tier-1 smoke (1.0 = the full battery); the coordinated
    head flood's per-cycle intensity is deliberately NOT scaled — a
    smoke whose flood never pressures the staging plane would gate
    nothing."""
    def pop(value: int, floor: int) -> int:
        return max(floor, int(round(value * scale)))

    return [
        admission_scale_scenario(tenants=pop(100_000, 1_000)),
        admission_scale_scenario(tenants=pop(1_000_000, 4_000)),
    ]


def disagg_scenario(
    *, tenants: int = 2, cycles: int = 36, every: int = 2,
    wave_start: int = 8, wave_cycles: int = 6, wave_per_cycle: int = 4,
) -> TenantScenario:
    """The two-plane shape: steady decode-bound tenants plus a mid-run
    prefill WAVE of fresh arrivals.  On the fused engine every wave
    arrival's ``[M,P]`` prefill serializes with the resident decode
    steps, so steady tenants' tokens stall and the wave's own TTFT
    queues behind decode work; with the planes split, the wave lands on
    prefill replicas while the decode plane gang-steps undisturbed —
    the separation the disagg TTFT gate measures at fixed total
    hardware."""
    traffics = [
        TenantTraffic(tenant=f"steady{i}", per_cycle=1, every=every,
                      start_cycle=i % every)
        for i in range(tenants)
    ]
    traffics.append(TenantTraffic(
        tenant="wave", per_cycle=wave_per_cycle, start_cycle=wave_start,
        end_cycle=wave_start + wave_cycles,
    ))
    return TenantScenario(
        name="disagg-wave", cycles=cycles, traffics=tuple(traffics),
        description=(
            "%d steady tenants send 1 req every %d cycles; a prefill "
            "wave of %d req/cycle runs cycles %d..%d"
            % (tenants, every, wave_per_cycle, wave_start,
               wave_start + wave_cycles)
        ),
    )


def draft_probe_prompts(
    count: int, prompt_len: int, vocab: int, seed: int = 0,
) -> "list[list[int]]":
    """``count`` deterministic candidate prompts for the speculative
    accept-rate probe.  Whether a draft model (the full model's first
    ``k`` layers) agrees with the full model is a property of the
    weights, not the prompt tag — so the bench MEASURES each candidate's
    accept rate on the real seeded model and partitions the pool into
    draft-friendly and draft-hostile halves; this helper only pins the
    candidate stream so the partition is reproducible."""
    return [
        seeded_token_ids(f"draft-probe:{seed}:{i}", prompt_len, vocab)
        for i in range(count)
    ]


def without_flood(scenario: TenantScenario) -> TenantScenario:
    """The scenario's no-flood control: identical victim schedules,
    adversary removed — the baseline the isolation gate compares
    victim TTFT against."""
    import dataclasses

    return dataclasses.replace(
        scenario,
        name=f"{scenario.name}~control",
        traffics=tuple(t for t in scenario.traffics if not t.flood),
    )
