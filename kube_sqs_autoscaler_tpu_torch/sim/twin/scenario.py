"""Serving scenarios: deterministic request scripts on the cycle clock.

A :class:`ServingScenario` describes one world for the serving twin and
the real sharded plane alike: an analytic arrival process sampled into
an *exact* integer per-cycle send schedule (floor-of-cumulative-integral
differences — no quadrature, no RNG), per-request output budgets (fixed
or a seeded bounded-Pareto heavy tail), an optional tenant population
with a per-shard prefix pool, and the autoscaler's gate/cooldown knobs
in queue-depth units.  Both simulators consume the SAME concrete
integers, which is what lets the fidelity gate demand equality rather
than statistics.

The widened arrival shapes (:class:`~..scenarios.ComposedArrival`,
:class:`~..scenarios.RegimeSwitchArrival`,
:class:`~..scenarios.PulseArrival`) plug in here unchanged — the
schedule derivation only needs ``arrivals_between`` to be the exact
integral of ``rate_at``, the property every process in
:mod:`..scenarios` carries by construction.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/twin/scenario.py``
(numpy only).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..scenarios import (
    ArrivalProcess,
    BurstArrival,
    ComposedArrival,
    ConstantArrival,
    PulseArrival,
    RampArrival,
    RegimeSwitchArrival,
    arrival_variant,
    as_process,
    heavy_tail_lengths,
)

#: Shard lifecycle codes inside the twin loop — the
#: :mod:`...fleet.sharded` state machine's integers
#: (INACTIVE/SERVING/DRAINING; QUARANTINED/PROBING are chaos states the
#: twin deliberately does not model).
SHARD_INACTIVE, SHARD_SERVING, SHARD_DRAINING = 0, 1, 2


@dataclass(frozen=True)
class ServingScenario:
    """One serving world: traffic script + plane geometry + gate knobs.

    ``arrival`` is requests/second on the episode's wall clock
    (``cycles × cycle_dt`` seconds long).  ``heavy_tail = (lo, hi,
    alpha)`` switches per-request output budgets from the uniform
    ``generate_tokens`` to a seeded bounded-Pareto draw (admitted
    through the real plane's per-row-budget resume insert).  ``tenants
    > 0`` routes requests round-robin over a tenant population through
    the prefix pool (``pool_entries`` per shard) with sticky routing —
    the tenant-locality shape.
    """

    name: str
    arrival: ArrivalProcess
    cycles: int = 240
    cycle_dt: float = 0.05
    shards: int = 4
    shard_slots: int = 2
    decode_block: int = 2
    min_shards: int = 1
    max_shards: int = 0  # 0 = all shards
    initial_shards: int = 1
    control_every: int = 5  # engine cycles per autoscaler tick
    scale_up_queue: int = 6
    scale_down_queue: int = 1
    up_cooldown_s: float = 0.5
    down_cooldown_s: float = 1.5
    ttft_slo_s: float = 0.25
    generate_tokens: int = 6
    heavy_tail: "tuple[int, int, float] | None" = None
    budget_seed: int = 0
    tenants: int = 0
    pool_entries: int = 0
    prompt_len: int = 4
    description: str = ""

    def __post_init__(self) -> None:
        if self.cycles < 1:
            raise ValueError("cycles must be >= 1")
        if self.cycle_dt <= 0:
            raise ValueError("cycle_dt must be > 0")
        if self.shards < 1 or self.shard_slots < 1:
            raise ValueError("shards and shard_slots must be >= 1")
        if not 1 <= self.min_shards <= self.max_active <= self.shards:
            raise ValueError(
                f"need 1 <= min_shards <= max_shards <= shards, got "
                f"{self.min_shards}/{self.max_active}/{self.shards}"
            )
        if not self.min_shards <= self.initial_shards <= self.max_active:
            raise ValueError("initial_shards out of [min, max] range")
        if self.control_every < 1:
            raise ValueError("control_every must be >= 1")
        if self.decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if self.generate_tokens < 1:
            raise ValueError("generate_tokens must be >= 1")
        if self.heavy_tail is not None:
            lo, hi, alpha = self.heavy_tail
            if not 1 <= lo <= hi <= self.generate_tokens:
                raise ValueError(
                    "heavy_tail budgets must satisfy 1 <= lo <= hi <= "
                    "generate_tokens (the engine's per-row budget cap)"
                )
            if alpha <= 0:
                raise ValueError("heavy_tail alpha must be > 0")
        if self.tenants < 0 or self.pool_entries < 0:
            raise ValueError("tenants and pool_entries must be >= 0")
        if self.pool_entries and not self.tenants:
            raise ValueError("pool_entries needs tenants > 0")
        if self.pool_entries and self.heavy_tail is not None:
            # the real plane's pooled admission path carries a uniform
            # budget (per-request budgets ride the resume insert, which
            # has no pooled variant) — a world combining them would be
            # one the reference runner cannot realize, surfacing as
            # cryptic fidelity divergences instead of this error
            raise ValueError(
                "heavy_tail budgets and a prefix pool cannot combine:"
                " the plane's pooled insert admits at the uniform"
                " generate_tokens budget"
            )
        if self.pool_entries and self.pool_entries < self.shard_slots:
            # the real PrefixPool enforces entries >= per-shard slots
            # (same-batch LRU-eviction corruption guard); the twin
            # mirrors the constraint so its worlds stay realizable
            raise ValueError(
                f"pool_entries={self.pool_entries} must be >= "
                f"shard_slots={self.shard_slots}"
            )

    @property
    def max_active(self) -> int:
        return self.max_shards if self.max_shards else self.shards

    @property
    def slots(self) -> int:
        return self.shards * self.shard_slots

    @property
    def tick_dt(self) -> float:
        """Seconds per autoscaler tick."""
        return self.control_every * self.cycle_dt

    @property
    def duration_s(self) -> float:
        return self.cycles * self.cycle_dt

    def sends(self) -> np.ndarray:
        """Integer requests arriving at each cycle, from the EXACT
        arrival integral: ``sends[c] = floor(F((c+1)·dt)) - floor(F(c·
        dt))`` with ``F(t) = arrivals_between(0, t)``.  Deterministic,
        quadrature-free, and identical however either simulator is
        batched."""
        process = as_process(self.arrival)
        out = np.zeros(self.cycles, np.int32)
        prev = 0
        for c in range(self.cycles):
            cum = math.floor(
                process.arrivals_between(0.0, (c + 1) * self.cycle_dt)
            )
            out[c] = cum - prev
            prev = cum
        return out

    def total_requests(self) -> int:
        return int(self.sends().sum())

    def request_budgets(self, total: "int | None" = None) -> np.ndarray:
        """Per-request output budgets, in arrival (FIFO) order."""
        total = self.total_requests() if total is None else total
        if self.heavy_tail is None:
            return np.full(total, self.generate_tokens, np.int32)
        lo, hi, alpha = self.heavy_tail
        return np.asarray(
            heavy_tail_lengths(
                f"{self.name}:budgets:{self.budget_seed}", total, lo, hi,
                alpha,
            ),
            np.int32,
        )

    def request_tenants(self, total: "int | None" = None) -> np.ndarray:
        """Tenant index per request (round-robin; zeros with tenancy
        off)."""
        total = self.total_requests() if total is None else total
        if self.tenants <= 0:
            return np.zeros(total, np.int32)
        return (np.arange(total, dtype=np.int32)) % np.int32(self.tenants)

    def arrival_cycles(self) -> np.ndarray:
        """Arrival cycle per request, expanded from :meth:`sends`."""
        sends = self.sends()
        return np.repeat(
            np.arange(self.cycles, dtype=np.int32), sends
        ).astype(np.int32)


def twin_variants(
    scenarios: Sequence[ServingScenario],
    n_variants: int,
    seed: int,
    jitter: float = 0.2,
) -> "list[ServingScenario]":
    """Seeded held-out variants: the arrival shape re-drawn inside
    :func:`~..scenarios.variant_bounds` (the new composite shapes
    recurse), the heavy-tail budget stream re-seeded.  Plane geometry
    and gate knobs stay fixed — a variant is the same fleet facing a
    world it never trained on, the same split discipline the fluid
    learn bench uses."""
    out = []
    for scenario in scenarios:
        for index in range(n_variants):
            out.append(
                dataclasses.replace(
                    scenario,
                    name=f"{scenario.name}~v{index}s{seed}",
                    arrival=arrival_variant(
                        scenario.arrival, seed, scenario.name, index,
                        jitter,
                    ),
                    budget_seed=scenario.budget_seed + 1000 * seed + index,
                )
            )
    return out


def default_twin_battery(
    *, cycles: int = 240, cycle_dt: float = 0.05
) -> "list[ServingScenario]":
    """The serving-twin battery: six worlds over one plane geometry.

    Rates are sized against the plane's real capacity (≈0.55 req/cycle
    per serving shard at the default geometry: 2 slots, block 2, budget
    6) so the gates are genuinely exercised — under-provisioned starts,
    overload windows that leave backlog for slow scalers, and calm
    stretches where holding shards down matters.
    """
    common = dict(cycles=cycles, cycle_dt=cycle_dt)
    return [
        ServingScenario(
            name="twin-steady",
            arrival=ConstantArrival(rate=24.0),  # ~1.2 req/cycle
            description="steady load needing ~2-3 shards",
            **common,
        ),
        ServingScenario(
            name="twin-ramp",
            arrival=RampArrival(
                start_rate=6.0, end_rate=44.0,
                t_start=0.1 * cycles * cycle_dt,
                t_end=0.7 * cycles * cycle_dt,
            ),
            description="organic growth from idle to full fleet",
            **common,
        ),
        ServingScenario(
            name="twin-flash-crowd",
            arrival=ComposedArrival(
                parts=(
                    ConstantArrival(rate=9.0),
                    PulseArrival(
                        rate=60.0,
                        start=0.25 * cycles * cycle_dt,
                        width=0.12 * cycles * cycle_dt,
                    ),
                )
            ),
            description="one-shot stampede on organic traffic",
            **common,
        ),
        ServingScenario(
            name="twin-regime-switch",
            arrival=RegimeSwitchArrival(
                regimes=(
                    (0.0, ConstantArrival(rate=8.0)),
                    (
                        0.35 * cycles * cycle_dt,
                        BurstArrival(
                            base=16.0, burst_rate=56.0,
                            period=0.2 * cycles * cycle_dt,
                            burst_len=0.07 * cycles * cycle_dt,
                        ),
                    ),
                    (0.8 * cycles * cycle_dt, ConstantArrival(rate=6.0)),
                )
            ),
            description="calm -> retry-storm regime -> calm",
            **common,
        ),
        ServingScenario(
            name="twin-heavy-tail",
            arrival=ConstantArrival(rate=26.0),
            heavy_tail=(1, 6, 1.1),
            description="bounded-Pareto output lengths, per-row budgets",
            **common,
        ),
        ServingScenario(
            name="twin-prefix-tenants",
            arrival=ConstantArrival(rate=22.0),
            tenants=5,
            pool_entries=2,
            description=(
                "5 tenants round-robin through a 2-entry/shard prefix "
                "pool with sticky routing"
            ),
            **common,
        ),
    ]
