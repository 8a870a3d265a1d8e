"""Head-to-head scenario battery: reactive vs. each forecaster.

Simulator-driven policy evaluation (the KIS-S harness shape,
arxiv 2507.07932): every candidate policy runs the *same* deterministic
world — identical arrival process, service rates, bounds, cadence — and
is scored on the three numbers a queue-serving fleet cares about:

- ``max_depth``      — worst backlog (latency proxy; BLITZSCALE's point
  that scale-up lateness is the dominant serving cost, arxiv 2412.17246);
- ``time_over_slo``  — seconds the observed depth sat above the
  scenario's SLO depth;
- ``replica_changes``— churn (each change is a pod start/stop: image
  pulls, TPU grab/release, cache warm-up).

Used by ``bench.py --suite forecast`` (the ``BENCH_r06`` artifact) and the
acceptance tests; later policies (RL, multi-queue) plug into the same
battery.

The CHAOS battery (:func:`chaos_battery` / :func:`evaluate_chaos`,
``bench.py --suite chaos``) reuses the same machinery with a fourth
input dimension: a deterministic :class:`~.faults.FailureProcess` per
scenario, scoring the resilience layer (``core/resilience.py``) against
the reference's log-and-skip failure handling on identical worlds under
identical faults.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/evaluate.py``; a
predictive row's forecasts run on the ``device`` the caller names (the
card by default).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.loop import LoopConfig
from ..core.policy import PolicyConfig
from ..core.resilience import ResilienceConfig
from .faults import Blackout, FailureProcess, FlakyCalls, LatencySpikes
from .scenarios import (
    ArrivalProcess,
    BurstArrival,
    DiurnalArrival,
    RampArrival,
    StepArrival,
)
from .simulator import SimConfig, Simulation


@dataclass(frozen=True)
class Scenario:
    """One world the battery replays under every candidate policy."""

    name: str
    arrival: ArrivalProcess
    duration: float = 900.0
    service_rate_per_replica: float = 10.0
    min_pods: int = 1
    max_pods: int = 30
    initial_replicas: int = 1
    slo_depth: float = 300.0
    # Forecast horizon (s) predictive policies use on this scenario — a
    # deployment knob matched to the traffic's timescale: ~1 cooldown past
    # the poll period for fast transients, longer for slow cycles (a long
    # horizon on a fast ramp extrapolates the trend past its end and
    # overshoots; a short one on a slow cycle sees the peak too late).
    horizon: float = 60.0
    loop: LoopConfig = field(
        default_factory=lambda: LoopConfig(
            poll_interval=5.0,
            policy=PolicyConfig(
                scale_up_messages=100,
                scale_down_messages=10,
                scale_up_cooldown=10.0,
                scale_down_cooldown=30.0,
            ),
        )
    )
    # Chaos dimension: deterministic fault process injected around the
    # metric source and scaler (None = healthy world, the forecast
    # battery's scenarios).
    faults: FailureProcess | None = None


def default_battery() -> tuple[Scenario, ...]:
    """Step, ramp, diurnal, burst — the four arrival shapes of KIS-S.

    Magnitudes are sized so the default thresholds are genuinely exercised:
    steady-state demand crosses several replicas' capacity and the backlog
    moves through both gates' thresholds within each episode.
    """
    return (
        Scenario(
            name="step",
            # launch day: 20 msg/s overnight, 120 msg/s from t=120 on
            arrival=StepArrival(before=20.0, after=120.0, at=120.0),
        ),
        Scenario(
            name="ramp",
            # organic growth: 10 -> 150 msg/s over 10 minutes, then flat
            arrival=RampArrival(
                start_rate=10.0, end_rate=150.0, t_start=60.0, t_end=660.0
            ),
            horizon=30.0,
        ),
        Scenario(
            name="diurnal",
            # user traffic: 80 +/- 60 msg/s, two full cycles per episode.
            # The fleet starts at steady state for the base load (8 pods at
            # 10 msg/s each): a cold 1-pod start makes every policy's max
            # depth the same cold-start backlog (actuation-rate-limited,
            # one pod per cooldown), hiding the cyclic behavior the
            # scenario exists to score.
            arrival=DiurnalArrival(base=80.0, amplitude=60.0, period=450.0),
            initial_replicas=8,
        ),
        Scenario(
            name="burst",
            # retry storms: 250 msg/s for 45 s every 5 minutes over 25 base
            arrival=BurstArrival(
                base=25.0, burst_rate=250.0, period=300.0,
                burst_len=45.0, first_burst=120.0,
            ),
        ),
    )


def run_episode(
    scenario: Scenario,
    policy: str = "reactive",
    forecaster: str = "holt",
    horizon: float | None = None,
    *,
    device: str = "cuda",
) -> dict:
    """One policy through one scenario; returns the scorecard row.

    ``horizon=None`` uses the scenario's own tuned horizon; ``device`` is
    where a predictive row forecasts.
    """
    horizon = scenario.horizon if horizon is None else horizon
    sim = Simulation(
        SimConfig(
            arrival_rate=scenario.arrival,
            service_rate_per_replica=scenario.service_rate_per_replica,
            duration=scenario.duration,
            initial_replicas=scenario.initial_replicas,
            min_pods=scenario.min_pods,
            max_pods=scenario.max_pods,
            loop=scenario.loop,
            policy=policy,
            forecaster=forecaster,
            forecast_horizon=horizon,
        ),
        device=device,
    )
    result = sim.run()
    return score_result(result, scenario.slo_depth)


def score_result(result, slo_depth: float) -> dict:
    """One :class:`~.simulator.SimResult` as the battery's scorecard row.

    Shared by the live scenario battery and the journal counterfactual
    re-scoring (:mod:`.replay`), so recorded episodes and synthetic
    scenarios are judged on identical numbers.
    """
    return {
        "max_depth": round(result.max_depth, 1),
        "time_over_slo_s": round(result.time_over(slo_depth), 1),
        "replica_changes": result.replica_changes,
        "final_replicas": result.final_replicas,
        "final_depth": round(result.final_depth, 1),
        "ticks": result.ticks,
    }


def evaluate_battery(
    scenarios: tuple[Scenario, ...] | None = None,
    forecasters: tuple[str, ...] = ("ewma", "holt", "lstsq"),
    horizon: float | None = None,
    *,
    device: str = "cuda",
) -> dict:
    """Every scenario × (reactive + each forecaster) → nested scorecard."""
    scenarios = scenarios if scenarios is not None else default_battery()
    report: dict = {}
    for scenario in scenarios:
        row: dict = {"reactive": run_episode(scenario, policy="reactive")}
        for name in forecasters:
            row[f"predictive:{name}"] = run_episode(
                scenario, policy="predictive", forecaster=name,
                horizon=horizon, device=device,
            )
        report[scenario.name] = row
    return report


def summarize(
    report: dict,
    target_scenarios: tuple[str, ...] = ("ramp", "diurnal"),
    churn_budget: float = 1.25,
) -> dict:
    """Pick the winning forecaster and spell out the acceptance deltas.

    The winner is the forecaster with the lowest summed ``max_depth`` over
    ``target_scenarios`` among those whose churn stays within
    ``churn_budget`` × reactive on every target scenario; ties break to
    the lower total churn.
    """
    candidates: dict[str, dict] = {}
    names = [k for k in next(iter(report.values())) if k != "reactive"]
    for name in names:
        depth_total = 0.0
        churn_ok = True
        churn_total = 0
        deltas = {}
        for scen in target_scenarios:
            reactive = report[scen]["reactive"]
            predictive = report[scen][name]
            depth_total += predictive["max_depth"]
            churn_total += predictive["replica_changes"]
            # a churn-free reactive baseline leaves any churn over budget
            allowed = churn_budget * max(reactive["replica_changes"], 1)
            if predictive["replica_changes"] > allowed:
                churn_ok = False
            deltas[scen] = {
                "max_depth_reduction": round(
                    reactive["max_depth"] - predictive["max_depth"], 1
                ),
                "churn_delta": (
                    predictive["replica_changes"] - reactive["replica_changes"]
                ),
            }
        candidates[name] = {
            "depth_total": depth_total,
            "churn_total": churn_total,
            "within_churn_budget": churn_ok,
            "deltas": deltas,
        }
    eligible = {n: c for n, c in candidates.items() if c["within_churn_budget"]}
    pool = eligible or candidates
    winner = min(pool, key=lambda n: (pool[n]["depth_total"], pool[n]["churn_total"]))
    return {
        "winner": winner,
        "target_scenarios": list(target_scenarios),
        "churn_budget": churn_budget,
        "candidates": candidates,
    }


# ---------------------------------------------------------------------------
# Chaos battery: the resilience layer vs. reference failure handling.
# ---------------------------------------------------------------------------


def default_resilience() -> ResilienceConfig:
    """The battery's resilient configuration.

    Retries absorb per-call flakiness, the stale hold bridges metric
    blackouts (TTL sized to the battery's longest outage), the breaker
    stops paying a dead API server's latency after 3 straight failures.
    Timeouts stay off: the post-hoc deadline would convert the latency
    scenario's *slow successes* into failures — strictly worse than
    using the data (the deadline knob is for real RPC stacks where slow
    usually means doomed, and is covered by unit tests).
    """
    return ResilienceConfig(
        metric_retries=2,
        scaler_retries=1,
        breaker_failures=3,
        breaker_reset=30.0,
        stale_depth_ttl=300.0,
    )


def chaos_battery() -> tuple[Scenario, ...]:
    """Five worlds: one healthy control + four fault shapes.

    Every fault window opens *after* the demand shift has pushed the
    observed depth through the scale-up threshold, so the stale hold has
    a meaningful observation to bridge with — the incident shape that
    matters (an outage during quiet hours strands nothing).
    """
    return (
        Scenario(
            name="calm",
            # the no-fault control: any resilient-vs-reference difference
            # here is a regression by definition
            arrival=StepArrival(before=20.0, after=120.0, at=120.0),
        ),
        Scenario(
            name="metric-blackout",
            # monitoring dies for 5 minutes in the middle of a launch
            # ramp: reference freezes scaling; the stale hold keeps
            # climbing toward the last observed backlog
            arrival=StepArrival(before=20.0, after=120.0, at=120.0),
            faults=Blackout(start=150.0, duration=300.0, metric=True),
        ),
        Scenario(
            name="flaky-metric",
            # 35% of polls fail all episode long during organic growth:
            # reference loses a third of its decisions, retries recover
            # nearly all of them
            arrival=RampArrival(
                start_rate=10.0, end_rate=150.0, t_start=60.0, t_end=660.0
            ),
            faults=FlakyCalls(failure_rate=0.35, seed=7, metric=True),
        ),
        Scenario(
            name="actuation-outage",
            # the apiserver is down AND slow (3 s per failing call) while
            # demand steps up: reference pays the latency on every fire
            # attempt; the breaker stops paying after 3
            arrival=StepArrival(before=20.0, after=120.0, at=120.0),
            faults=Blackout(
                start=150.0, duration=250.0, metric=False, scale=True,
                latency=3.0,
            ),
        ),
        Scenario(
            name="latency-spikes",
            # a slow-but-healthy dependency: polls succeed after 2.5 s
            # inside periodic windows — both configurations should ride
            # it out identically (no timeouts in default_resilience)
            arrival=StepArrival(before=20.0, after=120.0, at=120.0),
            faults=LatencySpikes(
                period=120.0, spike_len=30.0, delay=2.5, metric=True
            ),
        ),
    )


class _ChaosCounters:
    """TickObserver tallying the resilience layer's per-tick evidence."""

    def __init__(self) -> None:
        self.metric_failures = 0  # fail-static ticks (no depth at all)
        self.stale_ticks = 0  # degraded-mode depth holds
        self.retries = 0  # extra attempts, metric + scaler
        self.breaker_open_ticks = 0  # ticks ending with the breaker open

    def on_tick(self, record) -> None:
        if record.metric_error is not None:
            self.metric_failures += 1
        if record.stale:
            self.stale_ticks += 1
        self.retries += (record.metric_retries or 0) + (
            record.scaler_retries or 0
        )
        if record.breaker_state == "open":
            self.breaker_open_ticks += 1

    def as_dict(self) -> dict:
        return {
            "fail_static_ticks": self.metric_failures,
            "stale_ticks": self.stale_ticks,
            "retries": self.retries,
            "breaker_open_ticks": self.breaker_open_ticks,
        }


def run_chaos_episode(
    scenario: Scenario,
    resilience: ResilienceConfig | None = None,
) -> dict:
    """One (world × faults × failure-handling) episode → scorecard row.

    ``resilience=None`` is the reference configuration (log-and-skip);
    the row carries the battery scores plus the chaos counters so the
    artifact shows *why* a configuration scored as it did.
    """
    counters = _ChaosCounters()
    sim = Simulation(
        SimConfig(
            arrival_rate=scenario.arrival,
            service_rate_per_replica=scenario.service_rate_per_replica,
            duration=scenario.duration,
            initial_replicas=scenario.initial_replicas,
            min_pods=scenario.min_pods,
            max_pods=scenario.max_pods,
            loop=scenario.loop,
            faults=scenario.faults,
            resilience=resilience,
        ),
        extra_observers=(counters,),
    )
    result = sim.run()
    row = score_result(result, scenario.slo_depth)
    row.update(counters.as_dict())
    # fault provenance rides the row so summarize_chaos can tell control
    # scenarios from outage scenarios without trusting names
    row["faulted"] = scenario.faults is not None
    return row


def evaluate_chaos(
    scenarios: tuple[Scenario, ...] | None = None,
    resilience: ResilienceConfig | None = None,
) -> dict:
    """Every chaos scenario × {reference, resilient} → nested scorecard."""
    scenarios = scenarios if scenarios is not None else chaos_battery()
    resilience = resilience if resilience is not None else default_resilience()
    report: dict = {}
    for scenario in scenarios:
        report[scenario.name] = {
            "reference": run_chaos_episode(scenario, resilience=None),
            "resilient": run_chaos_episode(scenario, resilience=resilience),
        }
    return report


def summarize_chaos(
    report: dict,
    no_fault_scenarios: tuple[str, ...] | None = None,
) -> dict:
    """Deltas + the two acceptance verdicts.

    ``resilient_wins`` lists fault scenarios where the resilient
    configuration strictly improved max depth or time-over-SLO;
    ``no_fault_regressions`` lists control scenarios where it changed
    *anything* (on a healthy world the resilience layer must be
    invisible: identical decisions, identical scores).  Control
    scenarios are identified by the rows' recorded fault provenance
    (``faulted``, set by :func:`run_chaos_episode`), not by name, so a
    custom battery's healthy scenarios can never be mis-scored as
    resilience wins; ``no_fault_scenarios`` overrides the derivation.
    """
    if no_fault_scenarios is None:
        no_fault_scenarios = tuple(
            name for name, row in report.items()
            if not row["reference"].get("faulted", True)
        )
    deltas: dict = {}
    wins: list[str] = []
    regressions: list[str] = []
    for name, row in report.items():
        ref, res = row["reference"], row["resilient"]
        delta = {
            "max_depth_reduction": round(
                ref["max_depth"] - res["max_depth"], 1
            ),
            "time_over_slo_reduction_s": round(
                ref["time_over_slo_s"] - res["time_over_slo_s"], 1
            ),
            "churn_delta": res["replica_changes"] - ref["replica_changes"],
        }
        deltas[name] = delta
        if name in no_fault_scenarios:
            if any(ref[k] != res[k] for k in ("max_depth", "time_over_slo_s",
                                              "replica_changes")):
                regressions.append(name)
        elif (
            delta["max_depth_reduction"] > 0
            or delta["time_over_slo_reduction_s"] > 0
        ):
            wins.append(name)
    return {
        "resilient_wins": wins,
        "no_fault_regressions": regressions,
        "no_fault_scenarios": list(no_fault_scenarios),
        "deltas": deltas,
    }
