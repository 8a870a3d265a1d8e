"""Autotuning sweeps: grid/random policy search on the compiled simulator.

KIS-S (arxiv 2507.07932) frames autoscaler tuning as simulator-driven
policy search — thousands of candidate configurations scored against the
same deterministic worlds.  The scenario battery scores 4 policies;
this runner explores the (gate × policy × forecast) parameter space —
thresholds, cooldowns, scale step, forecaster, horizon, history — by
batching every (scenario × configuration) point through the compiled
simulator (:mod:`.compiled`), so a few hundred episodes cost one batch on
the device.

Scoring reuses the battery's :func:`~.evaluate.score_result` verbatim:
the compiled episodes come back as ordinary
:class:`~.simulator.SimResult` objects, so sweep rows, battery rows, and
counterfactual replay rows are judged on identical numbers.  The summary
reports, per scenario, the best configuration (lexicographic: max depth,
then churn, then time-over-SLO) and the max-depth-vs-churn Pareto front —
the two-axis tradeoff a fleet operator actually tunes.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/sweep.py``: the spec,
scoring and Pareto half is the same host code, and the episodes run on
the ``device`` the caller names (the card by default).
"""

from __future__ import annotations

import itertools
import random
from dataclasses import asdict, dataclass, field, replace
from typing import Iterable, Sequence

from ..core.loop import LoopConfig
from ..core.policy import PolicyConfig
from .evaluate import Scenario, default_battery, score_result
from .simulator import SimConfig


@dataclass(frozen=True)
class SweepPoint:
    """One candidate configuration: gate knobs + depth policy knobs.

    ``policy`` is ``"reactive"`` or a forecaster name (``ewma``/``holt``/
    ``lstsq``); ``horizon``/``history`` only apply to forecaster points.
    """

    scale_up_messages: int = 100
    scale_down_messages: int = 10
    scale_up_cooldown: float = 10.0
    scale_down_cooldown: float = 30.0
    scale_up_pods: int = 1
    policy: str = "reactive"
    horizon: float = 30.0
    history: int = 128

    def label(self) -> str:
        gates = (
            f"up{self.scale_up_messages}/down{self.scale_down_messages}"
            f"/cu{self.scale_up_cooldown:g}/cd{self.scale_down_cooldown:g}"
            f"/step{self.scale_up_pods}"
        )
        if self.policy == "reactive":
            return f"{gates}/reactive"
        return f"{gates}/{self.policy}@{self.horizon:g}s/h{self.history}"

    def to_config(self, scenario: Scenario) -> SimConfig:
        """This point applied to one scenario's world."""
        loop = LoopConfig(
            poll_interval=scenario.loop.poll_interval,
            policy=PolicyConfig(
                scale_up_messages=self.scale_up_messages,
                scale_down_messages=self.scale_down_messages,
                scale_up_cooldown=self.scale_up_cooldown,
                scale_down_cooldown=self.scale_down_cooldown,
            ),
        )
        config = SimConfig(
            arrival_rate=scenario.arrival,
            service_rate_per_replica=scenario.service_rate_per_replica,
            duration=scenario.duration,
            initial_replicas=scenario.initial_replicas,
            min_pods=scenario.min_pods,
            max_pods=scenario.max_pods,
            scale_up_pods=self.scale_up_pods,
            loop=loop,
        )
        if self.policy != "reactive":
            config = replace(
                config,
                policy="predictive",
                forecaster=self.policy,
                forecast_horizon=self.horizon,
                forecast_history=self.history,
            )
        return config


@dataclass(frozen=True)
class SweepSpec:
    """The search space as one axis-per-field grid.

    :meth:`grid` is the full cross product; :meth:`sample` draws a random
    subset of it (seeded — sweeps are reproducible).  Reactive points
    collapse the forecaster-only axes (horizon/history) to a single
    canonical value, so the grid never counts the same reactive
    configuration twice.
    """

    scale_up_messages: tuple[int, ...] = (50, 100, 200)
    scale_down_messages: tuple[int, ...] = (10,)
    scale_up_cooldown: tuple[float, ...] = (10.0, 20.0)
    scale_down_cooldown: tuple[float, ...] = (30.0,)
    scale_up_pods: tuple[int, ...] = (1, 2)
    policies: tuple[str, ...] = ("reactive", "ewma", "holt", "lstsq")
    horizons: tuple[float, ...] = (15.0, 45.0)
    histories: tuple[int, ...] = (128,)

    def _gate_axes(self):
        return itertools.product(
            self.scale_up_messages,
            self.scale_down_messages,
            self.scale_up_cooldown,
            self.scale_down_cooldown,
            self.scale_up_pods,
        )

    def _policy_axes(self) -> list[tuple[str, float, int]]:
        points: list[tuple[str, float, int]] = []
        for policy in self.policies:
            if policy == "reactive":
                points.append(("reactive", self.horizons[0], self.histories[0]))
            else:
                points.extend(
                    (policy, horizon, history)
                    for horizon in self.horizons
                    for history in self.histories
                )
        return points

    def grid(self) -> list[SweepPoint]:
        """The full cross product, reactive deduplicated."""
        return [
            SweepPoint(
                scale_up_messages=up,
                scale_down_messages=down,
                scale_up_cooldown=cu,
                scale_down_cooldown=cd,
                scale_up_pods=step,
                policy=policy,
                horizon=horizon,
                history=history,
            )
            for up, down, cu, cd, step in self._gate_axes()
            for policy, horizon, history in self._policy_axes()
        ]

    def sample(self, n: int, seed: int = 0) -> list[SweepPoint]:
        """``n`` distinct points drawn uniformly from :meth:`grid`."""
        grid = self.grid()
        if n >= len(grid):
            return grid
        rng = random.Random(seed)
        return rng.sample(grid, n)


def pareto_front(points: Sequence[tuple[float, float]]) -> list[int]:
    """Indices of the non-dominated points (both axes minimized).

    A point is dominated when another is at least as good on both axes
    and strictly better on one.  O(n²) on purpose: sweep fronts are a few
    hundred points and the quadratic form is obviously correct.
    """
    front = []
    for i, (xi, yi) in enumerate(points):
        dominated = any(
            (xj <= xi and yj <= yi) and (xj < xi or yj < yi)
            for j, (xj, yj) in enumerate(points)
            if j != i
        )
        if not dominated:
            front.append(i)
    return front


#: score-row ordering for "best": worst backlog first, then churn, then
#: SLO time — the battery's priorities (evaluate module docstring).
#: Serving-twin rows rank in SERVING units instead: most tokens/s,
#: then least time-over-TTFT-SLO, then least shard churn — the twin
#: bench's lexicographic axes.
def _rank(row: dict) -> tuple:
    if "tokens_per_second" in row:
        return (
            -row["tokens_per_second"],
            row["time_over_slo_s"],
            row["shard_changes"],
        )
    return (
        row["max_depth"],
        row["replica_changes"],
        row["time_over_slo_s"],
    )


@dataclass
class SweepReport:
    """All scored (scenario × point) rows + the tuning summaries."""

    rows: list[dict] = field(default_factory=list)

    @property
    def points(self) -> int:
        return len(self.rows)

    def _by_scenario(self) -> dict[str, list[dict]]:
        grouped: dict[str, list[dict]] = {}
        for row in self.rows:
            grouped.setdefault(row["scenario"], []).append(row)
        return grouped

    def best_per_scenario(self) -> dict[str, dict]:
        """The winning configuration for each scenario (see ``_rank``)."""
        return {
            name: min(rows, key=lambda r: _rank(r["score"]))
            for name, rows in self._by_scenario().items()
        }

    def best_points_per_scenario(self) -> dict[str, SweepPoint]:
        """The winning configurations as re-runnable :class:`SweepPoint`\\ s.

        Rebuilt from the rows' recorded ``point`` dicts, so a tuned
        winner can be re-evaluated on *other* worlds than the one it was
        tuned on.  (The learn bench aggregates winners per scenario
        *family* across variants rather than per scenario, so it picks
        its baseline from the raw rows directly — this per-scenario form
        is the API for everything else.)
        """
        return {
            name: SweepPoint(**row["point"])
            for name, row in self.best_per_scenario().items()
        }

    def pareto_per_scenario(self) -> dict[str, list[dict]]:
        """Backlog-vs-churn Pareto front per scenario, best-first.

        Fluid rows minimize (max depth, replica churn); serving rows
        minimize (-tokens/s, shard churn) — the same two-axis
        throughput-vs-actuation tradeoff in each world's units."""
        fronts: dict[str, list[dict]] = {}
        for name, rows in self._by_scenario().items():
            axes = [
                (
                    (-r["score"]["tokens_per_second"],
                     r["score"]["shard_changes"])
                    if "tokens_per_second" in r["score"]
                    else (r["score"]["max_depth"],
                          r["score"]["replica_changes"])
                )
                for r in rows
            ]
            front = [rows[i] for i in pareto_front(axes)]
            fronts[name] = sorted(front, key=lambda r: _rank(r["score"]))
        return fronts

    def summary(self) -> dict:
        """The artifact block ``bench.py --suite sweep`` records."""
        return {
            "points": self.points,
            "best": {
                name: {"config": row["label"], "score": row["score"]}
                for name, row in self.best_per_scenario().items()
            },
            "pareto": {
                name: [
                    {"config": row["label"], "score": row["score"]}
                    for row in front
                ]
                for name, front in self.pareto_per_scenario().items()
            },
        }


def run_sweep(
    points: "SweepSpec | Iterable[SweepPoint]",
    scenarios: Sequence[Scenario] | None = None,
    *,
    device: str = "cuda",
) -> SweepReport:
    """Score every (scenario × point) through the compiled simulator on
    ``device``.

    Episodes are batched into as few batches as the loop shapes allow:
    one batch per (tick count, history capacity) group — with the default
    battery and spec, exactly one batch for the entire sweep.
    """
    # Lazy import: this module's spec/Pareto half stays importable without
    # torch.
    if isinstance(points, SweepSpec):
        points = points.grid()
    points = list(points)
    if not points:
        raise ValueError("sweep needs at least one point")
    scenarios = tuple(scenarios if scenarios is not None else default_battery())
    from .twin.scenario import ServingScenario

    serving = [isinstance(s, ServingScenario) for s in scenarios]
    if any(serving):
        if not all(serving):
            raise ValueError(
                "one sweep takes fluid scenarios OR serving scenarios,"
                " not a mix (their score units are incomparable)"
            )
        return _run_serving_sweep(points, scenarios, device)
    from .compiled import run_episodes_grouped

    jobs = [
        (scenario, point) for scenario in scenarios for point in points
    ]
    episodes = run_episodes_grouped(
        [point.to_config(scenario) for scenario, point in jobs],
        device=device,
    )
    report = SweepReport()
    for (scenario, point), episode in zip(jobs, episodes):
        report.rows.append(
            {
                "scenario": scenario.name,
                "label": point.label(),
                "point": asdict(point),
                "score": score_result(episode.result, scenario.slo_depth),
            }
        )
    return report


def _run_serving_sweep(points, scenarios, device) -> SweepReport:
    """Tuned-threshold baselines on SERVING worlds: each reactive gate
    point re-runs through the token-level twin and is scored in serving
    units (:func:`~.twin.compiled.score_twin_summary`), so
    ``best_per_scenario``/``best_points_per_scenario`` pick winners on
    the same lexicographic axes the twin bench gates.  Forecaster
    points are skipped — the serving twin's policy seam is reactive
    thresholds or the learned network, and a sweep must not silently
    score a forecaster point as something else."""
    from .twin.compiled import (
        run_twin_grouped,
        score_twin_summary,
        twin_config_for_point,
    )

    reactive_points = [p for p in points if p.policy == "reactive"]
    if not reactive_points:
        raise ValueError(
            "a serving sweep needs at least one reactive point"
            " (forecaster points have no serving-twin analogue)"
        )
    jobs = [
        (scenario, point)
        for scenario in scenarios
        for point in reactive_points
    ]
    episodes = run_twin_grouped(
        [twin_config_for_point(point, scenario)
         for scenario, point in jobs],
        trajectory=False,
        device=device,
    )
    report = SweepReport()
    for (scenario, point), episode in zip(jobs, episodes):
        report.rows.append(
            {
                "scenario": scenario.name,
                "label": point.label(),
                "point": asdict(point),
                "score": score_twin_summary(episode.summary, scenario),
            }
        )
    return report
