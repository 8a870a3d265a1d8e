"""The serving twin's mechanical fidelity gate.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/twin/fidelity.py``.
Same contract as the fluid twin's :func:`~..compiled.verify_fidelity`:
run identical scripted worlds through the compiled loop AND the real
plane (:mod:`.host`), compare cycle for cycle, and report every
mismatch through the flight recorder's :class:`~..replay.Divergence`
machinery.

Compared per cycle: admitted count, completions, tokens emitted, TTFT
cycle sums, queue depth, serving shard count, prefix-pool hits and
misses.  Compared per episode: every serving summary accumulator
(time-over-SLO to float64 noise, everything else exactly).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from ..replay import Divergence
from .compiled import (
    SERVING_SUMMARY_KEYS,
    TRAJECTORY_KEYS,
    TwinConfig,
    run_twin_grouped,
)
from .host import run_host_episode
from .scenario import ServingScenario


@dataclass
class TwinFidelityReport:
    """Outcome of one serving-twin fidelity pass."""

    episodes: int
    cycles: int
    divergences: list[tuple[str, Divergence]]
    #: each real episode's engine counters (:attr:`.host.HostEpisode.
    #: engine`), in input order
    engines: list[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.divergences

    def format_divergences(self, limit: int = 10) -> list[str]:
        return [
            f"{label}: cycle {d.tick}: {d.tick_field}"
            f" recorded={d.recorded!r} replayed={d.replayed!r}"
            for label, d in self.divergences[:limit]
        ]


def _label(config: TwinConfig) -> str:
    return f"{config.scenario.name}/{config.policy}"


def verify_twin_fidelity(
    configs: "Sequence[TwinConfig | ServingScenario]",
    *,
    params=None,
    model_config=None,
    device: str = "cuda",
) -> TwinFidelityReport:
    """Compiled-vs-real over every config; 0 divergences or the list.

    Bare :class:`ServingScenario`\\ s run under the reactive policy;
    pass :class:`TwinConfig` rows to cover learned checkpoints and
    swept gate knobs.  Compiled episodes batch by shape group in as few
    batches as the shapes allow; each real episode runs the actual plane
    cycle by cycle, both on ``device`` (the card by default), the plane
    on ``params`` / ``model_config`` when given (weights on ``device``),
    else on :func:`~.host.tiny_twin_model`.
    """
    rows = [
        c if isinstance(c, TwinConfig) else TwinConfig(scenario=c)
        for c in configs
    ]
    compiled = run_twin_grouped(rows, trajectory=True, device=device)
    divergences: list[tuple[str, Divergence]] = []
    engines: list[dict] = []
    total_cycles = 0
    for config, twin in zip(rows, compiled):
        host = run_host_episode(config, params, model_config,
                                device=device)
        engines.append(host.engine)
        label = _label(config)
        total_cycles += config.scenario.cycles
        for key in TRAJECTORY_KEYS:
            a, b = host.trajectory[key], twin.trajectory[key]
            for cycle in range(config.scenario.cycles):
                if int(a[cycle]) != int(b[cycle]):
                    divergences.append(
                        (
                            label,
                            Divergence(
                                cycle, key, int(a[cycle]), int(b[cycle])
                            ),
                        )
                    )
                    break  # first mismatch per field tells the story
        for key in SERVING_SUMMARY_KEYS:
            recorded, replayed = host.summary[key], twin.summary[key]
            if key == "time_over_slo_s":
                same = math.isclose(
                    recorded, replayed, rel_tol=1e-9, abs_tol=1e-9
                )
            else:
                same = int(recorded) == int(replayed)
            if not same:
                divergences.append(
                    (
                        label,
                        Divergence(
                            config.scenario.cycles,
                            f"summary.{key}",
                            recorded,
                            replayed,
                        ),
                    )
                )
    return TwinFidelityReport(
        episodes=len(rows), cycles=total_cycles, divergences=divergences,
        engines=engines,
    )
