"""Antithetic ES inside the SERVING twin — reward in serving units.

The fluid trainer (:mod:`.train`) optimizes queue-depth cost because
that is all a fluid world can score.  The fleet is scored in tokens/s,
time-over-TTFT-SLO, and shard churn, so this trainer evaluates its
population inside the token-level serving twin
(:mod:`..sim.twin.compiled`) and rewards exactly those axes —
KIS-S's sim-trains-policy loop with the simulator finally speaking the
plant's units.

Estimator, seeding, and rank shaping are the fluid trainer's verbatim
(the landscape argument in :mod:`.train`'s docstring applies with the
same force: integer completions through threshold gates and argmax
actions have no usable gradients).  Only the world and the reward
changed.  The checkpoint artifact is stamped ``twin: "serving"`` with
its reward units, and every fluid deployment seam rejects it at load
time (:func:`~.checkpoint.require_twin`).

The port's copy of ``kube_sqs_autoscaler_tpu/learn/serving.py``: the ES
arithmetic stays numpy, the twin's population batches run on ``device``
(the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Callable, Sequence

import numpy as np

from .checkpoint import TWIN_SERVING, PolicyCheckpoint
from .network import DEFAULT_HIDDEN, init_params, param_count
from .rollout import evaluate_population_serving
from .train import TrainResult, _rank_utilities

#: Serving feature-history capacity: 16 control ticks covers the
#: EWMA/trend features at the twin's default 48-tick episodes; stamped
#: into checkpoint meta like the fluid DEFAULT_HISTORY.
SERVING_HISTORY = 16

REWARD_UNITS = "tokens/s - time-over-TTFT-SLO - shard-churn - shard-seconds"


@dataclass(frozen=True)
class ServingESConfig:
    """One serving training run's knobs."""

    population: int = 24
    generations: int = 30
    sigma: float = 0.1
    lr: float = 0.2
    seed: int = 0
    hidden: int = DEFAULT_HIDDEN
    history: int = SERVING_HISTORY
    min_samples: int = 2
    # reward weights over reference-normalized serving axes
    tokens_weight: float = 1.0
    slo_weight: float = 0.6
    churn_weight: float = 0.1
    shard_weight: float = 0.1

    def __post_init__(self):
        if self.population < 2 or self.population % 2:
            raise ValueError(
                f"population must be an even number >= 2, got"
                f" {self.population}"
            )
        if self.generations < 1:
            raise ValueError("generations must be >= 1")
        if self.sigma <= 0 or self.lr <= 0:
            raise ValueError("sigma and lr must be > 0")
        if self.history < 2:
            raise ValueError("history must be >= 2")


@dataclass(frozen=True)
class ServingScales:
    """Per-scenario normalizers from the reactive reference plane."""

    tokens: np.ndarray  # [E] reactive tokens (>= 1)
    duration: np.ndarray  # [E] episode seconds
    ticks: np.ndarray  # [E] control ticks
    shard_budget: np.ndarray  # [E] max_shards * duration


def serving_reference_scales(scenarios: Sequence[Any], *,
                             device: str = "cuda") -> ServingScales:
    """Reactive-baseline scales (one grouped compiled batch)."""
    from ..sim.twin.compiled import TwinConfig, run_twin_grouped

    episodes = run_twin_grouped(
        [TwinConfig(scenario=s) for s in scenarios], trajectory=False,
        device=device,
    )
    return ServingScales(
        tokens=np.maximum(
            np.asarray([e.summary["tokens"] for e in episodes], np.float64),
            1.0,
        ),
        duration=np.asarray(
            [s.duration_s for s in scenarios], np.float64
        ),
        ticks=np.asarray(
            [max(1, s.cycles // s.control_every) for s in scenarios],
            np.float64,
        ),
        shard_budget=np.asarray(
            [max(1.0, s.max_active * s.duration_s) for s in scenarios],
            np.float64,
        ),
    )


def serving_reward_vector(
    summaries: dict[str, np.ndarray],
    scales: ServingScales,
    config: ServingESConfig,
) -> np.ndarray:
    """``[P, E]`` serving summaries → ``[P]`` mean rewards (higher =
    better): normalized tokens minus SLO debt minus churn minus
    shard-seconds — the twin bench's lexicographic axes, scalarized for
    the estimator with cost terms keeping over-provisioning honest."""
    reward = (
        config.tokens_weight * summaries["tokens"] / scales.tokens
        - config.slo_weight * summaries["time_over_slo_s"] / scales.duration
        - config.churn_weight * summaries["shard_changes"] / scales.ticks
        - config.shard_weight
        * summaries["shard_seconds"]
        / scales.shard_budget
    )
    return np.mean(reward, axis=1)


def train_serving(
    scenarios: Sequence[Any],
    config: ServingESConfig = ServingESConfig(),
    progress: Callable[[dict], None] | None = None,
    *,
    device: str = "cuda",
) -> TrainResult:
    """Train the policy network inside the serving twin; best center.

    Identical loop discipline to the fluid :func:`~.train.train`:
    antithetic pairs plus the current center per generation, centered-
    rank shaping, best-center-by-training-reward checkpointing, held-out
    worlds never consulted.
    """
    scenarios = list(scenarios)
    scales = serving_reference_scales(scenarios, device=device)
    dim = param_count(config.hidden)
    half = config.population // 2
    rng = np.random.default_rng(config.seed)
    center = init_params(config.seed, config.hidden).astype(np.float64)
    best_theta = center.copy()
    best_reward = -np.inf
    stats: list[dict] = []
    for generation in range(config.generations):
        eps = rng.standard_normal((half, dim))
        thetas = np.concatenate(
            [
                center[None, :] + config.sigma * eps,
                center[None, :] - config.sigma * eps,
                center[None, :],
            ]
        ).astype(np.float32)
        summaries = evaluate_population_serving(
            thetas,
            scenarios,
            hidden=config.hidden,
            history=config.history,
            min_samples=config.min_samples,
            device=device,
        )
        rewards = serving_reward_vector(summaries, scales, config)
        pop_rewards, center_reward = rewards[:-1], float(rewards[-1])
        utilities = _rank_utilities(pop_rewards)
        grad = (utilities[:half] - utilities[half:]) @ eps
        center = center + (
            config.lr / (config.population * config.sigma)
        ) * grad
        if center_reward > best_reward:
            best_reward = center_reward
            best_theta = np.asarray(thetas[-1], np.float64)
        row = {
            "generation": generation,
            "center_reward": center_reward,
            "population_mean": float(np.mean(pop_rewards)),
            "population_best": float(np.max(pop_rewards)),
            "best_so_far": best_reward,
        }
        stats.append(row)
        if progress is not None:
            progress(row)
    checkpoint = PolicyCheckpoint(
        theta=np.asarray(best_theta, np.float32),
        hidden=config.hidden,
        meta={
            "trainer": "antithetic-es-serving",
            "twin": TWIN_SERVING,
            "reward_units": REWARD_UNITS,
            "config": asdict(config),
            "forecast_history": config.history,
            "min_samples": config.min_samples,
            "scenarios": [s.name for s in scenarios],
            "best_train_reward": best_reward,
            "reward_curve": [
                round(row["center_reward"], 6) for row in stats
            ],
        },
    )
    return TrainResult(checkpoint=checkpoint, stats=stats)


__all__ = [
    "REWARD_UNITS",
    "SERVING_HISTORY",
    "ServingESConfig",
    "ServingScales",
    "serving_reference_scales",
    "serving_reward_vector",
    "train_serving",
]
