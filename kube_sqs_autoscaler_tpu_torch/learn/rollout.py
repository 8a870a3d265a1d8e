"""Population rollouts: thousands of learned episodes in one batch.

The port's copy of ``kube_sqs_autoscaler_tpu/learn/rollout.py``.  The
compiled simulator runs whole closed-loop episodes as one loop over ticks
on a ``[B]`` batch of encoded configs (:mod:`..sim.compiled`).  Training
needs one more axis: a *population* of parameter vectors, each evaluated
on every training scenario.  The reference nests a second ``vmap`` over
the theta axis; here the ``[P thetas × E scenarios]`` product is one
flattened batch of ``P·E`` rows (row ``p·E + e``) through the very same
episode loop the fidelity gate verifies, with per-tick trajectory output
switched off — so a generation costs one batch on the device and reads
back six scalars per episode (max depth, time-over-SLO, churn,
replica-seconds, finals), not ``O(ticks)`` arrays.

Because the rollout reuses the gated episode function — not a training
re-implementation of the loop — a trained policy's training-time scores
and its deployed behavior can only diverge if fidelity itself is broken.
Every entry point computes on ``device`` (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..sim.compiled import encode_config, episode_ticks, run_batch, stack_rows
from ..sim.simulator import SimConfig
from .checkpoint import (
    DEFAULT_HISTORY,
    DEFAULT_MIN_SAMPLES,
    PolicyCheckpoint,
    checkpoint_history,
)
from .network import param_count

#: Summary keys :func:`evaluate_population` returns, each ``[P, E]``.
SUMMARY_KEYS = (
    "max_depth",
    "time_over_slo",
    "replica_changes",
    "replica_seconds",
    "final_depth",
    "final_replicas",
)

#: The TRAINING subset of the serving twin's summary accumulators
#: (the canonical full set is ``sim.twin.compiled.
#: SERVING_SUMMARY_KEYS``, which adds the fidelity-only
#: ttft_cycles_sum / pool_hits / pool_misses counters):
#: :func:`evaluate_population_serving` returns exactly these, each
#: ``[P, E]``.  Subset-ness is asserted at call time so the two tuples
#: can never silently diverge.
SERVING_TRAIN_KEYS = (
    "tokens",
    "time_over_slo_s",
    "shard_changes",
    "shard_seconds",
    "completions",
    "admitted",
    "final_queue",
    "max_queue",
)


def learned_config(scenario: Any, checkpoint: PolicyCheckpoint) -> SimConfig:
    """One scenario's world under the learned policy.

    The world/gate parameters come from the scenario exactly as
    :func:`~..sim.evaluate.run_episode` builds them for reactive and
    predictive rows — the learned policy competes on the stock gates, it
    never gets private thresholds.
    """
    from .checkpoint import TWIN_FLUID, require_twin

    require_twin(checkpoint, TWIN_FLUID, "the fluid compiled twin")
    history, min_samples = checkpoint_history(checkpoint)
    return SimConfig(
        arrival_rate=scenario.arrival,
        service_rate_per_replica=scenario.service_rate_per_replica,
        duration=scenario.duration,
        initial_replicas=scenario.initial_replicas,
        min_pods=scenario.min_pods,
        max_pods=scenario.max_pods,
        loop=scenario.loop,
        policy="learned",
        forecast_history=history,
        forecast_min_samples=min_samples,
        learned_checkpoint=checkpoint,
    )


def population_batch(batch: dict[str, np.ndarray],
                     thetas: np.ndarray) -> dict[str, np.ndarray]:
    """``E`` encoded rows × ``[P, D]`` thetas as one flattened batch of
    ``P·E`` rows: row ``p·E + e`` is scenario ``e`` under theta ``p``."""
    population = thetas.shape[0]
    scenarios = next(iter(batch.values())).shape[0]
    flat = {key: np.concatenate([value] * population)
            for key, value in batch.items() if key != "theta"}
    flat["theta"] = np.repeat(thetas, scenarios, axis=0)
    return flat


def _check_thetas(thetas: np.ndarray, hidden: int) -> np.ndarray:
    thetas = np.ascontiguousarray(thetas, dtype=np.float32)
    if thetas.ndim != 2 or thetas.shape[1] != param_count(hidden):
        raise ValueError(
            f"thetas must be [population, {param_count(hidden)}] for"
            f" hidden={hidden}, got {thetas.shape}"
        )
    return thetas


def evaluate_population(
    thetas: np.ndarray,
    scenarios: Sequence[Any],
    *,
    hidden: int,
    history: int = DEFAULT_HISTORY,
    min_samples: int = DEFAULT_MIN_SAMPLES,
    device: str = "cuda",
) -> dict[str, np.ndarray]:
    """Score every (theta × scenario) episode in one batch on ``device``.

    ``thetas`` is ``[P, param_count(hidden)]`` float32; returns
    ``{summary_key: [P, E] ndarray}`` (:data:`SUMMARY_KEYS`).  All
    scenarios must share a tick count — duration and poll cadence are
    loop shapes (variants generated by
    :func:`~..sim.scenarios.scenario_variants` inherit both, so a
    battery plus its variants always batches).
    """
    thetas = _check_thetas(thetas, hidden)
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    # placeholder checkpoint: encode_config wants one per learned row;
    # the real thetas ride in on the population axis
    placeholder = PolicyCheckpoint(
        theta=np.zeros(param_count(hidden), np.float32),
        hidden=hidden,
        meta={"forecast_history": history, "min_samples": min_samples},
    )
    configs = [learned_config(s, placeholder) for s in scenarios]
    ticks_set = {episode_ticks(c) for c in configs}
    if len(ticks_set) > 1:
        raise ValueError(
            f"all training scenarios must share a tick count (a compiled"
            f" shape), got {sorted(ticks_set)}"
        )
    ticks = ticks_set.pop()
    rows = [
        encode_config(config, slo_depth=float(scenario.slo_depth))
        for scenario, config in zip(scenarios, configs)
    ]
    out = run_batch(population_batch(stack_rows(rows), thetas), ticks,
                    history, predictive=False, hidden=hidden,
                    trajectory=False, device=device)
    shape = (thetas.shape[0], len(scenarios))
    return {key: out[key].reshape(shape) for key in SUMMARY_KEYS}


def evaluate_population_serving(
    thetas: np.ndarray,
    scenarios: Sequence[Any],
    *,
    hidden: int,
    history: int,
    min_samples: int = 2,
    device: str = "cuda",
) -> dict[str, np.ndarray]:
    """Score every (theta × serving scenario) twin episode in one batch
    on ``device`` — the serving analogue of :func:`evaluate_population`.

    ``scenarios`` are :class:`~..sim.twin.ServingScenario`\\ s sharing a
    loop shape (cycles × plane geometry — variants inherit both).
    Returns ``{key: [P, E]}`` over :data:`SERVING_TRAIN_KEYS`; the
    per-episode readback is those scalars, nothing else.
    """
    from ..sim.twin.compiled import (
        LEARNED_KIND,
        SERVING_SUMMARY_KEYS,
        TwinConfig,
        encode_twin_config,
        run_twin_batch,
    )

    assert set(SERVING_TRAIN_KEYS) <= set(SERVING_SUMMARY_KEYS)

    thetas = _check_thetas(thetas, hidden)
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    shapes = {(s.cycles, s.shards, s.shard_slots) for s in scenarios}
    if len(shapes) > 1:
        raise ValueError(
            f"all serving training scenarios must share (cycles, shards,"
            f" shard_slots) — compiled shapes — got {sorted(shapes)}"
        )
    placeholder = PolicyCheckpoint(
        theta=np.zeros(param_count(hidden), np.float32),
        hidden=hidden,
        meta={
            "twin": "serving",
            "forecast_history": history,
            "min_samples": min_samples,
        },
    )
    r_max = max(1, max(s.total_requests() for s in scenarios))
    t_max = max(1, max(s.tenants for s in scenarios))
    entries = max(1, max(s.pool_entries for s in scenarios))
    rows = [
        encode_twin_config(
            TwinConfig(scenario=s, policy="learned",
                       checkpoint=placeholder),
            r_max, t_max,
        )
        for s in scenarios
    ]
    assert all(int(r["policy_kind"]) == LEARNED_KIND for r in rows)
    cycles, shards, shard_slots = shapes.pop()
    out = run_twin_batch(
        population_batch(stack_rows(rows), thetas),
        cycles=cycles, shards=shards, shard_slots=shard_slots,
        r_max=r_max, t_max=t_max, entries=entries, capacity=history,
        hidden=hidden, trajectory=False, device=device,
    )
    shape = (thetas.shape[0], len(scenarios))
    return {key: out[key].reshape(shape) for key in SERVING_TRAIN_KEYS}


def evaluate_checkpoint(
    checkpoint: PolicyCheckpoint, scenarios: Sequence[Any], *,
    device: str = "cuda",
) -> list[dict]:
    """Battery-style score rows for one checkpoint over ``scenarios``.

    Full-trajectory compiled episodes scored by the battery's own
    :func:`~..sim.evaluate.score_result`, so learned rows, sweep rows and
    counterfactual rows are judged on identical numbers.
    """
    from ..sim.compiled import run_episodes_grouped
    from ..sim.evaluate import score_result

    scenarios = list(scenarios)
    episodes = run_episodes_grouped(
        [learned_config(s, checkpoint) for s in scenarios], device=device
    )
    rows = []
    for scenario, episode in zip(scenarios, episodes):
        row = score_result(episode.result, scenario.slo_depth)
        row["scenario"] = scenario.name
        row["policy"] = f"learned@{checkpoint.hash}"
        rows.append(row)
    return rows
