"""The reference serving episode: the REAL plane on the twin's script.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/twin/host.py``.  This
runner drives a :class:`~.scenario.ServingScenario` through the port's real
:class:`~...workloads.shard_plane.ShardedBatcher` — the actual gang
engine, insert path (the flash forward kernel on the card),
freest-first/sticky routers, and :class:`~...workloads.tenancy.
PrefixPool` — under the exact cycle contract the compiled twin's loop
encodes (see :mod:`.compiled`'s module docstring for the per-cycle
order), on a device the caller names (the card by default).  The gate
decisions go through the reference :func:`~...core.policy.gate_code`
and a learned policy through the same
:func:`~...learn.network.learned_decision` the live ``LearnedPolicy``
calls; shard scale actuation replicates the
:class:`~...fleet.sharded.ShardedWorkerPool` state machine's exact
ordering (resurrect newest-draining / activate lowest-inactive /
drain newest-serving, drain-retire after the engine cycle) — pinned
against the real pool class by a tier-1 test.

Two claims are verified against the ENGINE itself each cycle, not
against this runner's bookkeeping: first tokens settle at the
admission cycle's combined transfer (``ttft_count`` must grow by
exactly the admitted count), and completions/tokens come from
``step()``'s returns and the emitted-token counters.  What the runner
owns is the queue, the clock, and the scale state — the parts the real
deployment splits across the worker poll loop and the fleet pool.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ...core.policy import GATE_COOLING, GATE_FIRE, GATE_SKIPPED, gate_code
from ...forecast.forecasters import snapshot_tensors
from ...forecast.history import DepthHistory
from ...learn.network import (
    FEATURE_ALPHA,
    FEATURE_WINDOW,
    cooldown_fraction,
    hold_depth,
    learned_decision,
)
from ..scenarios import seeded_token_ids, tenant_prefix_ids
from .compiled import SERVING_SUMMARY_KEYS, TRAJECTORY_KEYS, TwinConfig
from .scenario import SHARD_DRAINING, SHARD_INACTIVE, SHARD_SERVING

#: The pool's static prefix bucket for prefixed episodes (twin worlds
#: are cycle-accounted, so the content length only needs to be legal).
HOST_PREFIX_LEN = 4


@lru_cache(maxsize=4)
def tiny_twin_model(seed: int = 0, max_seq_len: int = 24,
                    device: str = "cuda"):
    """The fidelity battery's tiny real model (CPU-friendly), float32
    weights from ``seed`` on ``device``.  Token CONTENT is irrelevant to
    the twin's cycle observables while no EOS reaches the plane (the
    engine runs with ``eos_id=None``) — the model exists so the real
    engine runs its actual programs."""
    import torch

    from ...device import resolve_device
    from ...workloads.model import ModelConfig, init_params

    config = ModelConfig(
        vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
        max_seq_len=max_seq_len, dtype=torch.float32,
    )
    params = init_params(config, torch.Generator().manual_seed(seed),
                         resolve_device(device))
    return params, config


@dataclass
class HostEpisode:
    """The reference run's per-cycle trail + serving-unit summary, in
    the twin's exact shapes so the fidelity gate compares field for
    field."""

    config: TwinConfig
    summary: dict
    trajectory: dict
    #: the engine's own counters over the episode: ``insert_dispatches``,
    #: ``pooled_inserts`` (the prefixed ones, whose suffix forward runs no
    #: attention kernel), ``prefix_installs`` and ``decode_dispatches``
    engine: dict = field(default_factory=dict)


def _scale_up(state: list[int]) -> "int | None":
    """ShardedWorkerPool.scale_up's pick: resurrect the newest draining
    shard first, else activate the lowest inactive one."""
    draining = [s for s in reversed(range(len(state)))
                if state[s] == SHARD_DRAINING]
    if draining:
        return draining[0]
    inactive = [s for s in range(len(state))
                if state[s] == SHARD_INACTIVE]
    return inactive[0] if inactive else None


def _scale_down(state: list[int]) -> "int | None":
    """ShardedWorkerPool.scale_down's pick: drain the newest serving
    shard."""
    serving = [s for s in reversed(range(len(state)))
               if state[s] == SHARD_SERVING]
    return serving[0] if serving else None


def run_host_episode(
    config: TwinConfig, params=None, model_config=None, *,
    device: str = "cuda",
) -> HostEpisode:
    """One scripted episode through the real sharded plane on ``device``
    (``params`` / ``model_config`` default to :func:`tiny_twin_model`;
    passed weights must live on ``device``)."""
    from ...device import resolve_device
    from ...workloads.shard_plane import ShardedBatcher

    target = resolve_device(device)
    scenario = config.scenario
    if params is None or model_config is None:
        params, model_config = tiny_twin_model(
            max_seq_len=max(
                24,
                HOST_PREFIX_LEN + scenario.prompt_len
                + scenario.generate_tokens,
            ),
            device=str(target),
        )
    tenancy = None
    prefix_ids = {}
    if scenario.pool_entries > 0:
        from ...workloads.tenancy import TenancyConfig

        names = tuple(f"t{i}" for i in range(scenario.tenants))
        tenancy = TenancyConfig(
            tenants=names,
            prefix_pool=scenario.pool_entries,
            prefix_len=HOST_PREFIX_LEN,
            sticky=True,
        )
        prefix_ids = {
            i: np.asarray(
                tenant_prefix_ids(
                    names[i], HOST_PREFIX_LEN, model_config.vocab_size
                ),
                np.int32,
            )
            for i in range(scenario.tenants)
        }
    engine = ShardedBatcher(
        params, model_config,
        shards=scenario.shards, shard_slots=scenario.shard_slots,
        prompt_len=scenario.prompt_len,
        generate_tokens=scenario.generate_tokens,
        decode_block=scenario.decode_block,
        tenancy=tenancy,
        device=target,
    )
    state = [
        SHARD_SERVING if s < scenario.initial_shards else SHARD_INACTIVE
        for s in range(scenario.shards)
    ]
    for s in range(scenario.initial_shards, scenario.shards):
        engine.set_shard_active(s, False)

    sends = scenario.sends()
    total = int(sends.sum())
    arr_cycle = scenario.arrival_cycles()
    budgets = scenario.request_budgets(total)
    tenants = scenario.request_tenants(total)
    prompts = [
        np.asarray(
            seeded_token_ids(
                f"{scenario.name}:prompt:{i}", 3, model_config.vocab_size
            ),
            np.int32,
        )
        for i in range(total)
    ]

    learned = config.policy == "learned"
    if learned:
        from ...learn.checkpoint import checkpoint_history, on_device

        capacity, min_samples = checkpoint_history(config.checkpoint)
        min_samples = max(2, min_samples)
        history = DepthHistory(capacity)
        theta = on_device(config.checkpoint, target).theta
        hidden = int(config.checkpoint.hidden)
    hold = hold_depth(config.up_q, config.down_q)
    last_up = last_down = 0.0  # startup grace at t=0, reference style
    changes = 0
    queue: deque[int] = deque()
    next_arrival = 0
    prev_tokens = prev_hits = prev_misses = 0
    done_budget_ok = True
    completed_once: set[int] = set()
    over_slo = 0.0
    ttft_cycles_sum = 0
    max_queue = 0
    pooled_inserts = 0
    traj: dict[str, list] = {key: [] for key in TRAJECTORY_KEYS}

    for c in range(scenario.cycles):
        # arrivals land before everything else this cycle
        for _ in range(int(sends[c])):
            queue.append(next_arrival)
            next_arrival += 1

        if c % scenario.control_every == 0:
            t = c * scenario.cycle_dt
            observed = len(queue)
            serving_before = sum(1 for s in state if s == SHARD_SERVING)
            decision = observed
            if learned:
                times, depths, n = history.with_sample(t, float(observed))
                times32, depths32 = snapshot_tensors(times, depths, n,
                                                     target)
                decision = int(
                    learned_decision(
                        theta,
                        times32,
                        depths32,
                        n,
                        observed,
                        serving_before,
                        np.float32(cooldown_fraction(
                            last_up, config.up_cd, t
                        )),
                        np.float32(cooldown_fraction(
                            last_down, config.down_cd, t
                        )),
                        config.up_q,
                        config.down_q,
                        hold,
                        min_samples,
                        scenario.max_active,
                        np.float32(scenario.tick_dt),
                        np.float32(FEATURE_ALPHA),
                        FEATURE_WINDOW,
                        hidden=hidden,
                    )
                )
                history.observe(t, float(observed))
            up_code = gate_code(
                decision >= config.up_q, t, last_up, config.up_cd
            )
            if up_code == GATE_FIRE:
                if serving_before < scenario.max_active:
                    pick = _scale_up(state)
                    state[pick] = SHARD_SERVING
                    engine.set_shard_active(pick, True)
                last_up = t  # FIRE refreshes the stamp, clamps included
            down_code = (
                GATE_SKIPPED
                if up_code == GATE_COOLING
                else gate_code(
                    decision <= config.down_q, t, last_down,
                    config.down_cd,
                )
            )
            if down_code == GATE_FIRE:
                serving_mid = sum(1 for s in state if s == SHARD_SERVING)
                if serving_mid > scenario.min_shards:
                    pick = _scale_down(state)
                    state[pick] = SHARD_DRAINING
                    engine.set_shard_active(pick, False)
                last_down = t
            serving_after = sum(1 for s in state if s == SHARD_SERVING)
            changes += serving_after != serving_before

        # refill: FIFO over the queue through the REAL router's capacity
        free = engine.free_slots
        k = min(len(queue), len(free))
        batch = [queue.popleft() for _ in range(k)]
        ttft_c = 0
        for i in batch:
            wait = c - int(arr_cycle[i])
            ttft_c += wait
            over_slo += max(
                0.0, wait * scenario.cycle_dt - scenario.ttft_slo_s
            )
        ttft_cycles_sum += ttft_c
        if batch:
            if scenario.pool_entries > 0:
                pooled_inserts += 1
                engine.submit_many_prefixed([
                    (
                        f"t{int(tenants[i])}",
                        prefix_ids[int(tenants[i])],
                        prompts[i],
                        i,
                    )
                    for i in batch
                ])
            elif scenario.heavy_tail is not None:
                # per-request budgets ride the real per-row-budget
                # resume insert (produced=[] = a fresh admission)
                engine.submit_resume([
                    (prompts[i], i, [], int(budgets[i]), 0.0)
                    for i in batch
                ])
            else:
                engine.submit_many([(prompts[i], i) for i in batch])
        max_queue = max(max_queue, len(queue))

        ttft_before = engine.ttft_count
        finished = engine.step()
        # the same-cycle first-token-settle claim, checked against the
        # ENGINE's own TTFT counter, not this runner's bookkeeping
        if engine.ttft_count - ttft_before != k:
            raise AssertionError(
                f"cycle {c}: {k} admissions but"
                f" {engine.ttft_count - ttft_before} first tokens"
                f" settled — the twin's TTFT model no longer matches"
                f" the engine"
            )
        for payload, tokens in finished:
            if payload in completed_once:
                done_budget_ok = False
            completed_once.add(payload)
            if len(tokens) != int(budgets[payload]):
                done_budget_ok = False
        tokens_c = engine.tokens_emitted - prev_tokens
        prev_tokens = engine.tokens_emitted

        # drain-retire: the pool's end-of-cycle check
        for s in range(scenario.shards):
            if state[s] == SHARD_DRAINING and engine.shard_busy(s) == 0:
                state[s] = SHARD_INACTIVE
        serving_end = sum(1 for s in state if s == SHARD_SERVING)

        pool = engine.prefix_pool
        hits_c = (pool.hits - prev_hits) if pool is not None else 0
        misses_c = (pool.misses - prev_misses) if pool is not None else 0
        if pool is not None:
            prev_hits, prev_misses = pool.hits, pool.misses

        traj["admitted"].append(k)
        traj["completed"].append(len(finished))
        traj["tokens"].append(tokens_c)
        traj["ttft_cycles"].append(ttft_c)
        traj["queue"].append(len(queue))
        traj["serving"].append(serving_end)
        traj["pool_hits"].append(hits_c)
        traj["pool_misses"].append(misses_c)

    if not done_budget_ok:
        raise AssertionError(
            "the real plane completed a request twice or off-budget —"
            " episode is not a valid fidelity reference"
        )
    admitted = total - len(queue)
    # unserved lower-bound SLO debt, the twin's exact formula
    for i in list(queue):
        over_slo += max(
            0.0,
            (scenario.cycles - int(arr_cycle[i])) * scenario.cycle_dt
            - scenario.ttft_slo_s,
        )
    summary = {
        "tokens": int(sum(traj["tokens"])),
        "time_over_slo_s": float(over_slo),
        "shard_changes": int(changes),
        "shard_seconds": float(
            sum(traj["serving"]) * scenario.cycle_dt
        ),
        "completions": int(sum(traj["completed"])),
        "admitted": int(admitted),
        "final_queue": int(len(queue)),
        "max_queue": int(max_queue),
        "ttft_cycles_sum": int(ttft_cycles_sum),
        "pool_hits": int(sum(traj["pool_hits"])),
        "pool_misses": int(sum(traj["pool_misses"])),
    }
    assert set(summary) == set(SERVING_SUMMARY_KEYS)
    pool = engine.prefix_pool
    return HostEpisode(
        config=config,
        summary=summary,
        trajectory={k: np.asarray(v) for k, v in traj.items()},
        engine={
            "insert_dispatches": engine.insert_dispatches,
            "pooled_inserts": pooled_inserts,
            "prefix_installs": pool.installs if pool is not None else 0,
            "decode_dispatches": engine.decode_dispatches,
        },
    )
