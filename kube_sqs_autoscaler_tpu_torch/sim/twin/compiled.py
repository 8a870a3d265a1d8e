"""The serving plane as one loop over engine cycles per episode batch.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/twin/compiled.py``.  One
loop iteration is one ENGINE CYCLE of the real sharded plane
(:class:`~...workloads.shard_plane.ShardedBatcher` driven by the
:mod:`.host` reference runner), reproduced integer for integer, for a
``[B]`` batch of encoded configs at once (the reference's ``vmap``):

- **arrivals** land on the queue from the scenario's exact-integral
  send schedule;
- every ``control_every`` cycles an **autoscaler tick** runs: the
  observed queue depth (or the learned MLP's decision over it — the
  same :func:`~...learn.network.learned_decision_rows` the fluid twin
  runs and the live ``LearnedPolicy`` calls with one row) goes through
  the reference :func:`~...core.policy.gate_code` gates with cooldowns,
  actuating the :mod:`...fleet.sharded` shard state machine (scale-up
  resurrects the newest draining shard else activates the lowest
  inactive one; scale-down drains the newest serving shard; both stamps
  refresh on FIRE, boundary no-ops included);
- **refill** admits ``min(queue, eligible slots)`` requests FIFO,
  routed one at a time to the freest serving shard (lowest-index
  tie-break — the real router's exact order), sticky to a tenant's home
  shard when tenancy is on, each admission touching the per-shard
  prefix-pool LRU (hit/miss/install counters).  The reference's
  ``fori_loop`` over the slots is a host loop over ``j < slots`` whose
  ``take = j < k`` is a per-row mask, and each ``.at[].set`` a
  ``torch.where`` written back with ``scatter_``;
- **step** mirrors the gang block engine's dispatch-ahead mechanics:
  a dispatched block spends ``min(decode_block, remaining)`` device
  budget immediately but its tokens settle one cycle later; admission
  first tokens settle the same cycle (the one combined transfer); a slot
  frees the cycle its produced count reaches budget;
- **drain-retire** flips an emptied draining shard inactive, end of
  cycle — the pool's ``run_cycle`` order.

TTFT is cycle-counted at admission (first tokens settle at the admission
cycle's combined transfer), so time-over-TTFT-SLO is exact — it adds one
admission at a time, in the host's order — plus a lower-bound penalty for
requests still queued at episode end, so refusing admission can never
launder SLO debt.

The whole batch is uploaded once, the loop issues device work only (no
host read, no branch on a tensor; the only host branches are on the
cycle index and on which features some row of the batch uses), and the
outputs are read once.  The twin does NOT model chaos states, the
sharded admission plane, or speculative decode.  Within that boundary,
:func:`~.fidelity.verify_twin_fidelity` holds it to ZERO divergences
against the real plane.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ...core.policy import GATE_COOLING, GATE_FIRE, GATE_SKIPPED, gate_code
from ...device import resolve_device
from ...forecast.forecasters import ewma_tables, tree_sum
from ...learn.network import (
    FEATURE_ALPHA,
    FEATURE_WINDOW,
    hold_depth,
    learned_decision_rows,
    policy_features_rows,
)
from .. import compiled as fluid
from .scenario import SHARD_DRAINING, SHARD_INACTIVE, SHARD_SERVING, ServingScenario

F32 = torch.float32
F64 = torch.float64
I64 = torch.int64

#: Policy kinds inside the twin loop — reactive thresholds, or the
#: learned MLP (the fluid twin's code for it, for symmetry).
REACTIVE_KIND, LEARNED_KIND = 0, 4

#: Summary keys every twin episode returns (the serving-unit
#: accumulators the ES trainer and the sweep scorer consume).
SERVING_SUMMARY_KEYS = (
    "tokens",
    "time_over_slo_s",
    "shard_changes",
    "shard_seconds",
    "completions",
    "admitted",
    "final_queue",
    "max_queue",
    "ttft_cycles_sum",
    "pool_hits",
    "pool_misses",
)

#: Trajectory keys (per-cycle arrays) the fidelity gate compares.
TRAJECTORY_KEYS = (
    "admitted",
    "completed",
    "tokens",
    "ttft_cycles",
    "queue",
    "serving",
    "pool_hits",
    "pool_misses",
)


@dataclass(frozen=True)
class TwinConfig:
    """One twin episode: a scenario + the policy that autoscales it.

    ``policy`` is ``"reactive"`` (threshold the scenario's queue gates
    on the observed depth) or ``"learned"`` (a serving-twin-trained
    checkpoint; fluid-twin checkpoints are rejected unless
    ``allow_twin_mismatch`` — an explicit baseline escape hatch, never
    the deployment default).  Gate knobs default to the scenario's; the
    serving sweep overrides them per point.
    """

    scenario: ServingScenario
    policy: str = "reactive"
    checkpoint: Any = None
    allow_twin_mismatch: bool = False
    scale_up_queue: "int | None" = None
    scale_down_queue: "int | None" = None
    up_cooldown_s: "float | None" = None
    down_cooldown_s: "float | None" = None

    def __post_init__(self):
        if self.policy not in ("reactive", "learned"):
            raise ValueError(
                f"twin policy must be 'reactive' or 'learned', got"
                f" {self.policy!r}"
            )
        if self.policy == "learned":
            if self.checkpoint is None:
                raise ValueError("policy='learned' needs a checkpoint")
            from ...learn.checkpoint import TWIN_SERVING, checkpoint_twin

            kind = checkpoint_twin(self.checkpoint)
            if kind != TWIN_SERVING and not self.allow_twin_mismatch:
                raise ValueError(
                    f"checkpoint was trained in the {kind!r} twin; the"
                    f" serving twin evaluates serving-twin checkpoints"
                    f" (pass allow_twin_mismatch=True to score a"
                    f" foreign checkpoint as an explicit baseline)"
                )

    @property
    def up_q(self) -> int:
        return (
            self.scale_up_queue
            if self.scale_up_queue is not None
            else self.scenario.scale_up_queue
        )

    @property
    def down_q(self) -> int:
        return (
            self.scale_down_queue
            if self.scale_down_queue is not None
            else self.scenario.scale_down_queue
        )

    @property
    def up_cd(self) -> float:
        return (
            self.up_cooldown_s
            if self.up_cooldown_s is not None
            else self.scenario.up_cooldown_s
        )

    @property
    def down_cd(self) -> float:
        return (
            self.down_cooldown_s
            if self.down_cooldown_s is not None
            else self.scenario.down_cooldown_s
        )


def encode_twin_config(
    config: TwinConfig, r_max: int, t_max: int
) -> dict[str, Any]:
    """One :class:`TwinConfig` as the loop's parameter row (request
    arrays padded to the batch group's ``r_max``/``t_max``)."""
    s = config.scenario
    sends = s.sends()
    total = int(sends.sum())
    if total > r_max:
        raise ValueError(f"{total} requests exceed the group pad {r_max}")
    arr = np.full(r_max, s.cycles + 1, np.int32)
    arr[:total] = s.arrival_cycles()
    budgets = np.ones(r_max, np.int32)
    budgets[:total] = s.request_budgets(total)
    tenants = np.zeros(r_max, np.int32)
    tenants[:total] = s.request_tenants(total)
    row: dict[str, Any] = {
        "arrived": sends,
        "arr_cycle": arr,
        "budgets": budgets,
        "tenant": tenants,
        "n_requests": np.int32(total),
        "block": np.int32(s.decode_block),
        "min_shards": np.int32(s.min_shards),
        "max_shards": np.int32(s.max_active),
        "initial_shards": np.int32(s.initial_shards),
        "control_every": np.int32(s.control_every),
        "cycle_dt": np.float64(s.cycle_dt),
        "slo_s": np.float64(s.ttft_slo_s),
        "up_q": np.int32(config.up_q),
        "down_q": np.int32(config.down_q),
        "up_cd": np.float64(config.up_cd),
        "down_cd": np.float64(config.down_cd),
        "policy_kind": np.int32(REACTIVE_KIND),
        "theta": np.zeros(1, np.float32),
        "hold": np.int32(hold_depth(config.up_q, config.down_q)),
        "alpha": np.float32(FEATURE_ALPHA),
        "window": np.int32(FEATURE_WINDOW),
        "min_samples": np.int32(2),
        "poll32": np.float32(s.tick_dt),
        "sticky": np.bool_(s.tenants > 0 and s.pool_entries > 0),
        "sticky_threshold": np.int32(s.shard_slots),
        "use_pool": np.bool_(s.pool_entries > 0),
    }
    if config.policy == "learned":
        from ...learn.checkpoint import (
            checkpoint_history,
            require_no_knob_head,
        )

        # the serving twin's loop slices the headless theta layout
        require_no_knob_head(config.checkpoint, "the serving twin")
        _, min_samples = checkpoint_history(config.checkpoint)
        row["policy_kind"] = np.int32(LEARNED_KIND)
        row["theta"] = np.asarray(
            config.checkpoint.theta.detach().cpu().numpy(), np.float32
        )
        row["min_samples"] = np.int32(max(2, min_samples))
    return row


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first ``True`` along the last dimension (0 when there
    is none): ``argmax`` of a boolean's rule, from a ``min``."""
    width = mask.shape[-1]
    idx = torch.arange(width, device=mask.device)
    first = torch.where(mask, idx, width).amin(-1)
    return torch.where(first == width, 0, first)


def _first_max(values: torch.Tensor) -> torch.Tensor:
    """``argmax`` along the last dimension, the lowest index on a tie."""
    return _first_true(values == values.amax(-1, keepdim=True))


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[b, index[b]]`` for every row ``b``."""
    return values.gather(1, index[:, None])[:, 0]


def _put(values: torch.Tensor, index: torch.Tensor, new: torch.Tensor,
         where: torch.Tensor) -> None:
    """``values[b, index[b]] = new[b]`` where ``where[b]``, in place."""
    old = _take(values, index)
    values.scatter_(1, index[:, None], torch.where(where, new, old)[:, None])


def _twin_rows(
    p: dict[str, torch.Tensor],
    *,
    cycles: int,
    shards: int,
    shard_slots: int,
    r_max: int,
    t_max: int,
    entries: int,
    capacity: int,
    hidden: int,
    trajectory: bool,
    tick_cycles: frozenset,
    sticky: bool,
    pooled_rows: bool,
    ewma: Any = None,
) -> dict[str, torch.Tensor]:
    """``[B]`` serving episodes, one loop over engine cycles.

    ``tick_cycles`` are the cycles on which some row's autoscaler ticks
    (no gate can fire on the others, which skip the tick's work);
    ``sticky`` / ``pooled_rows`` say whether some row routes sticky /
    uses the prefix pool (the others' admission skips that work)."""
    rows = p["arrived"].shape[0]
    device = p["arrived"].device
    slots = shards * shard_slots
    shard_of = torch.arange(slots, device=device) // shard_slots
    s_idx = torch.arange(shards, device=device)
    learned = hidden > 0
    zeros = torch.zeros(rows, dtype=I64, device=device)
    queue = zeros
    d = zeros
    busy = torch.zeros(rows, slots, dtype=torch.bool, device=device)
    dev_rem = torch.zeros(rows, slots, dtype=I64, device=device)
    fly = torch.zeros(rows, slots, dtype=I64, device=device)
    prod = torch.zeros(rows, slots, dtype=I64, device=device)
    budget_row = torch.ones(rows, slots, dtype=I64, device=device)
    state = torch.where(s_idx[None, :] < p["initial_shards"][:, None],
                        SHARD_SERVING, SHARD_INACTIVE)
    last_up = torch.zeros(rows, dtype=F64, device=device)
    last_down = last_up
    h_t = torch.zeros(rows, capacity, dtype=F64, device=device)
    h_d = torch.zeros(rows, capacity, dtype=F64, device=device)
    h_n = zeros
    cap_idx = torch.arange(capacity, device=device)
    home = torch.full((rows, t_max), -1, dtype=I64, device=device)
    pool_key = torch.full((rows, shards * entries), -1, dtype=I64,
                          device=device)
    pool_stamp = torch.zeros(rows, shards * entries, dtype=I64,
                             device=device)
    pool_ctr = zeros
    tokens = zeros
    over_slo = torch.zeros(rows, dtype=F64, device=device)
    ttft_sum = zeros
    changes = zeros
    shard_s = zeros
    completions = zeros
    max_q = zeros
    hits = zeros
    misses = zeros
    int_max = torch.iinfo(torch.int32).max
    outs: dict[str, list[torch.Tensor]] = {k: [] for k in TRAJECTORY_KEYS}

    for c in range(cycles):
        # -- arrivals land before everything else this cycle
        queue = queue + p["arrived"][:, c]

        # -- autoscaler tick (every control_every cycles) ---------------
        if c in tick_cycles:
            is_tick = (c % p["control_every"]) == 0
            t = c * p["cycle_dt"]
            serving_before = (state == SHARD_SERVING).sum(1)
            observed = queue
            decision = observed
            if learned:
                # history snapshot including this tick's observation —
                # DepthHistory.with_sample's semantics, per row
                full = h_n >= capacity
                snaps = []
                for h, value in ((h_t, t), (h_d, observed.to(F64))):
                    rolled = torch.cat([h[:, 1:], value[:, None]], dim=1)
                    appended = torch.where(cap_idx[None, :] == h_n[:, None],
                                           value[:, None], h)
                    snaps.append(torch.where(full[:, None], rolled,
                                             appended))
                snap_t, snap_d = snaps
                n = torch.clamp(h_n + 1, max=capacity)
                times32 = (snap_t - t[:, None]).to(F32)
                depths32 = snap_d.to(F32)
                frac32 = []
                for last, cooldown in ((last_up, p["up_cd"]),
                                       (last_down, p["down_cd"])):
                    remaining = (last + cooldown) - t
                    positive = cooldown > 0
                    frac32.append(torch.where(
                        positive & (remaining > 0),
                        remaining / torch.where(positive, cooldown, 1.0),
                        0.0).to(F32))
                features = policy_features_rows(
                    times32, depths32, n, observed, serving_before,
                    frac32[0], frac32[1], p["up_q"], p["max_shards"],
                    p["poll32"], ewma, p["window"], FEATURE_WINDOW)
                learned_dec = learned_decision_rows(
                    p["theta"], features, n, observed, p["up_q"],
                    p["down_q"], p["hold"], p["min_samples"],
                    hidden=hidden)
                decision = torch.where(p["policy_kind"] == LEARNED_KIND,
                                       learned_dec, decision)

            # -- the reference gates (inclusive thresholds, strictly-After
            # cooldowns, up-cooling skips the down gate, FIRE refreshes
            # the stamp even on a clamped boundary no-op)
            up_code = gate_code(decision >= p["up_q"], t, last_up,
                                p["up_cd"])
            up_fire = is_tick & (up_code == GATE_FIRE)
            down_code = torch.where(
                up_code == GATE_COOLING, GATE_SKIPPED,
                gate_code(decision <= p["down_q"], t, last_down,
                          p["down_cd"]))
            down_fire = is_tick & (down_code == GATE_FIRE)

            # scale-up: resurrect the newest draining shard, else activate
            # the lowest inactive one (ShardedWorkerPool.scale_up's order)
            can_up = up_fire & (serving_before < p["max_shards"])
            drain_mask = state == SHARD_DRAINING
            pick_drain = torch.where(drain_mask, s_idx, -1).amax(1)
            pick_inact = _first_true(state == SHARD_INACTIVE)
            pick_up = torch.where(drain_mask.any(1), pick_drain, pick_inact)
            state = torch.where(
                can_up[:, None] & (s_idx[None, :] == pick_up[:, None]),
                SHARD_SERVING, state)
            last_up = torch.where(up_fire, t, last_up)

            # scale-down: drain the newest serving shard
            serving_mask = state == SHARD_SERVING
            can_down = down_fire & (serving_mask.sum(1) > p["min_shards"])
            pick_down = torch.where(serving_mask, s_idx, -1).amax(1)
            state = torch.where(
                can_down[:, None] & (s_idx[None, :] == pick_down[:, None]),
                SHARD_DRAINING, state)
            last_down = torch.where(down_fire, t, last_down)

            serving_after = (state == SHARD_SERVING).sum(1)
            changes = changes + (
                is_tick & (serving_after != serving_before)).to(I64)
            if learned:
                h_t = torch.where(is_tick[:, None], snap_t, h_t)
                h_d = torch.where(is_tick[:, None], snap_d, h_d)
                h_n = torch.where(is_tick, n, h_n)

        # -- refill: FIFO over the queue, freest-serving-shard-first ----
        eligible = (~busy) & (state[:, shard_of] == SHARD_SERVING)
        k = torch.minimum(queue, eligible.sum(1))
        first_flag = torch.zeros(rows, slots, dtype=I64, device=device)
        hits0, misses0, ttft0 = hits, misses, ttft_sum
        for j in range(slots):
            take = k > j
            req = torch.clamp(d + j, max=r_max - 1)
            avail = eligible.view(rows, shards, shard_slots).sum(2)
            freest = _first_max(avail)
            tn = _take(p["tenant"], req)
            pick = freest
            if sticky:
                tn_c = torch.clamp(tn, max=t_max - 1)
                hm = _take(home, tn_c)
                safe_hm = torch.clamp(hm, min=0)
                avail_hm = _take(avail, safe_hm)
                stick = (p["sticky"] & (hm >= 0) & (avail_hm > 0)
                         & ((_take(avail, freest) - avail_hm)
                            < p["sticky_threshold"]))
                pick = torch.where(stick, safe_hm, freest)
                # first admission under sticky routing sets the home shard
                _put(home, tn_c, freest, take & p["sticky"] & (hm < 0))
            row = _first_true(eligible & (shard_of[None, :] == pick[:, None]))
            g = _take(p["budgets"], req)
            _put(busy, row, torch.ones_like(take), take)
            _put(dev_rem, row, g - 1, take)
            _put(prod, row, torch.zeros_like(g), take)
            _put(budget_row, row, g, take)
            _put(first_flag, row, torch.ones_like(g), take)
            _put(eligible, row, torch.zeros_like(take), take)
            if pooled_rows:
                # prefix-pool acquire: LRU hit touches, miss installs into
                # the first empty slot else evicts the least recently used
                pooled = take & p["use_pool"]
                base = (pick * entries)[:, None] + torch.arange(
                    entries, device=device)
                keys_row = pool_key.gather(1, base)
                stamps_row = pool_stamp.gather(1, base)
                match = keys_row == tn[:, None]
                is_hit = match.any(1)
                empty = keys_row < 0
                lru = torch.where(empty, int_max, stamps_row)
                install_idx = torch.where(
                    empty.any(1), _first_true(empty),
                    _first_true(lru == lru.amin(1, keepdim=True)))
                idx = torch.where(is_hit, _first_true(match), install_idx)
                pool_ctr = pool_ctr + pooled.to(I64)
                slot = pick * entries + idx
                _put(pool_key, slot, tn, pooled)
                _put(pool_stamp, slot, pool_ctr, pooled)
                hits = hits + (pooled & is_hit).to(I64)
                misses = misses + (pooled & ~is_hit).to(I64)
            # TTFT: first tokens settle at this cycle's combined transfer,
            # so the wait is admission cycle - arrival cycle
            wait = c - _take(p["arr_cycle"], req)
            ttft_sum = ttft_sum + torch.where(take, wait, 0)
            over_slo = over_slo + torch.where(
                take,
                torch.clamp(wait.to(F64) * p["cycle_dt"] - p["slo_s"],
                            min=0.0),
                0.0)
        queue = queue - k
        d = d + k
        max_q = torch.maximum(max_q, queue)

        # -- step: the gang block engine's dispatch-ahead mechanics -----
        # dispatch block N+1 (spends device budget now), settle the first
        # tokens admitted this cycle AND block N's tokens (they ride the
        # one combined transfer), then free completed slots
        live = busy & (dev_rem > 0)
        n_disp = torch.where(live, torch.minimum(p["block"][:, None],
                                                 dev_rem), 0)
        dev_rem = dev_rem - n_disp
        settled = fly
        fly = n_disp
        tokens_c = k + settled.sum(1)
        prod = prod + first_flag + settled
        done_rows = busy & (prod >= budget_row)
        busy = busy & ~done_rows
        completed_c = done_rows.sum(1)
        tokens = tokens + tokens_c
        completions = completions + completed_c

        # -- drain-retire: an emptied draining shard goes inactive
        shard_busy = busy.view(rows, shards, shard_slots).sum(2)
        state = torch.where((state == SHARD_DRAINING) & (shard_busy == 0),
                            SHARD_INACTIVE, state)
        serving_end = (state == SHARD_SERVING).sum(1)
        # integer serving-cycles; seconds = count * dt once at the end
        shard_s = shard_s + serving_end

        if trajectory:
            for key, value in zip(TRAJECTORY_KEYS, (
                    k, completed_c, tokens_c, ttft_sum - ttft0, queue,
                    serving_end, hits - hits0, misses - misses0)):
                outs[key].append(value)

    # requests still queued at episode end: their TTFT is already at least
    # (cycles - arrival), so the SLO debt below is a LOWER bound — a
    # policy cannot improve its score by refusing admission
    req_idx = torch.arange(r_max, device=device)
    unserved = ((req_idx[None, :] >= d[:, None])
                & (req_idx[None, :] < p["n_requests"][:, None]))
    pending_wait = ((cycles - p["arr_cycle"]).to(F64)
                    * p["cycle_dt"][:, None] - p["slo_s"][:, None])
    over_slo = over_slo + tree_sum(
        torch.where(unserved, torch.clamp(pending_wait, min=0.0), 0.0))
    summary = {
        "tokens": tokens,
        "time_over_slo_s": over_slo,
        "shard_changes": changes,
        "shard_seconds": shard_s.to(F64) * p["cycle_dt"],
        "completions": completions,
        "admitted": d,
        "final_queue": queue,
        "max_queue": max_q,
        "ttft_cycles_sum": ttft_sum,
        "pool_hits": hits,
        "pool_misses": misses,
    }
    if trajectory:
        summary.update({f"trajectory.{k}": torch.stack(v, dim=1)
                        for k, v in outs.items()})
    return summary


def run_twin_batch(
    batch: dict[str, np.ndarray],
    *,
    cycles: int,
    shards: int,
    shard_slots: int,
    r_max: int,
    t_max: int,
    entries: int,
    capacity: int,
    hidden: int,
    trajectory: bool = True,
    device: str = "cuda",
) -> dict[str, np.ndarray]:
    """A stacked numpy batch (``[B, ...]`` rows, the population's
    flattened ``[P·E]`` too) through :func:`_twin_rows` on ``device``:
    one upload, the device loop (inside the fluid twin's
    :data:`~..compiled.episode_guard`), one readback.  Summaries come
    back as numpy ``[B]`` arrays (float64 seconds, int32 counts),
    trajectories under ``"trajectory.<key>"`` as ``[B, cycles]``."""
    target = resolve_device(device)
    every = batch["control_every"].astype(np.int64)
    tick_cycles = frozenset(
        c for c in range(cycles) if bool(np.any(c % every == 0)))
    with torch.inference_mode():
        params = fluid.upload(batch, target)
        ewma = ewma_tables([float(a) for a in batch["alpha"]], capacity,
                           target)
        with fluid.episode_guard():
            out = _twin_rows(
                params, cycles=cycles, shards=shards,
                shard_slots=shard_slots, r_max=r_max, t_max=t_max,
                entries=entries, capacity=capacity, hidden=hidden,
                trajectory=trajectory, tick_cycles=tick_cycles,
                sticky=bool(np.any(batch["sticky"])),
                pooled_rows=bool(np.any(batch["use_pool"])), ewma=ewma,
            )
        return fluid.readback(out)


@dataclass
class TwinEpisode:
    """One compiled serving episode: summary + per-cycle trail."""

    config: TwinConfig
    summary: dict[str, Any]
    trajectory: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def tokens_per_second(self) -> float:
        return float(self.summary["tokens"]) / self.config.scenario.duration_s


def _group_key(config: TwinConfig) -> tuple:
    s = config.scenario
    hidden = (
        int(config.checkpoint.hidden) if config.policy == "learned" else 0
    )
    capacity = 2
    if config.policy == "learned":
        from ...learn.checkpoint import checkpoint_history

        capacity, _ = checkpoint_history(config.checkpoint)
    return (s.cycles, s.shards, s.shard_slots, capacity, hidden)


def run_twin_episodes(
    configs: Sequence[TwinConfig], trajectory: bool = True, *,
    device: str = "cuda",
) -> list[TwinEpisode]:
    """One batch on ``device`` for configs sharing loop shapes (cycles,
    plane geometry, history capacity, hidden width).  Request counts,
    tenant populations, and pool sizes pad to the batch max."""
    configs = list(configs)
    if not configs:
        return []
    keys = {_group_key(c) for c in configs}
    if len(keys) > 1:
        raise ValueError(
            f"one twin batch must share (cycles, shards, shard_slots,"
            f" history, hidden); got {sorted(keys)} — use"
            f" run_twin_grouped"
        )
    cycles, shards, shard_slots, capacity, hidden = keys.pop()
    r_max = max(1, max(c.scenario.total_requests() for c in configs))
    t_max = max(1, max(c.scenario.tenants for c in configs))
    entries = max(1, max(c.scenario.pool_entries for c in configs))
    rows = [encode_twin_config(c, r_max, t_max) for c in configs]
    theta_len = max(row["theta"].shape[0] for row in rows)
    for row in rows:
        if row["theta"].shape[0] < theta_len:
            row["theta"] = np.zeros(theta_len, np.float32)
    out = run_twin_batch(
        fluid.stack_rows(rows), cycles=cycles, shards=shards,
        shard_slots=shard_slots, r_max=r_max, t_max=t_max, entries=entries,
        capacity=capacity, hidden=hidden, trajectory=trajectory,
        device=device,
    )
    episodes = []
    for i, config in enumerate(configs):
        summary = {
            key: out[key][i].item() for key in SERVING_SUMMARY_KEYS
        }
        traj = (
            {
                key: np.asarray(out[f"trajectory.{key}"][i])
                for key in TRAJECTORY_KEYS
            }
            if trajectory
            else {}
        )
        episodes.append(
            TwinEpisode(config=config, summary=summary, trajectory=traj)
        )
    return episodes


def run_twin_grouped(
    configs: Sequence[TwinConfig], trajectory: bool = True, *,
    device: str = "cuda",
) -> list[TwinEpisode]:
    """:func:`run_twin_episodes` over mixed loop shapes — groups, runs
    one batch per group, scatters back into input order."""
    configs = list(configs)
    groups: dict[tuple, list[int]] = {}
    for index, config in enumerate(configs):
        groups.setdefault(_group_key(config), []).append(index)
    episodes: list[TwinEpisode | None] = [None] * len(configs)
    for indices in groups.values():
        for index, episode in zip(
            indices,
            run_twin_episodes([configs[i] for i in indices], trajectory,
                              device=device),
        ):
            episodes[index] = episode
    return episodes  # type: ignore[return-value]


def score_twin_summary(
    summary: dict[str, Any], scenario: ServingScenario
) -> dict:
    """A twin summary as a battery-style scorecard row in SERVING
    units — the lexicographic axes (tokens/s, then time-over-TTFT-SLO,
    then shard churn), plus the context a reviewer needs to read the
    row."""
    duration = scenario.duration_s
    return {
        "tokens_per_second": round(float(summary["tokens"]) / duration, 1),
        "time_over_slo_s": round(float(summary["time_over_slo_s"]), 3),
        "shard_changes": int(summary["shard_changes"]),
        "shard_seconds": round(float(summary["shard_seconds"]), 2),
        "completions": int(summary["completions"]),
        "admitted": int(summary["admitted"]),
        "final_queue": int(summary["final_queue"]),
        "max_queue": int(summary["max_queue"]),
        "pool_hits": int(summary["pool_hits"]),
        "pool_misses": int(summary["pool_misses"]),
        "cycles": scenario.cycles,
    }


def serving_lex_key(rows: Sequence[dict]) -> tuple:
    """Aggregate lexicographic ordering over serving score rows:
    MORE tokens/s first (negated), then LESS time-over-SLO, then LESS
    churn — smaller tuple wins, like the fluid ``_lex_score``."""
    return (
        -round(sum(r["tokens_per_second"] for r in rows), 1),
        round(sum(r["time_over_slo_s"] for r in rows), 3),
        sum(r["shard_changes"] for r in rows),
    )


def twin_config_for_point(point, scenario: ServingScenario) -> TwinConfig:
    """A sweep point's gate knobs applied to one serving scenario —
    how tuned-threshold reactive baselines re-run on serving worlds
    (:func:`~..sweep.run_sweep` routes ServingScenario jobs here).
    Forecaster points have no serving-twin analogue; callers filter to
    reactive points."""
    if point.policy != "reactive":
        raise ValueError(
            f"the serving twin sweeps reactive gate points only, got"
            f" policy={point.policy!r}"
        )
    return TwinConfig(
        scenario=scenario,
        scale_up_queue=point.scale_up_messages,
        scale_down_queue=point.scale_down_messages,
        up_cooldown_s=point.scale_up_cooldown,
        down_cooldown_s=point.scale_down_cooldown,
    )


__all__ = [
    "LEARNED_KIND",
    "REACTIVE_KIND",
    "SERVING_SUMMARY_KEYS",
    "TRAJECTORY_KEYS",
    "TwinConfig",
    "TwinEpisode",
    "encode_twin_config",
    "run_twin_batch",
    "run_twin_episodes",
    "run_twin_grouped",
    "score_twin_summary",
    "serving_lex_key",
    "twin_config_for_point",
]
