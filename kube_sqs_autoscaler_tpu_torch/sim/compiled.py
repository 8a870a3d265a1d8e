"""Compiled closed-loop simulator: batches of whole episodes on a device.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/compiled.py``, the fluid
twin.  The Python simulator (:mod:`.simulator`) drives the *real*
``ControlLoop`` one tick at a time — the right tool for fidelity, the
wrong one for search.  This module re-expresses the closed loop — fluid
queue world + threshold/cooldown gates + the EWMA/Holt/lstsq forecasters
+ the learned network — as tensor operations over a ``[B]`` batch of
encoded configurations, one loop over ticks, so hundreds of (scenario ×
policy × parameter) points run together (:func:`run_compiled`; the sweep
runner in :mod:`.sweep` and the trainers in :mod:`..learn` sit on top).

The reference's ``lax.scan`` over ticks is a Python loop here and its
``vmap`` is the batch dimension.  The whole batch is uploaded once (one
float64 buffer, sliced and cast on the device), the loop issues only
device work (no host read, no branch on a tensor: every per-row choice
is a ``torch.where``, every host branch is on the shared tick count), and
the outputs are read once.

**Fidelity is mechanically checked, not assumed.**  The loop reproduces
the reference semantics *bit for bit* where they are exact:

- world arithmetic runs in float64, one eager operation at a time (no
  fused multiply-add), expression for expression identical to
  :meth:`.simulator.Simulation.advance_world` (including the seed's
  separate constant-rate formula); tick times and arrival integrals are
  precomputed host-side by the *actual* Python ``FakeClock`` accumulation
  and ``arrivals_between`` implementations
  (:func:`_tick_times_and_arrivals`);
- gate decisions go through :func:`~..core.policy.gate_code` — the same
  branchless function the live ``gate_up``/``gate_down`` call — with the
  reference's inclusive thresholds, strictly-After cooldowns, up-cooling
  ``continue`` (down gate ``SKIPPED``), and boundary-no-op-refreshes-
  cooldown semantics;
- forecaster and network arithmetic runs in float32 through the batched
  row functions the live forecasters and ``LearnedPolicy`` call with one
  row (:func:`~..forecast.forecasters.ewma_level_rows`, ``holt_rows``,
  ``lstsq_rows``, :func:`~..learn.network.learned_decision_rows`), fed a
  history snapshot with ``DepthHistory.with_sample``'s append/roll
  semantics.

:func:`verify_fidelity` runs the compiled episodes against real-loop
Python episodes on the full scenario battery and asserts the replica
trajectory and gate decisions agree tick for tick, reporting any
mismatch through the same :class:`~.replay.Divergence` machinery the
flight recorder uses.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Sequence

import numpy as np
import torch

from ..core.events import TickRecord
from ..core.policy import (
    GATE_BY_CODE,
    GATE_COOLING,
    GATE_FIRE,
    GATE_SKIPPED,
    gate_code,
)
from ..device import resolve_device
from ..forecast.forecasters import (
    EwmaForecaster,
    HoltForecaster,
    LeastSquaresForecaster,
    ewma_level_rows,
    ewma_tables,
    holt_rows,
    lstsq_rows,
)
from ..learn.network import (
    FEATURE_ALPHA,
    FEATURE_WINDOW,
    hold_depth,
    learned_decision_rows,
    policy_features_rows,
)
from .replay import Divergence
from .simulator import SimConfig, SimResult, Simulation

F32 = torch.float32
F64 = torch.float64
I64 = torch.int64

#: forecaster name -> policy kind inside the loop (0 = reactive)
FORECASTER_KINDS = {"ewma": 1, "holt": 2, "lstsq": 3}

#: the learned policy's kind code (``learn/``): the loop calls the same
#: :func:`~..learn.network.learned_decision_rows` the live
#: ``LearnedPolicy`` calls with one row, so fidelity is checkable for
#: trained networks too.
LEARNED_KIND = 4

#: Context-manager factory entered around every episode batch's device
#: loop (its upload and readback stay outside).  ``nullcontext`` by
#: default; a caller that wants proof of no host synchronization inside
#: an episode sets one that turns ``torch.cuda.set_sync_debug_mode`` to
#: ``"error"`` for the loop's duration.
episode_guard: Any = contextlib.nullcontext


def _tick_times_and_arrivals(
    config: SimConfig, ticks: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-tick observation times and exact arrival integrals, host-side.

    The arrival process is state-free — ``∫ rate dt`` over each poll
    interval depends only on the tick times, which are known before the
    episode runs — so the integrals are evaluated here by the *actual*
    Python ``arrivals_between`` implementations and fed to the loop as
    inputs: the compiled world's arrivals are bit-identical to the Python
    world's by construction, and any :class:`~.scenarios.ArrivalProcess`
    — including :class:`~.replay.RecordedArrival` from a flight journal —
    sweeps without a compiled-side re-implementation.

    Times accumulate ``t += poll`` exactly like ``FakeClock.sleep``.
    Cached per ``(arrival, poll, ticks)`` (arrival processes are frozen
    dataclasses; an unhashable custom process skips the cache).
    """
    arrival = config.arrival_rate
    poll = config.loop.poll_interval
    try:
        return _cached_times_and_arrivals(arrival, poll, ticks)
    except TypeError:
        return _compute_times_and_arrivals(arrival, poll, ticks)


def _compute_times_and_arrivals(
    arrival: Any, poll: float, ticks: int
) -> tuple[np.ndarray, np.ndarray]:
    times = np.zeros(ticks, dtype=np.float64)
    arrived = np.zeros(ticks, dtype=np.float64)
    t = 0.0
    for k in range(ticks):
        t_prev, t = t, t + poll
        times[k] = t
        if not isinstance(arrival, (int, float)):
            arrived[k] = arrival.arrivals_between(t_prev, t)
    return times, arrived


_cached_times_and_arrivals = lru_cache(maxsize=128)(
    _compute_times_and_arrivals
)


def encode_config(config: SimConfig, slo_depth: float = 0.0) -> dict[str, Any]:
    """One :class:`~.simulator.SimConfig` as the loop's parameter row.

    Everything dynamic (thresholds, cooldowns, rates, forecast knobs) is a
    numpy scalar so rows stack into a batch; the per-tick times and
    arrival integrals ride along as ``(ticks,)`` arrays; the shape knobs —
    tick count, history capacity, and the learned network's hidden width
    — stay on the Python side (:func:`episode_ticks`,
    ``config.forecast_history``, ``config.learned_checkpoint.hidden``).

    ``seed_const`` marks the seed's plain-float ``arrival_rate`` config
    style, which uses a *different* depth-update expression than
    ``ConstantArrival`` (net-rate form vs arrived-minus-drained) —
    numerically equal but not bit-identical, and fidelity is bit-level.

    ``slo_depth`` feeds the loop's *in-episode* time-over-SLO
    accumulator, which only the summary-consuming paths (ES training,
    :mod:`..learn.rollout`) read; the default 0.0 is inert.
    """
    times, arrived = _tick_times_and_arrivals(config, episode_ticks(config))
    policy = config.loop.policy
    seed_const = isinstance(config.arrival_rate, (int, float))
    row: dict[str, Any] = {
        "times": times,
        "arrived": arrived,
        "seed_const": np.bool_(seed_const),
        "seed_rate": np.float64(
            config.arrival_rate if seed_const else 0.0
        ),
        "service_rate": np.float64(config.service_rate_per_replica),
        "initial_depth": np.float64(config.initial_depth),
        "initial_replicas": np.int32(config.initial_replicas),
        "min_pods": np.int32(config.min_pods),
        "max_pods": np.int32(config.max_pods),
        "scale_up_pods": np.int32(config.scale_up_pods),
        "scale_down_pods": np.int32(config.scale_down_pods),
        "scale_up_messages": np.int32(policy.scale_up_messages),
        "scale_down_messages": np.int32(policy.scale_down_messages),
        "scale_up_cooldown": np.float64(policy.scale_up_cooldown),
        "scale_down_cooldown": np.float64(policy.scale_down_cooldown),
        "policy_kind": np.int32(0),
        # forecast params (ignored by reactive rows but always present so
        # every row stacks); f32 to match the live forecasters exactly
        "horizon": np.float32(config.forecast_horizon),
        "alpha": np.float32(0.0),
        "beta": np.float32(0.0),
        "window": np.int32(1),
        "min_samples": np.int32(max(2, int(config.forecast_min_samples))),
        "conservative": np.bool_(config.forecast_conservative),
        # learned-policy row params (inert placeholders on other rows;
        # run_episodes pads theta to the batch's common length)
        "theta": np.zeros(1, np.float32),
        "hold": np.int32(
            hold_depth(policy.scale_up_messages, policy.scale_down_messages)
        ),
        "poll32": np.float32(config.loop.poll_interval),
        "slo_depth": np.float64(slo_depth),
    }
    if config.policy == "learned":
        checkpoint = config.learned_checkpoint
        if checkpoint is None:
            raise ValueError(
                "policy='learned' requires SimConfig.learned_checkpoint"
            )
        from ..learn.checkpoint import (
            TWIN_FLUID,
            require_no_knob_head,
            require_twin,
        )

        # every fluid-compiled consumer (sweep, rollout, counterfactual
        # replay) encodes through here: a serving-twin checkpoint's
        # weights mean shard counts, not replica gates
        require_twin(checkpoint, TWIN_FLUID, "the fluid compiled twin")
        # ...and a knob-headed theta has a wider output layer the loop's
        # fixed slicing would silently mis-read
        require_no_knob_head(checkpoint, "the fluid compiled twin")
        row["policy_kind"] = np.int32(LEARNED_KIND)
        row["theta"] = np.asarray(
            checkpoint.theta.detach().cpu().numpy(), np.float32
        )
        # the history features are part of the checkpoint schema — pinned
        # constants in learn.network, NOT the live forecaster defaults
        row["alpha"] = np.float32(FEATURE_ALPHA)
        row["window"] = np.int32(FEATURE_WINDOW)
    elif config.policy == "predictive":
        name = config.forecaster
        if name not in FORECASTER_KINDS:
            raise ValueError(
                f"unknown forecaster {name!r};"
                f" choose from {tuple(FORECASTER_KINDS)}"
            )
        row["policy_kind"] = np.int32(FORECASTER_KINDS[name])
        # parameter defaults come from the live forecaster dataclasses, so
        # the compiled path can't drift if a default is retuned
        if name == "ewma":
            row["alpha"] = np.float32(EwmaForecaster().alpha)
        elif name == "holt":
            holt = HoltForecaster()
            row["alpha"] = np.float32(holt.alpha)
            row["beta"] = np.float32(holt.beta)
        else:
            row["window"] = np.int32(LeastSquaresForecaster().window)
    elif config.policy != "reactive":
        raise ValueError(
            f"policy must be 'reactive' or 'predictive', got"
            f" {config.policy!r}"
        )
    return row


def episode_ticks(config: SimConfig) -> int:
    """Tick count of one episode — ``Simulation.run``'s exact formula."""
    return max(1, int(config.duration / config.loop.poll_interval))


def stack_rows(rows: Sequence[dict[str, Any]]) -> dict[str, np.ndarray]:
    """Encoded rows as one numpy batch (leading dimension ``B``)."""
    return {key: np.stack([row[key] for row in rows]) for key in rows[0]}


def upload(batch: dict[str, np.ndarray],
           device: torch.device) -> dict[str, torch.Tensor]:
    """A numpy batch on ``device`` in ONE host-to-device copy: every array
    as float64 columns of one buffer (float32, int32 and bool values are
    exact in float64), sliced and cast back on the device — integers to
    int64, booleans to bool, float32 and float64 kept."""
    rows = next(iter(batch.values())).shape[0]
    columns, layout = [], []
    offset = 0
    for key, value in batch.items():
        flat = np.asarray(value).reshape(rows, -1)
        columns.append(flat.astype(np.float64))
        layout.append((key, offset, flat.shape[1], value.shape[1:],
                       value.dtype))
        offset += flat.shape[1]
    buffer = torch.as_tensor(np.concatenate(columns, axis=1)).to(device)
    out = {}
    for key, start, width, shape, dtype in layout:
        part = buffer[:, start:start + width].reshape(rows, *shape)
        if dtype == np.bool_:
            part = part != 0
        elif np.issubdtype(dtype, np.integer):
            part = part.to(I64)
        elif dtype == np.float32:
            part = part.to(F32)
        out[key] = part.contiguous()
    return out


def readback(values: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Device results on the host in ONE device-to-host copy: every
    ``[B, ...]`` tensor as float64 columns of one buffer (int32-range
    integers and float32 values are exact in float64), cast back to the
    reference's output dtypes (int32 counts, float64 world values)."""
    keys = list(values)
    rows = values[keys[0]].shape[0]
    flat = [values[k].reshape(rows, -1).to(F64) for k in keys]
    host = torch.cat(flat, dim=1).cpu().numpy()
    out, offset = {}, 0
    for key, part in zip(keys, flat):
        width = part.shape[1]
        value = host[:, offset:offset + width].reshape(values[key].shape)
        if values[key].dtype in (I64, torch.int32, torch.bool):
            value = value.astype(np.int32)
        out[key] = value
        offset += width
    return out


def _snapshot(h: torch.Tensor, count: int, value: torch.Tensor):
    """``DepthHistory.with_sample`` on ``[B, C]`` rings holding ``count``
    samples each (a host count: every row of a fluid batch observes every
    tick): append at ``count`` while there is room, else shift in."""
    capacity = h.shape[1]
    if count < capacity:
        snap = h.clone()
        snap[:, count] = value
        return snap
    return torch.cat([h[:, 1:], value[:, None]], dim=1)


def _episode_rows(
    p: dict[str, torch.Tensor],
    ticks: int,
    capacity: int,
    predictive: bool,
    hidden: int = 0,
    trajectory: bool = True,
    *,
    kinds: frozenset = frozenset(),
    width: int = 1,
    ewma: Any = None,
) -> dict[str, torch.Tensor]:
    """``[B]`` closed-loop episodes, one loop over ticks, device work only.

    State = (clock, depth, replicas, cooldown stamps, forecast history,
    running max depth, episode-score accumulators) — the entire state the
    Python stack spreads across ``FakeClock``/``Simulation``/
    ``PolicyState``/``DepthHistory`` plus the summary arithmetic
    ``score_result`` runs on the host.

    ``hidden > 0`` runs the learned-policy branch over ``p["theta"]``
    (``[B, P]``) for rows of ``LEARNED_KIND``.  ``kinds`` names the
    forecasters present (only they are computed); ``width`` bounds the
    rows' least-squares windows; ``ewma`` holds the rows' EWMA tables.
    ``trajectory=False`` returns summaries only.
    """
    rows = p["times"].shape[0]
    device = p["times"].device
    learned = hidden > 0
    zero64 = torch.zeros(rows, dtype=F64, device=device)
    t = zero64  # FakeClock() starts at 0
    depth = p["initial_depth"]
    replicas = p["initial_replicas"]
    last_up = zero64  # initial_state(now=0): startup grace
    last_down = zero64
    h_t = torch.zeros(rows, capacity, dtype=F64, device=device)
    h_d = torch.zeros(rows, capacity, dtype=F64, device=device)
    h_count = 0
    max_depth = p["initial_depth"]
    prev_obs = torch.full((rows,), -1, dtype=I64, device=device)
    over_slo = zero64
    prev_reps = p["initial_replicas"]
    changes = torch.zeros(rows, dtype=I64, device=device)
    replica_s = zero64
    kind = p["policy_kind"]
    history_n = torch.arange(1, ticks + 1, device=device).clamp(max=capacity)
    outs: dict[str, list[torch.Tensor]] = {
        k: [] for k in ("t", "observed", "decision", "up", "down",
                        "replicas_before", "replicas_after")
    }
    for k in range(ticks):
        t_new = p["times"][:, k]
        arrived = p["arrived"][:, k]
        # -- sleep first, then poll (main.go:41): the tick's clock reads
        # all happen at t_new
        dt = t_new - t
        reps_f = replicas.to(F64)
        # -- world integration, both config styles (advance_world)
        net_rate = p["seed_rate"] - reps_f * p["service_rate"]
        seed_depth = torch.clamp(depth + net_rate * dt, min=0.0)
        drained = reps_f * p["service_rate"] * dt
        gen_depth = torch.clamp(depth + arrived - drained, min=0.0)
        depth_new = torch.where(p["seed_const"], seed_depth, gen_depth)
        max_depth = torch.maximum(max_depth, depth_new)
        observed = torch.floor(depth_new).to(I64)

        # -- episode-score accumulators, the host scorer's exact forms:
        # time_over is a left rule over the observation timeline
        # (prev_obs starts at -1, so the pre-first-observation interval
        # never counts); replica_changes counts ticks whose ENTERING count
        # changed; replica-seconds integrates the replica count
        over_slo = over_slo + dt * (prev_obs > p["slo_depth"])
        changes = changes + (replicas != prev_reps).to(I64)
        replica_s = replica_s + reps_f * dt

        decision = observed
        if predictive or learned:
            # -- history snapshot including the current observation:
            # DepthHistory.with_sample's semantics, f64 here and cast to
            # f32 at the forecaster boundary, centered on the newest
            # sample in f64 first (_center_times)
            snap_t = _snapshot(h_t, h_count, t_new)
            snap_d = _snapshot(h_d, h_count, observed.to(F64))
            h_count = min(h_count + 1, capacity)
            n = history_n[k].expand(rows)
            times32 = (snap_t - t_new[:, None]).to(F32)
            depths32 = snap_d.to(F32)
            if predictive:
                predicted = torch.zeros(rows, dtype=F32, device=device)
                if 1 in kinds:
                    pred = torch.clamp(
                        ewma_level_rows(depths32, n, *ewma), min=0.0)
                    predicted = torch.where(kind == 1, pred, predicted)
                if 2 in kinds:
                    pred = holt_rows(times32, depths32, n, h_count,
                                     p["horizon"], p["alpha"], p["beta"])
                    predicted = torch.where(kind == 2, pred, predicted)
                if 3 in kinds:
                    pred = lstsq_rows(times32, depths32, n, p["horizon"],
                                      p["window"], width)
                    predicted = torch.where(kind == 3, pred, predicted)
                # PredictivePolicy: max(0, int(round(.))), conservative
                # gates see max(observed, forecast), reactive warm-up
                # below min_samples
                prediction = torch.clamp(torch.round(predicted).to(I64),
                                         min=0)
                effective = torch.where(
                    p["conservative"], torch.maximum(observed, prediction),
                    prediction)
                forecaster_row = (kind >= 1) & (kind <= 3)
                decision = torch.where(
                    forecaster_row & (n >= p["min_samples"]), effective,
                    observed)
            if learned:
                # remaining-cooldown fractions: the f64 twin of the live
                # mirror's host-side cooldown_fraction, cast f32 where the
                # live path casts
                frac32 = []
                for last, cooldown in (
                        (last_up, p["scale_up_cooldown"]),
                        (last_down, p["scale_down_cooldown"])):
                    remaining = (last + cooldown) - t_new
                    positive = cooldown > 0
                    frac32.append(torch.where(
                        positive & (remaining > 0),
                        remaining / torch.where(positive, cooldown, 1.0),
                        0.0).to(F32))
                features = policy_features_rows(
                    times32, depths32, n, observed, replicas, frac32[0],
                    frac32[1], p["scale_up_messages"], p["max_pods"],
                    p["poll32"], ewma, p["window"], width)
                learned_dec = learned_decision_rows(
                    p["theta"], features, n, observed,
                    p["scale_up_messages"], p["scale_down_messages"],
                    p["hold"], p["min_samples"], hidden=hidden)
                decision = torch.where(kind == LEARNED_KIND, learned_dec,
                                       decision)
            h_t, h_d = snap_t, snap_d

        # -- gates: same gate_code as the live gate_up/gate_down; the
        # up-cooling `continue` marks the down gate SKIPPED (main.go:54);
        # FIRE refreshes the matching cooldown stamp (boundary no-ops
        # included — PodAutoScaler returns success on clamp)
        up_code = gate_code(decision >= p["scale_up_messages"], t_new,
                            last_up, p["scale_up_cooldown"])
        up_fire = up_code == GATE_FIRE
        reps1 = torch.where(
            up_fire & (replicas < p["max_pods"]),
            torch.minimum(replicas + p["scale_up_pods"], p["max_pods"]),
            replicas)
        last_up = torch.where(up_fire, t_new, last_up)
        down_code = torch.where(
            up_code == GATE_COOLING, GATE_SKIPPED,
            gate_code(decision <= p["scale_down_messages"], t_new,
                      last_down, p["scale_down_cooldown"]))
        down_fire = down_code == GATE_FIRE
        reps2 = torch.where(
            down_fire & (reps1 > p["min_pods"]),
            torch.maximum(reps1 - p["scale_down_pods"], p["min_pods"]),
            reps1)
        last_down = torch.where(down_fire, t_new, last_down)

        if trajectory:
            for key, value in (("t", t_new), ("observed", observed),
                               ("decision", decision), ("up", up_code),
                               ("down", down_code),
                               ("replicas_before", replicas),
                               ("replicas_after", reps2)):
                outs[key].append(value)
        t, depth, prev_reps, replicas = t_new, depth_new, replicas, reps2
        prev_obs = observed
    summary = {
        "final_depth": depth,
        "final_replicas": replicas,
        "max_depth": max_depth,
        "time_over_slo": over_slo,
        "replica_changes": changes,
        "replica_seconds": replica_s,
    }
    if not trajectory:
        return summary
    return {**{k: torch.stack(v, dim=1) for k, v in outs.items()},
            **summary}


def run_batch(
    batch: dict[str, np.ndarray],
    ticks: int,
    capacity: int,
    predictive: bool,
    hidden: int = 0,
    trajectory: bool = True,
    *,
    device: str = "cuda",
) -> dict[str, np.ndarray]:
    """A stacked numpy batch through :func:`_episode_rows` on ``device``:
    one upload, the device loop (inside :data:`episode_guard`), one
    readback.  Float64 world values come back as float64, counts and
    codes as int32."""
    target = resolve_device(device)
    kinds = frozenset(int(k) for k in np.unique(batch["policy_kind"]))
    width = int(np.max(batch["window"]))
    with torch.inference_mode():
        params = upload(batch, target)
        ewma = ewma_tables([float(a) for a in batch["alpha"]], capacity,
                           target)
        with episode_guard():
            out = _episode_rows(params, ticks, capacity, predictive, hidden,
                                trajectory, kinds=kinds, width=width,
                                ewma=ewma)
        return readback(out)


@dataclass
class CompiledEpisode:
    """One compiled episode: the battery-facing result + the per-tick
    decision trail the fidelity gate checks."""

    result: SimResult
    times: np.ndarray
    observed: np.ndarray
    decision: np.ndarray
    up_codes: np.ndarray
    down_codes: np.ndarray
    replicas_before: np.ndarray
    replicas_after: np.ndarray

    def gates(self, index: int) -> tuple[Any, Any]:
        """(up, down) as :class:`~..core.policy.Gate` for tick ``index``."""
        return (
            GATE_BY_CODE[int(self.up_codes[index])],
            GATE_BY_CODE[int(self.down_codes[index])],
        )


def run_episodes(configs: Sequence[SimConfig], *,
                 device: str = "cuda") -> list[CompiledEpisode]:
    """Run a batch of configs through the compiled simulator on
    ``device`` (the card by default).

    One batch for the whole list.  All configs must share a tick count
    (``duration / poll_interval``) and a ``forecast_history`` capacity —
    those are loop shapes; the sweep runner groups by them.
    """
    configs = list(configs)
    if not configs:
        return []
    ticks_set = {episode_ticks(c) for c in configs}
    if len(ticks_set) > 1:
        raise ValueError(
            f"all configs in one compiled batch must share a tick count,"
            f" got {sorted(ticks_set)}; group by duration/poll first"
        )
    cap_set = {int(c.forecast_history) for c in configs}
    if len(cap_set) > 1:
        raise ValueError(
            f"all configs in one compiled batch must share forecast_history,"
            f" got {sorted(cap_set)}; group by capacity first"
        )
    ticks = ticks_set.pop()
    capacity = cap_set.pop()
    predictive = any(c.policy == "predictive" for c in configs)
    hidden_set = {
        int(c.learned_checkpoint.hidden)
        for c in configs
        if c.policy == "learned" and c.learned_checkpoint is not None
    }
    if len(hidden_set) > 1:
        raise ValueError(
            f"all learned configs in one compiled batch must share a hidden"
            f" width (a compiled shape), got {sorted(hidden_set)}; group"
            f" by hidden first"
        )
    hidden = hidden_set.pop() if hidden_set else 0
    if (predictive or hidden) and capacity < 2:
        # DepthHistory enforces this on the live path; match it
        raise ValueError(f"forecast_history must be >= 2, got {capacity}")
    rows = [encode_config(c) for c in configs]
    # theta rows must stack: pad the non-learned placeholders (length 1)
    # to the batch's learned parameter length
    theta_len = max(row["theta"].shape[0] for row in rows)
    for row in rows:
        if row["theta"].shape[0] < theta_len:
            row["theta"] = np.zeros(theta_len, np.float32)
    out = run_batch(stack_rows(rows), ticks, capacity, predictive, hidden,
                    device=device)
    episodes = []
    for i in range(len(configs)):
        timeline = [
            (float(t), int(d), int(r))
            for t, d, r in zip(
                out["t"][i], out["observed"][i], out["replicas_before"][i]
            )
        ]
        result = SimResult(
            timeline=timeline,
            final_replicas=int(out["final_replicas"][i]),
            final_depth=float(out["final_depth"][i]),
            max_depth=float(out["max_depth"][i]),
            ticks=ticks,
        )
        episodes.append(
            CompiledEpisode(
                result=result,
                times=out["t"][i],
                observed=out["observed"][i],
                decision=out["decision"][i],
                up_codes=out["up"][i],
                down_codes=out["down"][i],
                replicas_before=out["replicas_before"][i],
                replicas_after=out["replicas_after"][i],
            )
        )
    return episodes


def run_episodes_grouped(
    configs: Sequence[SimConfig], *, device: str = "cuda",
) -> list[CompiledEpisode]:
    """:func:`run_episodes` over configs of *mixed* loop shapes.

    Tick count, history capacity, and the learned network's hidden width
    are shapes, so one batch can only take configs that share them; this
    helper groups by ``(ticks, capacity, hidden)``, runs one batch per
    group, and scatters the episodes back into input order.  Both
    :func:`verify_fidelity` and the sweep runner (:mod:`.sweep`) batch
    through here.
    """
    configs = list(configs)
    groups: dict[tuple[int, int, int], list[int]] = {}
    for index, config in enumerate(configs):
        hidden = (
            int(config.learned_checkpoint.hidden)
            if config.policy == "learned"
            and config.learned_checkpoint is not None
            else 0
        )
        key = (episode_ticks(config), int(config.forecast_history), hidden)
        groups.setdefault(key, []).append(index)
    episodes: list[CompiledEpisode | None] = [None] * len(configs)
    for indices in groups.values():
        for index, episode in zip(
            indices, run_episodes([configs[i] for i in indices],
                                  device=device)
        ):
            episodes[index] = episode
    return episodes  # type: ignore[return-value]  # every slot filled


def run_compiled(configs: Sequence[SimConfig], *,
                 device: str = "cuda") -> list[SimResult]:
    """Batch of configs -> battery-compatible :class:`SimResult`\\ s."""
    return [episode.result
            for episode in run_episodes(configs, device=device)]


def run_compiled_one(config: SimConfig, *, device: str = "cuda") -> SimResult:
    """Single-config convenience wrapper around :func:`run_compiled`."""
    return run_compiled([config], device=device)[0]


class _Recorder:
    def __init__(self) -> None:
        self.records: list[TickRecord] = []

    def on_tick(self, record: TickRecord) -> None:
        self.records.append(record)


@dataclass
class FidelityReport:
    """Outcome of one compiled-vs-real fidelity pass."""

    episodes: int
    ticks: int
    divergences: list[tuple[str, Divergence]]

    @property
    def ok(self) -> bool:
        return not self.divergences

    def format_divergences(self, limit: int = 10) -> list[str]:
        """Human-readable lines in the flight recorder's divergence format
        (shared shape with :meth:`~.replay.ReplayResult.
        format_divergences`, prefixed with the episode label)."""
        return [
            f"{label}: tick {d.tick}: {d.tick_field} recorded={d.recorded!r}"
            f" replayed={d.replayed!r}"
            for label, d in self.divergences[:limit]
        ]


def _fidelity_configs(
    scenarios, forecasters: Sequence[str]
) -> list[tuple[str, SimConfig]]:
    episodes: list[tuple[str, SimConfig]] = []
    for scenario in scenarios:
        base = dict(
            arrival_rate=scenario.arrival,
            service_rate_per_replica=scenario.service_rate_per_replica,
            duration=scenario.duration,
            initial_replicas=scenario.initial_replicas,
            min_pods=scenario.min_pods,
            max_pods=scenario.max_pods,
            loop=scenario.loop,
        )
        episodes.append((f"{scenario.name}/reactive", SimConfig(**base)))
        for name in forecasters:
            episodes.append(
                (
                    f"{scenario.name}/predictive:{name}",
                    SimConfig(
                        **base,
                        policy="predictive",
                        forecaster=name,
                        forecast_horizon=scenario.horizon,
                    ),
                )
            )
    return episodes


def verify_fidelity(
    scenarios=None,
    forecasters: Sequence[str] = ("ewma", "holt", "lstsq"),
    extra_episodes: Sequence[tuple[str, SimConfig]] = (),
    *,
    device: str = "cuda",
) -> FidelityReport:
    """Assert the compiled loop reproduces the real-``ControlLoop`` sim.

    Runs reactive plus each requested forecaster over every scenario
    (default: the full :func:`~.evaluate.default_battery`), once through
    the Python closed-loop simulator (the real production stack on a
    ``FakeClock``) and once through the compiled loop, both computing on
    ``device``, and compares **tick for tick**: observed depth, the depth
    the gates thresholded (``decision_messages``), both gate outcomes,
    and the replica count entering each tick — plus the episode's final
    replicas and max depth.  Any mismatch is a :class:`~.replay.
    Divergence`; callers gate on :attr:`FidelityReport.ok`.

    ``extra_episodes`` extends the gate with arbitrary ``(label,
    SimConfig)`` pairs (learned checkpoints, swept grid points).
    Episodes are batched by shape (tick count × history capacity ×
    hidden width), so mixed durations/capacities are fine.
    """
    if scenarios is None:
        from .evaluate import default_battery

        scenarios = default_battery()
    episodes = _fidelity_configs(scenarios, forecasters)
    episodes.extend(extra_episodes)
    compiled = run_episodes_grouped([config for _, config in episodes],
                                    device=device)
    divergences: list[tuple[str, Divergence]] = []
    total_ticks = 0
    for (label, config), comp in zip(episodes, compiled):
        recorder = _Recorder()
        result = Simulation(config, extra_observers=(recorder,),
                            device=device).run()
        total_ticks += result.ticks
        for k, record in enumerate(recorder.records):
            up, down = comp.gates(k)
            checks = (
                ("num_messages", record.num_messages, int(comp.observed[k])),
                (
                    "decision_messages",
                    record.decision_messages,
                    int(comp.decision[k]),
                ),
                ("up", record.up, up),
                ("down", record.down, down),
                ("replicas", result.timeline[k][2], int(comp.replicas_before[k])),
            )
            for name, recorded, replayed in checks:
                if recorded != replayed:
                    divergences.append(
                        (label, Divergence(k, name, recorded, replayed))
                    )
        if result.final_replicas != comp.result.final_replicas:
            divergences.append(
                (
                    label,
                    Divergence(
                        result.ticks,
                        "final_replicas",
                        result.final_replicas,
                        comp.result.final_replicas,
                    ),
                )
            )
        # max depth is float64 world state; everything upstream of it is
        # bit-exact, so a relative tolerance at f64 noise level is the
        # honest check
        if not math.isclose(
            result.max_depth, comp.result.max_depth, rel_tol=1e-9, abs_tol=1e-6
        ):
            divergences.append(
                (
                    label,
                    Divergence(
                        result.ticks,
                        "max_depth",
                        result.max_depth,
                        comp.result.max_depth,
                    ),
                )
            )
    return FidelityReport(
        episodes=len(episodes), ticks=total_ticks, divergences=divergences
    )
