"""Counterfactual replay: re-drive the control loop from a flight journal.

Closes the loop between the live controller and the scenario battery
(BLITZSCALE's fast-postmortem motivation, arxiv 2412.17246; KIS-S's
trace-driven policy evaluation, arxiv 2507.07932).  Two modes:

- :func:`replay` — **deterministic re-drive**: feed the journal's recorded
  observations (and recorded actuation failures) back through the *real*
  ``ControlLoop`` on a ``FakeClock`` pinned to the recorded tick times,
  and assert the loop reproduces the recorded gate decisions and replica
  trajectory tick-for-tick.  Any divergence means the build no longer
  makes the decisions the journal documents — the regression gate behind
  the replay demo.
- :func:`counterfactual` — **re-score under another policy**: infer the
  episode's arrival process from the recorded depths and replica
  trajectory (piecewise-constant rates, exact at observation points),
  rebuild the closed-loop world, and run any policy/forecaster through it
  (``bench.py --suite replay``), scored on the same
  :func:`~.evaluate.score_result` numbers as the synthetic battery.

Journals record what the loop *saw*; the world inference needs what the
world *was* (service rate, scaler bounds), which sim-recorded journals
carry in their header meta (:func:`sim_journal_meta`).  Live journals can
replay mode 1 with just the controller config; mode 2 additionally needs
the ``world`` meta block.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/replay.py``: it reads
the port's own journals (the same line format).  A predictive or learned
episode computes on the ``device`` the caller names (the card by
default); a reactive one touches no device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any, Sequence

from ..core.clock import FakeClock
from ..core.events import MultiObserver, TickObserver, TickRecord
from ..core.loop import ControlLoop, LoopConfig
from ..core.policy import PolicyConfig, initial_state
from ..core.resilience import ResilienceConfig
from ..core.types import MetricError, ScaleError
from .simulator import SimConfig, Simulation

#: Record fields whose recorded/replayed values must match tick-for-tick.
#: ``stale`` is a decision: a held-depth tick proceeds to the gates while
#: a fail-static tick ends at the observation, and the two must replay as
#: what they were.
DECISION_FIELDS = (
    "metric_error",
    "num_messages",
    "decision_messages",
    "stale",
    "up",
    "down",
    "up_error",
    "down_error",
)


@dataclass(frozen=True)
class Divergence:
    """One recorded-vs-replayed mismatch."""

    tick: int
    tick_field: str
    recorded: Any
    replayed: Any


@dataclass
class ReplayResult:
    """Outcome of one deterministic re-drive."""

    ticks: int
    divergences: list[Divergence]
    #: replicas entering each tick (same alignment as the sim timeline)
    start_replicas: list[int]
    final_replicas: int
    #: True when the journal's world meta had no initial_replicas (live
    #: journals: the controller cannot know the deployment's size without
    #: an extra RPC) — the replica trajectory then starts from an ASSUMED
    #: 1 and is relative, not absolute; gate decisions are unaffected
    #: (they threshold depth only).
    assumed_initial_replicas: bool = False
    records: list[TickRecord] = field(repr=False, default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.divergences

    def format_divergences(self, limit: int = 10) -> list[str]:
        """Human-readable divergence lines (shared by the replay CLI and
        ``bench.py --suite replay`` so the report format cannot drift)."""
        return [
            f"tick {d.tick}: {d.tick_field} recorded={d.recorded!r}"
            f" replayed={d.replayed!r}"
            for d in self.divergences[:limit]
        ]


class _ScriptedSource:
    """MetricSource replaying the journal's observations, one per tick.

    With ``raise_for_stale`` (journals recorded under a stale-depth
    hold), a recorded-stale tick replays as the *poll failure* it was:
    the replayed loop's own stale hold then regenerates the held depth
    from its last fresh observation — the same mechanism, not a
    transcript of its output.  Without it (reference journals), stale
    records never appear and the flag is moot.
    """

    def __init__(self, raise_for_stale: bool = False) -> None:
        self.record: TickRecord | None = None
        self.raise_for_stale = raise_for_stale

    def num_messages(self) -> int:
        record = self.record
        assert record is not None, "arm() must run before each tick"
        if record.metric_error is not None:
            raise MetricError(record.metric_error)
        if record.stale and self.raise_for_stale:
            raise MetricError("replayed stale-held poll failure")
        assert record.num_messages is not None
        return record.num_messages


class _ScriptedScaler:
    """Bounded step scaler with per-tick scripted failures.

    Mirrors ``PodAutoScaler``'s clamp semantics (boundary no-op = success)
    but holds replicas in memory and raises the journal's recorded error
    strings, so a replayed actuation failure reproduces the recorded
    record byte-for-byte and leaves policy state unadvanced, exactly as
    the live episode did.
    """

    def __init__(
        self,
        initial: int,
        min_pods: int,
        max_pods: int,
        scale_up_pods: int,
        scale_down_pods: int,
    ) -> None:
        self.replicas = initial
        self.min_pods = min_pods
        self.max_pods = max_pods
        self.scale_up_pods = scale_up_pods
        self.scale_down_pods = scale_down_pods
        self._up_error: str | None = None
        self._down_error: str | None = None

    def arm(self, up_error: str | None, down_error: str | None) -> None:
        self._up_error = up_error
        self._down_error = down_error

    def scale_up(self) -> None:
        if self._up_error is not None:
            raise ScaleError(self._up_error)
        self.replicas = min(self.max_pods, self.replicas + self.scale_up_pods)

    def scale_down(self) -> None:
        if self._down_error is not None:
            raise ScaleError(self._down_error)
        self.replicas = max(
            self.min_pods, self.replicas - self.scale_down_pods
        )


class _Recorder:
    def __init__(self) -> None:
        self.records: list[TickRecord] = []

    def on_tick(self, record: TickRecord) -> None:
        self.records.append(record)


def sim_journal_meta(config: SimConfig) -> dict[str, Any]:
    """Journal header meta for a simulated episode: everything replay and
    counterfactual re-scoring need to re-drive it."""
    policy = config.loop.policy
    meta: dict[str, Any] = {
        "source": "sim",
        "t0": 0.0,
        "poll_interval": config.loop.poll_interval,
        "policy_config": {
            "scale_up_messages": policy.scale_up_messages,
            "scale_down_messages": policy.scale_down_messages,
            "scale_up_cooldown": policy.scale_up_cooldown,
            "scale_down_cooldown": policy.scale_down_cooldown,
        },
        "policy": config.policy,
        "world": {
            "service_rate_per_replica": config.service_rate_per_replica,
            "initial_depth": config.initial_depth,
            "initial_replicas": config.initial_replicas,
            "min_pods": config.min_pods,
            "max_pods": config.max_pods,
            "scale_up_pods": config.scale_up_pods,
            "scale_down_pods": config.scale_down_pods,
            "duration": config.duration,
        },
    }
    if config.policy == "predictive":
        meta["forecast"] = {
            "forecaster": config.forecaster,
            "horizon": config.forecast_horizon,
            "history": config.forecast_history,
            "min_samples": config.forecast_min_samples,
            "conservative": config.forecast_conservative,
        }
    if config.policy == "learned" and config.learned_checkpoint is not None:
        # the hash names which weights ran; replay demands a checkpoint
        # matching it (weights are an artifact, not journal content)
        meta["learn"] = {
            "checkpoint_hash": config.learned_checkpoint.hash,
            "hidden": int(config.learned_checkpoint.hidden),
            "history": config.forecast_history,
            "min_samples": config.forecast_min_samples,
        }
    if config.resilience is not None and config.resilience.enabled:
        # replay needs the stale TTL to re-derive held-depth decisions;
        # the rest documents what could appear in the tick lines
        meta["resilience"] = {
            "metric_retries": config.resilience.metric_retries,
            "metric_timeout": config.resilience.metric_timeout,
            "scaler_retries": config.resilience.scaler_retries,
            "scaler_timeout": config.resilience.scaler_timeout,
            "breaker_failures": config.resilience.breaker_failures,
            "breaker_reset": config.resilience.breaker_reset,
            "stale_depth_ttl": config.resilience.stale_depth_ttl,
        }
    return meta


def loop_config_from_meta(meta: dict[str, Any]) -> LoopConfig:
    policy = meta.get("policy_config") or {}
    return LoopConfig(
        poll_interval=float(meta.get("poll_interval", 5.0)),
        policy=PolicyConfig(
            scale_up_messages=int(policy.get("scale_up_messages", 100)),
            scale_down_messages=int(policy.get("scale_down_messages", 10)),
            scale_up_cooldown=float(policy.get("scale_up_cooldown", 10.0)),
            scale_down_cooldown=float(policy.get("scale_down_cooldown", 30.0)),
        ),
    )


def _depth_policy_from_meta(
    meta: dict[str, Any],
    checkpoint: Any = None,
    device: str = "cuda",
) -> tuple[Any, TickObserver | None]:
    """(depth policy, its history observer) for a predictive or learned
    journal; (None, None) for reactive."""
    if meta.get("policy") == "learned":
        # Weights are a deployment artifact, not journal content — the
        # journal records only their content hash, so re-driving a
        # learned episode needs the caller to supply the checkpoint and
        # we verify it is THE one that ran.
        learn = meta.get("learn") or {}
        recorded_hash = learn.get("checkpoint_hash")
        if checkpoint is None:
            raise ValueError(
                f"this journal was recorded under a learned policy"
                f" (checkpoint hash {recorded_hash!r}); pass the matching"
                f" checkpoint via checkpoint= to replay it"
            )
        if recorded_hash is not None and checkpoint.hash != recorded_hash:
            raise ValueError(
                f"checkpoint hash {checkpoint.hash!r} does not match the"
                f" journal's recorded weights {recorded_hash!r} — replaying"
                f" different weights would silently re-score a different"
                f" policy"
            )
        from ..forecast import DepthHistory
        from ..learn import LearnedPolicy
        from ..learn.checkpoint import checkpoint_history, on_device

        default_history, default_min = checkpoint_history(checkpoint)
        config = loop_config_from_meta(meta)
        world = meta.get("world") or {}
        policy = LearnedPolicy(
            on_device(checkpoint, device),
            policy=config.policy,
            poll_interval=config.poll_interval,
            max_pods=int(world.get("max_pods", 5)),
            min_pods=int(world.get("min_pods", 1)),
            scale_up_pods=int(world.get("scale_up_pods", 1)),
            scale_down_pods=int(world.get("scale_down_pods", 1)),
            # Live journals omit initial_replicas (the controller never
            # knows the deployment's size; see cli._journal_meta) and the
            # live mirror starts at min_pods — start the replay mirror at
            # the same place or decisions diverge on a faithful journal.
            initial_replicas=int(
                world.get("initial_replicas", world.get("min_pods", 1))
            ),
            history=DepthHistory(
                capacity=int(learn.get("history", default_history))
            ),
            min_samples=int(learn.get("min_samples", default_min)),
        )
        # the policy is its own observer (history + replica/cooldown mirror)
        return policy, policy
    if meta.get("policy") != "predictive":
        return None, None
    # Lazy import: reactive replays stay torch-free, like the live CLI.
    from ..device import resolve_device
    from ..forecast import DepthHistory, PredictivePolicy, make_forecaster

    # the loop falls back to the observed depth when a depth policy
    # raises: a missing card must fail here instead
    resolve_device(device)
    forecast = meta.get("forecast") or {}
    history = DepthHistory(capacity=int(forecast.get("history", 128)))
    policy = PredictivePolicy(
        make_forecaster(forecast.get("forecaster", "holt"), device=device),
        history,
        horizon=float(forecast.get("horizon", 60.0)),
        min_samples=int(forecast.get("min_samples", 3)),
        conservative=bool(forecast.get("conservative", True)),
    )
    return policy, history


def replay(
    records: Sequence[TickRecord],
    meta: dict[str, Any],
    checkpoint: Any = None,
    *,
    device: str = "cuda",
) -> ReplayResult:
    """Deterministically re-drive ``ControlLoop`` over a recorded episode.

    The clock is pinned to each record's recorded start before its tick
    runs, so cooldown arithmetic sees exactly the recorded instants —
    journals from the simulator replay bit-exactly; wall-clock journals
    replay to within the (sub-tick) drift of their in-tick clock reads.

    Journals recorded under a stale-depth hold (``meta["resilience"]``
    carries ``stale_depth_ttl``) replay the hold through the real
    mechanism: recorded-stale ticks re-raise as poll failures and the
    replayed loop's own hold regenerates the held depth, its TTL-expiry
    decisions, and — critically — the forecaster-history *skip* the live
    loop applied (feeding held depths to the history would forecast from
    data the live policy never saw).  Retries/timeouts/breaker are
    deliberately NOT re-driven (their backoff sleeps would need the live
    RNG stream replayed draw-for-draw); their in-tick clock consumption
    falls under the same sub-tick-drift caveat as wall-clock reads.
    """
    records = list(records)
    if not records:
        raise ValueError("cannot replay an empty journal")
    config = loop_config_from_meta(meta)
    t0 = float(meta.get("t0", records[0].start - config.poll_interval))
    world = meta.get("world") or {}
    scaler = _ScriptedScaler(
        initial=int(world.get("initial_replicas", 1)),
        min_pods=int(world.get("min_pods", 1)),
        max_pods=int(world.get("max_pods", 5)),
        scale_up_pods=int(world.get("scale_up_pods", 1)),
        scale_down_pods=int(world.get("scale_down_pods", 1)),
    )
    stale_ttl = float(
        (meta.get("resilience") or {}).get("stale_depth_ttl", 0.0) or 0.0
    )
    source = _ScriptedSource(raise_for_stale=stale_ttl > 0)
    depth_policy, history = _depth_policy_from_meta(meta, checkpoint,
                                                    device)
    recorder = _Recorder()
    observers: list[TickObserver] = [recorder]
    if history is not None:
        observers.insert(0, history)
    clock = FakeClock(start=t0)
    loop = ControlLoop(
        scaler,
        source,
        config,
        clock=clock,
        observer=MultiObserver(observers),
        depth_policy=depth_policy,
        resilience=(
            ResilienceConfig(stale_depth_ttl=stale_ttl)
            if stale_ttl > 0
            else None
        ),
    )
    state = initial_state(clock.now())
    start_replicas: list[int] = []
    for record in records:
        clock.advance(max(0.0, record.start - clock.now()))
        source.record = record
        scaler.arm(record.up_error, record.down_error)
        start_replicas.append(scaler.replicas)
        state = loop.tick(state)

    divergences: list[Divergence] = []
    for index, (recorded, replayed) in enumerate(
        zip(records, recorder.records)
    ):
        for name in DECISION_FIELDS:
            a, b = getattr(recorded, name), getattr(replayed, name)
            if a != b:
                divergences.append(Divergence(index, name, a, b))
    return ReplayResult(
        ticks=len(recorder.records),
        divergences=divergences,
        start_replicas=start_replicas,
        final_replicas=scaler.replicas,
        assumed_initial_replicas="initial_replicas" not in world,
        records=recorder.records,
    )


def replay_journal(path: str, checkpoint: Any = None, *,
                   device: str = "cuda") -> ReplayResult:
    """:func:`replay` straight from a journal file.

    A journal accumulates one episode per controller restart (each restart
    appends a fresh header); episodes are separate loop runs with their own
    startup-grace state and clock epoch, so they cannot be replayed as one.
    This replays the journal's **last** episode — the natural postmortem
    target; use :func:`~..obs.journal.read_journal_episodes` + :func:`replay`
    to examine earlier ones.

    Size rotation splits one episode across files: the live file then opens
    with a *continuation* header, and the episode's head lives in
    ``<path>.1``.  That head is rejoined automatically; if it was itself
    rotated away (more than one rotation per episode with one kept
    generation), replay refuses rather than re-applying a bogus
    startup-grace window mid-episode.
    """
    import os

    from ..obs.journal import read_journal_episodes

    non_empty = [(m, r) for m, r in read_journal_episodes(path) if r]
    if not non_empty:
        raise ValueError(f"journal {path!r} holds no tick records")
    meta, records = non_empty[-1]
    if meta.get("_continuation"):
        rotated = path + ".1"
        # the head is the rotated file's LAST episode, empty or not: a
        # restart header that was rotated out before its first tick landed
        # is still the episode boundary — filtering empties here would
        # graft the previous run's records onto this episode
        previous = (
            read_journal_episodes(rotated) if os.path.exists(rotated) else []
        )
        if not previous or previous[-1][0].get("_continuation"):
            raise ValueError(
                f"journal {path!r} starts mid-episode (rotation"
                " continuation) and the episode's head is no longer"
                " available — record with a larger --journal-max-bytes or"
                " replay the .1 generation"
            )
        head_meta, head_records = previous[-1]
        meta, records = head_meta, head_records + records
    return replay(records, meta, checkpoint, device=device)


def stitch_restart_episodes(path: str) -> list[dict[str, Any]]:
    """Pair every post-crash episode with its pre-crash predecessor.

    A controller rehydrating from a :class:`~..core.durable`
    snapshot stamps its fresh journal header with a ``restart`` meta
    block (snapshot content hash, recovered/expired record counts,
    downtime) — see ``DurableStateStore.restart_journal_meta``.  This
    walks the journal's episodes and returns one stitch per restart
    header: which snapshot the new boot rose from, how much state
    actually survived, and what the pre-crash episode looked like at
    the moment it died (tick count, last successful actuations) — the
    postmortem view of "did the state that mattered make it across".

    Rotation continuations are not restarts and are skipped; episodes
    without a ``restart`` block (pre-durability runs, cold starts onto
    a fresh path) contribute nothing.
    """
    from ..obs.journal import read_journal_episodes

    episodes = read_journal_episodes(path)
    stitches: list[dict[str, Any]] = []
    for index, (meta, records) in enumerate(episodes):
        restart = meta.get("restart")
        if not isinstance(restart, dict) or meta.get("_continuation"):
            continue
        # the pre-crash episode: the newest earlier non-continuation
        # boot plus its trailing continuations
        prior_records: list[TickRecord] = []
        for prior_meta, prior in reversed(episodes[:index]):
            prior_records = list(prior) + prior_records
            if not prior_meta.get("_continuation"):
                break
        stitches.append({
            "episode": index,
            "snapshot_hash": restart.get("snapshot_hash"),
            "records_recovered": restart.get("records_recovered"),
            "records_expired": restart.get("records_expired"),
            "cold_start": restart.get("cold_start"),
            "downtime_s": restart.get("downtime_s"),
            "prior_ticks": len(prior_records),
            "prior_scaled_up": sum(
                1 for r in prior_records if r.scaled("up")
            ),
            "prior_scaled_down": sum(
                1 for r in prior_records if r.scaled("down")
            ),
            "post_ticks": len(records),
        })
    return stitches


@dataclass(frozen=True)
class RecordedArrival:
    """Piecewise-constant arrival process inferred from a journal.

    Segment ``i`` carries ``rates[i]`` msg/s over ``[times[i],
    times[i+1])``; the last segment extends indefinitely (and the first
    extends backwards before ``times[0]``).  Satisfies the
    :class:`~.scenarios.ArrivalProcess` protocol, so the simulator
    integrates it exactly at observation points like any synthetic shape.

    One segment per recorded tick and one ``arrivals_between`` call per
    simulated tick would make a naive per-call scan O(n²) over an episode
    — a day-long journal is ~17k ticks — so the cumulative integral is
    precomputed once and each call is two O(log n) lookups.
    """

    times: tuple[float, ...]
    rates: tuple[float, ...]

    def __post_init__(self):
        if len(self.times) != len(self.rates):
            raise ValueError("times and rates must have equal length")
        cumulative = [0.0]
        for i in range(1, len(self.times)):
            cumulative.append(
                cumulative[-1]
                + self.rates[i - 1] * (self.times[i] - self.times[i - 1])
            )
        # frozen dataclass: the cache is set once here, never mutated
        object.__setattr__(self, "_cumulative", tuple(cumulative))

    def _segment(self, t: float) -> int:
        return max(0, bisect.bisect_right(self.times, t) - 1)

    def rate_at(self, t: float) -> float:
        if not self.times:
            return 0.0
        return self.rates[self._segment(t)]

    def _integral_to(self, t: float) -> float:
        """``∫ rate`` from ``times[0]`` to ``t`` (negative before it)."""
        if t <= self.times[0]:
            return self.rates[0] * (t - self.times[0])
        i = self._segment(t)
        return self._cumulative[i] + self.rates[i] * (t - self.times[i])

    def arrivals_between(self, t0: float, t1: float) -> float:
        if not self.times:
            return 0.0
        return self._integral_to(t1) - self._integral_to(t0)


def infer_arrivals(
    records: Sequence[TickRecord], meta: dict[str, Any]
) -> RecordedArrival:
    """Reconstruct the arrival process a recorded episode experienced.

    Between consecutive observations the queue gained ``Δdepth`` while
    ``replicas × service_rate`` drained it, so the interval's arrival rate
    is ``max(0, Δdepth + drained) / Δt`` — exact unless the queue emptied
    mid-interval (then a lower bound, same caveat as the simulator's own
    per-interval floor).  The replica count per interval is reconstructed
    from the journal's successful actuations and the world's bounds.

    Segment times are **episode-relative** (the first interval starts at
    0): the counterfactual simulator's clock starts at 0, so a live
    journal's wall-clock epochs must not leak into the process — with a
    sim journal's ``t0: 0`` the shift is a no-op.
    """
    world = meta.get("world") or {}
    if "service_rate_per_replica" not in world:
        raise ValueError(
            "journal meta lacks world.service_rate_per_replica — cannot"
            " infer arrivals (counterfactual needs a sim-recorded journal"
            " or a live journal with a world block)"
        )
    if not records:
        raise ValueError("journal holds no tick records")
    service_rate = float(world["service_rate_per_replica"])
    replicas = int(world.get("initial_replicas", 1))
    min_pods = int(world.get("min_pods", 1))
    max_pods = int(world.get("max_pods", 5))
    up_step = int(world.get("scale_up_pods", 1))
    down_step = int(world.get("scale_down_pods", 1))
    poll = float(meta.get("poll_interval", 5.0))
    t0 = float(meta.get("t0", records[0].start - poll))
    t_prev = t0
    depth_prev = float(world.get("initial_depth", 0.0))
    times: list[float] = []
    rates: list[float] = []
    for record in records:
        if record.num_messages is None:
            continue  # metric failure: no observation, interval extends
        dt = record.start - t_prev
        if dt > 0:
            drained = replicas * service_rate * dt
            arrived = max(0.0, record.num_messages - depth_prev + drained)
            times.append(t_prev - t0)
            rates.append(arrived / dt)
        if record.scaled("up"):
            replicas = min(max_pods, replicas + up_step)
        if record.scaled("down"):
            replicas = max(min_pods, replicas - down_step)
        t_prev = record.start
        depth_prev = float(record.num_messages)
    if not times:
        raise ValueError("journal holds no usable observation intervals")
    return RecordedArrival(tuple(times), tuple(rates))


def counterfactual(
    records: Sequence[TickRecord],
    meta: dict[str, Any],
    policy: str = "reactive",
    forecaster: str = "holt",
    horizon: float | None = None,
    slo_depth: float = 300.0,
    checkpoint: Any = None,
    *,
    device: str = "cuda",
) -> dict:
    """Re-score a recorded episode under any policy/forecaster.

    Rebuilds the recorded world (inferred arrivals + the journal's world
    parameters), runs the requested policy through the full closed-loop
    simulator, and scores it with the battery's
    :func:`~.evaluate.score_result` — so "what would the holt forecaster
    have done during yesterday's incident?" is one function call.

    ``policy="learned"`` re-scores a trained network
    (:mod:`..learn`): pass its ``checkpoint``; the row is labeled with
    the checkpoint's content hash so an incident review names exactly
    which weights the what-if ran.
    """
    from .evaluate import score_result

    records = list(records)
    world = meta.get("world") or {}
    arrival = infer_arrivals(records, meta)
    loop_config = loop_config_from_meta(meta)
    forecast = meta.get("forecast") or {}
    if horizon is None:
        horizon = float(forecast.get("horizon", 60.0))
    history = int(forecast.get("history", 128))
    min_samples = int(forecast.get("min_samples", 3))
    if policy == "learned":
        if checkpoint is None:
            raise ValueError(
                "counterfactual(policy='learned') needs the trained"
                " weights: pass checkpoint=load_checkpoint(path)"
            )
        # the feature window is part of what the weights mean — it comes
        # from the checkpoint, not from the journal's forecast block
        from ..learn.checkpoint import checkpoint_history

        history, min_samples = checkpoint_history(checkpoint)
    # duration spans ALL recorded ticks — metric-failure ticks consumed a
    # poll interval too, so filtering them out here would truncate the
    # rebuilt episode and score a shorter world than the recorded row
    duration = len(records) * loop_config.poll_interval
    sim = Simulation(
        SimConfig(
            arrival_rate=arrival,
            service_rate_per_replica=float(world["service_rate_per_replica"]),
            duration=duration,
            initial_depth=float(world.get("initial_depth", 0.0)),
            initial_replicas=int(world.get("initial_replicas", 1)),
            min_pods=int(world.get("min_pods", 1)),
            max_pods=int(world.get("max_pods", 5)),
            scale_up_pods=int(world.get("scale_up_pods", 1)),
            scale_down_pods=int(world.get("scale_down_pods", 1)),
            loop=loop_config,
            policy=policy,
            forecaster=forecaster,
            forecast_horizon=horizon,
            # honor the recorded forecast configuration like replay() does:
            # re-scoring "the recorded policy" with default warm-up/gating
            # would silently score a different policy
            forecast_history=history,
            forecast_min_samples=min_samples,
            forecast_conservative=bool(forecast.get("conservative", True)),
            learned_checkpoint=checkpoint if policy == "learned" else None,
        ),
        device=device,
    )
    result = sim.run()
    row = score_result(result, slo_depth)
    if policy == "reactive":
        row["policy"] = "reactive"
    elif policy == "learned":
        row["policy"] = f"learned@{checkpoint.hash}"
    else:
        row["policy"] = f"{policy}:{forecaster}"
    return row


def record_episode(
    config: SimConfig, journal_path: str, *, device: str = "cuda"
) -> "tuple[dict[str, Any], Any]":
    """Run one simulated episode with a flight journal attached.

    Returns ``(meta, SimResult)``; the journal lands on disk at
    ``journal_path`` ready for :func:`replay_journal`.  ``device`` is
    where a predictive or learned episode computes.
    """
    from ..obs.journal import TickJournal

    meta = sim_journal_meta(config)
    with TickJournal(journal_path, meta=meta) as journal:
        sim = Simulation(config, extra_observers=(journal,), device=device)
        result = sim.run()
    return meta, result


def _demo_config() -> SimConfig:
    """A short, scaling-active episode for the replay demo: a burst
    world that exercises both gates, cooldown skips, and bound clamps —
    sized so the fleet is *not* saturated, leaving the counterfactual
    forecasters real headroom to beat the recorded reactive run."""
    from .scenarios import BurstArrival

    return SimConfig(
        arrival_rate=BurstArrival(
            base=20.0, burst_rate=140.0, period=200.0,
            burst_len=60.0, first_burst=60.0,
        ),
        service_rate_per_replica=10.0,
        duration=400.0,
        initial_replicas=2,
        max_pods=20,
    )


def main(argv: Sequence[str] | None = None) -> int:
    """Record (or load) a journal, verify replay fidelity, print a verdict.

    Exit status 0 = tick-for-tick reproduction; 2 = divergence (the
    the replay demo contract: any decision drift fails the build).
    """
    parser = argparse.ArgumentParser(
        description="Replay a controller flight journal and verify the "
        "recorded decisions reproduce tick-for-tick."
    )
    parser.add_argument(
        "--journal", default="",
        help="journal to replay (default: record a fresh demo episode)",
    )
    parser.add_argument(
        "--record-to", default="",
        help="where the demo episode's journal is written (default: a"
        " temporary directory)",
    )
    parser.add_argument(
        "--checkpoint", default="",
        help="learned-policy checkpoint (JSON) for journals recorded under"
        " --policy=learned; must match the journal's recorded weights hash",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where a predictive or learned journal's decisions are"
        " recomputed (default: cuda; 'cpu' to run without a card)",
    )
    args = parser.parse_args(argv)
    checkpoint = None
    if args.checkpoint:
        from ..learn.checkpoint import CheckpointError, load_checkpoint

        try:
            checkpoint = load_checkpoint(args.checkpoint, device=args.device)
        except CheckpointError as err:
            parser.error(str(err))
    path = args.journal
    if not path:
        path = args.record_to or (
            tempfile.mkdtemp(prefix="replay-demo-") + "/journal.jsonl"
        )
        record_episode(_demo_config(), path)
    try:
        result = replay_journal(path, checkpoint=checkpoint,
                                device=args.device)
    except ValueError as err:
        # e.g. a learned journal without (or with mismatched) weights:
        # an actionable message and the tool's exit-2 verdict, not a
        # traceback
        print(f"cannot replay {path}: {err}", file=sys.stderr)
        return 2
    print(
        json.dumps(
            {
                "journal": path,
                "ticks": result.ticks,
                "divergences": len(result.divergences),
                "final_replicas": result.final_replicas,
                "trajectory_assumed_start": result.assumed_initial_replicas,
                "ok": result.ok,
            }
        )
    )
    for line in result.format_divergences():
        print(line, file=sys.stderr)
    return 0 if result.ok else 2


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
