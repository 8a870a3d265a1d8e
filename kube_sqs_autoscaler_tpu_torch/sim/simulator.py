"""Deterministic queue/worker-pool world driven by the production loop.

World model (fluid approximation of an SQS-fed worker Deployment):

- messages arrive at ``arrival_rate`` msg/s;
- each of the current ``replicas`` drains ``service_rate_per_replica`` msg/s;
- queue depth integrates the net rate, floored at zero, and is updated
  lazily whenever the controller observes it (each poll), so dynamics are
  exact at observation points regardless of poll cadence.

The controller under simulation is the real production stack —
``ControlLoop`` + ``PodAutoScaler`` + ``QueueMetricSource`` — wired to the
in-memory fakes on a ``FakeClock``; nothing is mocked *inside* the system
under test.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/simulator.py``: the
world and the loop are the same host code.  A predictive or learned
episode computes its forecasts and network decisions on the device that
:class:`Simulation`'s ``device`` keyword names (the card unless the
caller asks for the CPU); a reactive episode touches no device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:  # annotation-only: the reactive path stays lean
    from ..core.resilience import ResilienceConfig
    from ..learn.checkpoint import PolicyCheckpoint
    from .faults import FailureProcess

from ..core.clock import FakeClock
from ..core.events import MultiObserver, TickObserver
from ..core.loop import ControlLoop, LoopConfig
from ..metrics.fake import FakeQueueService
from ..metrics.queue import QueueMetricSource
from ..scale.actuator import PodAutoScaler
from ..scale.fake import FakeDeploymentAPI
from .scenarios import ArrivalProcess


@dataclass(frozen=True)
class SimConfig:
    """World + policy parameters (policy defaults = reference defaults).

    ``arrival_rate`` accepts the seed's plain msg/s number *or* any
    :class:`~.scenarios.ArrivalProcess` (step/ramp/diurnal/burst); a plain
    number keeps the exact constant-rate arithmetic of the seed.

    ``policy`` selects the depth policy the gates threshold through:
    ``"reactive"`` (the reference), ``"predictive"`` (forecasted depth at
    ``now + forecast_horizon`` via the named ``forecaster``), or
    ``"learned"`` (a trained network's up/hold/down decision expressed as
    an effective depth; requires ``learned_checkpoint``, reuses
    ``forecast_history``/``forecast_min_samples`` for its feature
    ring buffer and reactive warm-up).

    ``faults`` injects a deterministic :class:`~.faults.FailureProcess`
    around the metric source and scaler (``None`` = healthy world);
    ``resilience`` hands the loop an opt-in
    :class:`~..core.resilience.ResilienceConfig` (``None`` = reference
    failure handling) — the chaos battery (:mod:`.evaluate`) scores the
    two against each other.
    """

    arrival_rate: float | ArrivalProcess = 50.0  # msg/s into the queue
    service_rate_per_replica: float = 10.0  # msg/s drained per replica
    duration: float = 600.0  # simulated seconds
    initial_depth: float = 0.0
    initial_replicas: int = 1
    min_pods: int = 1
    max_pods: int = 20
    scale_up_pods: int = 1
    scale_down_pods: int = 1
    loop: LoopConfig = field(default_factory=LoopConfig)
    policy: str = "reactive"  # "reactive" | "predictive"
    forecaster: str = "holt"  # ewma | holt | lstsq (policy="predictive")
    forecast_horizon: float = 30.0  # seconds ahead the gates look
    forecast_history: int = 128  # ring-buffer capacity (samples)
    forecast_min_samples: int = 3  # reactive warm-up before forecasting
    forecast_conservative: bool = True  # gates see max(observed, forecast)
    faults: "FailureProcess | None" = None  # sim.faults injection
    resilience: "ResilienceConfig | None" = None  # core.resilience opt-in
    learned_checkpoint: "PolicyCheckpoint | None" = None  # policy="learned"


@dataclass
class SimResult:
    """Timeline of (t, observed_depth, replicas) at each poll + summary."""

    timeline: list[tuple[float, int, int]]
    final_replicas: int
    final_depth: float
    max_depth: float
    ticks: int

    @cached_property
    def replica_changes(self) -> int:
        """Scaling churn: ticks whose entering replica count changed.

        Cached: the recount is O(timeline) and sweep scoring
        (:mod:`.sweep`) reads it once per scored configuration — results
        are effectively frozen once built, so the first read's answer is
        the answer.
        """
        changes = 0
        for (_, _, a), (_, _, b) in zip(self.timeline, self.timeline[1:]):
            if a != b:
                changes += 1
        return changes

    def time_over(self, depth_threshold: float) -> float:
        """Simulated seconds the *observed* depth sat above ``depth_threshold``
        (left-rule over the observation timeline — the SLO metric the
        scenario battery reports)."""
        over = 0.0
        for (t0, d0, _), (t1, _, _) in zip(self.timeline, self.timeline[1:]):
            if d0 > depth_threshold:
                over += t1 - t0
        return over


class _WorldQueue(FakeQueueService):
    """Queue whose depth integrates arrivals/drains up to observation time."""

    def __init__(self, sim: "Simulation"):
        super().__init__()
        self._sim = sim

    def get_queue_attributes(self, queue_url, attribute_names):
        self._sim.advance_world()
        depth = int(self._sim.depth)
        self.set_queue_attributes({"ApproximateNumberOfMessages": str(depth)})
        return super().get_queue_attributes(queue_url, attribute_names)


class Simulation:
    """One closed-loop episode.

    ``extra_observers`` (e.g. a flight-recorder :class:`~..obs.journal.
    TickJournal`/``TickRing``) are fanned out on the loop's observer slot
    alongside any forecast history the policy needs — recording a
    simulated episode uses exactly the production observer seam.
    """

    def __init__(
        self,
        config: SimConfig | None = None,
        extra_observers: Sequence[TickObserver] = (),
        *,
        device: str = "cuda",
    ):
        self.config = config or SimConfig()
        self.device = device
        self.clock = FakeClock()
        self.depth = float(self.config.initial_depth)
        self._last_world_update = 0.0
        self.deployments = FakeDeploymentAPI.with_deployments(
            "sim", self.config.initial_replicas, "workers"
        )
        self.scaler = PodAutoScaler(
            client=self.deployments,
            max=self.config.max_pods,
            min=self.config.min_pods,
            scale_up_pods=self.config.scale_up_pods,
            scale_down_pods=self.config.scale_down_pods,
            deployment="workers",
            namespace="sim",
        )
        self.queue = _WorldQueue(self)
        self.metric_source = QueueMetricSource(
            client=self.queue,
            queue_url="sim://queue",
            attribute_names=("ApproximateNumberOfMessages",),
        )
        # Fault injection wraps the REAL source/scaler (the system under
        # test is unchanged); a failing poll still advances the world so
        # the timeline — and max_depth — track the backlog the controller
        # could not see.
        loop_metric_source = self.metric_source
        loop_scaler = self.scaler
        if self.config.faults is not None:
            from .faults import FaultyMetricSource, FaultyScaler

            loop_metric_source = FaultyMetricSource(
                self.metric_source,
                self.config.faults,
                self.clock,
                on_failure=self.advance_world,
            )
            loop_scaler = FaultyScaler(
                self.scaler, self.config.faults, self.clock
            )
        depth_policy = None
        observers: list[TickObserver] = list(extra_observers)
        if self.config.policy == "predictive":
            # Lazy import: the reactive path stays torch-free; only a
            # predictive episode pays the import.
            from ..device import resolve_device
            from ..forecast import DepthHistory, PredictivePolicy, make_forecaster

            # the loop logs a failing depth policy and falls back to the
            # observed depth: a missing card must fail here, not there
            resolve_device(device)
            history = DepthHistory(capacity=self.config.forecast_history)
            depth_policy = PredictivePolicy(
                make_forecaster(self.config.forecaster, device=device),
                history,
                horizon=self.config.forecast_horizon,
                min_samples=self.config.forecast_min_samples,
                conservative=self.config.forecast_conservative,
            )
            observers.insert(0, history)
        elif self.config.policy == "learned":
            # Lazy import like the predictive path: only a learned episode
            # pays the learn-package (and torch) import.
            from ..forecast import DepthHistory
            from ..learn import LearnedPolicy
            from ..learn.checkpoint import on_device

            if self.config.learned_checkpoint is None:
                raise ValueError(
                    "policy='learned' requires SimConfig.learned_checkpoint"
                )
            depth_policy = LearnedPolicy(
                on_device(self.config.learned_checkpoint, device),
                policy=self.config.loop.policy,
                poll_interval=self.config.loop.poll_interval,
                max_pods=self.config.max_pods,
                min_pods=self.config.min_pods,
                scale_up_pods=self.config.scale_up_pods,
                scale_down_pods=self.config.scale_down_pods,
                initial_replicas=self.config.initial_replicas,
                history=DepthHistory(capacity=self.config.forecast_history),
                min_samples=self.config.forecast_min_samples,
            )
            # the policy IS its own observer: the tick-record hook feeds
            # both the depth history and the replica/cooldown mirror
            observers.insert(0, depth_policy)
        elif self.config.policy != "reactive":
            raise ValueError(
                f"policy must be 'reactive', 'predictive' or 'learned',"
                f" got {self.config.policy!r}"
            )
        if not observers:
            observer: TickObserver | None = None
        elif len(observers) == 1:
            observer = observers[0]
        else:
            observer = MultiObserver(observers)
        self.depth_policy = depth_policy
        self.loop = ControlLoop(
            loop_scaler,
            loop_metric_source,
            self.config.loop,
            clock=self.clock,
            observer=observer,
            depth_policy=depth_policy,
            resilience=self.config.resilience,
        )
        self.timeline: list[tuple[float, int, int]] = []
        self._max_depth = self.depth

    def advance_world(self) -> None:
        """Integrate queue dynamics from the last update to clock.now()."""
        now = self.clock.now()
        dt = now - self._last_world_update
        if dt <= 0:
            return
        replicas = self.deployments.replicas("workers")
        arrival = self.config.arrival_rate
        if isinstance(arrival, (int, float)):
            # The seed's constant-rate arithmetic, expression-for-expression:
            # time-varying worlds must not perturb existing sim results.
            net_rate = arrival - replicas * self.config.service_rate_per_replica
            self.depth = max(0.0, self.depth + net_rate * dt)
        else:
            # Arrivals integrate analytically; the empty-queue floor is
            # per-interval, so a mid-interval empty + rate rise understates
            # depth by at most that interval's drain (see scenarios.py).
            arrived = arrival.arrivals_between(self._last_world_update, now)
            drained = replicas * self.config.service_rate_per_replica * dt
            self.depth = max(0.0, self.depth + arrived - drained)
        self._max_depth = max(self._max_depth, self.depth)
        self._last_world_update = now
        self.timeline.append((now, int(self.depth), replicas))

    def run(self) -> SimResult:
        ticks = max(1, int(self.config.duration / self.config.loop.poll_interval))
        self.loop.run(max_ticks=ticks)
        self.advance_world()
        return SimResult(
            timeline=self.timeline,
            final_replicas=self.deployments.replicas("workers"),
            final_depth=self.depth,
            max_depth=self._max_depth,
            ticks=self.loop.ticks,
        )
