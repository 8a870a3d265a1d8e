"""The learned policy on the real control loop.

The port's copy of ``kube_sqs_autoscaler_tpu/learn/policy.py``.
:class:`LearnedPolicy` is a :class:`~..core.types.DepthPolicy` — the seam
:class:`~..forecast.predictive.PredictivePolicy` rides — so the loop does
not know the decision came from a network: the policy returns an
*effective queue depth* and the unchanged reference gates do the rest.
Whatever the weights say, a learned episode can never violate a bound or
a cooldown the reactive episode respects.

The feature vector needs state the ``DepthPolicy`` call does not carry —
the replica count and the two cooldown stamps — so the policy also
implements :class:`~..core.events.TickObserver` and mirrors that state
from the per-tick record, with the arithmetic the gates and
``PodAutoScaler`` apply (``record.scaled``: gate FIRE + no actuation
error, boundary no-ops included).

Decision arithmetic lives in :func:`~.network.learned_decision`; it runs
on the device the checkpoint's ``theta`` is on (the card unless the
checkpoint was loaded for the CPU): one upload of the history snapshot,
the features and the MLP on the device, one read of the action.
"""

from __future__ import annotations

from ..core.events import TickRecord
from ..core.policy import PolicyConfig
from ..forecast.forecasters import snapshot_tensors
from ..forecast.history import DepthHistory
from .checkpoint import PolicyCheckpoint
from .network import (
    FEATURE_ALPHA,
    FEATURE_WINDOW,
    cooldown_fraction,
    hold_depth,
    knob_delta_decision,
    learned_decision,
)


class LearnedPolicy:
    """Threshold the gates on a trained network's up/hold/down decision.

    One instance drives one episode (like ``PredictivePolicy``'s history,
    the mirrored cooldown/replica state is episode-local).  Wire it into
    ``ControlLoop(depth_policy=policy, observer=policy)`` — the observer
    hook feeds both the depth history and the replica/cooldown mirror.
    """

    def __init__(
        self,
        checkpoint: PolicyCheckpoint,
        *,
        policy: PolicyConfig,
        poll_interval: float,
        max_pods: int,
        min_pods: int = 1,
        scale_up_pods: int = 1,
        scale_down_pods: int = 1,
        initial_replicas: int = 1,
        history: DepthHistory | None = None,
        min_samples: int = 3,
    ) -> None:
        from .checkpoint import TWIN_FLUID, require_twin

        # the deployment seam check: a serving-twin checkpoint's weights
        # mean shard counts and serving-plane features — thresholding
        # the fluid replica gates on them is silent garbage, so it must
        # be a load-time error here, not a bad episode later
        require_twin(checkpoint, TWIN_FLUID, "LearnedPolicy (ControlLoop)")
        self.checkpoint = checkpoint
        self.policy = policy
        self.poll_interval = float(poll_interval)
        self.max_pods = int(max_pods)
        self.min_pods = int(min_pods)
        self.scale_up_pods = int(scale_up_pods)
        self.scale_down_pods = int(scale_down_pods)
        self.history = history if history is not None else DepthHistory()
        # reactive warm-up below min_samples, same floor as PredictivePolicy
        self.min_samples = max(2, int(min_samples))
        self.name = f"learned@{checkpoint.hash}"
        self._theta = checkpoint.theta
        self._hidden = int(checkpoint.hidden)
        # the grown action space: a knob-headed checkpoint's
        # replica decision is computed the same way (first three
        # logits); its knob head additionally emits a ladder delta per
        # tick, read by sched.knobs.LearnedKnobPolicy off
        # `last_knob_delta` and actuated through the KnobActuator
        self._knob_head = bool(getattr(checkpoint, "knob_head", False))
        self.last_knob_delta: int | None = None
        self._hold = hold_depth(
            policy.scale_up_messages, policy.scale_down_messages
        )
        self.replicas = int(initial_replicas)
        # Cooldown mirror: the loop's initial_state(now) sets both stamps
        # at run() start, one poll interval BEFORE the first tick (sleep
        # first, then poll) — lazily initialized at the first call since
        # the policy cannot see the loop's start instant.
        self._last_up: float | None = None
        self._last_down: float | None = None
        #: scoreboard for the observability layer (same field the
        #: predictive policy exports: the depth the gates thresholded)
        self.last_prediction: int | None = None

    def effective_messages(self, now: float, num_messages: int) -> int:
        if self._last_up is None:
            self._last_up = now - self.poll_interval
            self._last_down = now - self.poll_interval
        times, depths, n = self.history.with_sample(now, float(num_messages))
        frac_up = cooldown_fraction(
            self._last_up, self.policy.scale_up_cooldown, now
        )
        frac_down = cooldown_fraction(
            self._last_down, self.policy.scale_down_cooldown, now
        )
        # f64 centering on the host before the float32 upload, the
        # forecasters' convention (_center_times)
        times32, depths32 = snapshot_tensors(times, depths, n,
                                             self._theta.device)
        features = (
            times32, depths32, n, int(num_messages), self.replicas,
            frac_up, frac_down, self.policy.scale_up_messages,
        )
        tail = (
            self.max_pods, self.poll_interval, FEATURE_ALPHA,
            FEATURE_WINDOW,
        )
        decision = learned_decision(
            self._theta, *features, self.policy.scale_down_messages,
            self._hold, self.min_samples, *tail, hidden=self._hidden,
            knob_head=self._knob_head,
        )
        if self._knob_head:
            # same features, the other head: one extra small forward per
            # tick, paid only by knob-headed checkpoints
            self.last_knob_delta = knob_delta_decision(
                self._theta, *features, self.min_samples, *tail,
                hidden=self._hidden,
            )
        self.last_prediction = decision
        return decision

    def take_knob_delta(self) -> int | None:
        """Consume this tick's knob-head delta (None once taken, and on
        ticks where no decision ran).  Consumption semantics on
        purpose: the knob adapter evaluates every tick, including
        metric-failure ticks where :meth:`effective_messages` never
        runs — re-applying a stale delta would walk the ladder
        repeatedly on ONE decision."""
        delta, self.last_knob_delta = self.last_knob_delta, None
        return delta

    # ------------------------------------------------------------------
    # Durable-state surface (core/durable.py StateProvider): the mirror
    # IS control state — a restart used to reset it to initial_replicas
    # and lazy cooldown stamps, feeding the network replica/cooldown
    # features from a world that no longer exists.
    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        state: dict = {
            "records": 1,
            "replicas": self.replicas,
            "last_up": self._last_up,
            "last_down": self._last_down,
            "checkpoint_hash": self.checkpoint.hash,
            "history": self.history.export_state(),
        }
        state["records"] += state["history"].get("records", 0)
        return state

    def import_state(
        self, state: dict, *, rebase: float = 0.0,
        now: float | None = None, max_age_s: float = 0.0,
    ) -> int:
        """Restore mirror + feature history.  A snapshot written under
        DIFFERENT weights is refused whole: the mirror's meaning (and
        the feature window) belongs to the checkpoint that ran."""
        if state.get("checkpoint_hash") not in (None, self.checkpoint.hash):
            return 0
        recovered = 0
        replicas = state.get("replicas")
        if replicas is not None:
            self.replicas = max(
                self.min_pods, min(self.max_pods, int(replicas))
            )
            recovered += 1
        for attr, key in (("_last_up", "last_up"), ("_last_down", "last_down")):
            stamp = state.get(key)
            if stamp is not None:
                setattr(self, attr, float(stamp) + rebase)
        history = state.get("history")
        if isinstance(history, dict):
            recovered += self.history.import_state(
                history, rebase=rebase, now=now, max_age_s=max_age_s
            )
        return recovered

    def reconcile_observed(self, replicas: int) -> None:
        """kube-controller style: the OBSERVED replica count outranks the
        remembered trajectory (the world may have scaled, crashed, or
        been edited while this controller was down)."""
        self.replicas = max(self.min_pods, min(self.max_pods, int(replicas)))

    def on_tick(self, record: TickRecord) -> None:
        """Mirror the world the features describe, from the tick record.

        History: successful fresh observations only (stale-held depths
        are an old observation at a new timestamp — same exclusion as
        ``DepthHistory.on_tick``).  Replicas/cooldowns: every successful
        actuation, stale ticks included (the gates really fired there),
        with ``PodAutoScaler``'s exact clamp arithmetic and the
        reference's success-only stamp advancement.
        """
        self.history.on_tick(record)
        if record.scaled("up"):
            self.replicas = min(
                self.max_pods, self.replicas + self.scale_up_pods
            )
            self._last_up = record.start
        if record.scaled("down"):
            self.replicas = max(
                self.min_pods, self.replicas - self.scale_down_pods
            )
            self._last_down = record.start
