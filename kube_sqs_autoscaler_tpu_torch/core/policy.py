"""Pure scaling policy: threshold + cooldown + startup grace.

The port's copy of ``kube_sqs_autoscaler_tpu/core/policy.py``.

This is the reference's control-loop *policy* (``main.go:35-80``) factored
into a side-effect-free function, per SURVEY.md §7.1 step 2.  All eight
behavioral subtleties documented in SURVEY.md §2.2-C2 are reproduced:

1.  Both cooldown timestamps start at "now" (``main.go:37-38``) — no scaling
    during the first cooldown window after boot.  See :func:`initial_state`.
2.  The loop sleeps first, then polls (``main.go:41``) — that lives in
    :mod:`.loop`, not here.
3.  Metric errors skip the tick (loop concern).
4.  Observation logging (loop concern).
5.  Scale-up gate is inclusive: ``num_messages >= scale_up_messages``
    (``main.go:51``).  Cooldown is "still cooling" iff
    ``last + cooldown > now`` strictly (``main.go:52``:
    ``lastScaleUpTime.Add(cool).After(now)``), so a tick landing exactly on
    the cooldown boundary *fires*.  While cooling with a high queue, the
    scale-down branch must not even be evaluated that tick (the ``continue``
    at ``main.go:54``) — encoded as ``TickPlan.down is Gate.SKIPPED``.
6.  Scale-down gate is inclusive: ``num_messages <= scale_down_messages``
    (``main.go:65``), with its own cooldown, symmetric.
7.  The branches are ``if`` + ``if``, not ``else if`` (``main.go:51,65``):
    with overlapping thresholds one tick can scale up *and then* down.
8.  Timestamps advance only on *successful* actuation (``main.go:62,76``);
    a boundary no-op returns success and therefore *does* refresh the
    timestamp.  The plan cannot know success in advance, so execution-order
    rules are part of the plan contract (see :class:`TickPlan`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace


class Gate(enum.Enum):
    """Outcome of one scaling gate for one tick."""

    IDLE = "idle"  # threshold not met
    FIRE = "fire"  # threshold met, cooldown elapsed: actuate
    COOLING = "cooling"  # threshold met but still in cooldown: log + end tick
    SKIPPED = "skipped"  # not evaluated (an earlier gate ended the tick)


# Integer gate codes: the array-friendly twin of :class:`Gate`, kept so
# that :func:`gate_code` stays the one place the decision arithmetic
# lives (the reference's compiled simulator evaluates it on arrays).
GATE_IDLE, GATE_FIRE, GATE_COOLING, GATE_SKIPPED = 0, 1, 2, 3
GATE_BY_CODE: tuple[Gate, ...] = (Gate.IDLE, Gate.FIRE, Gate.COOLING, Gate.SKIPPED)


def gate_code(threshold_met, now, last, cooldown):
    """Branchless core of both gates; works elementwise on arrays.

    Encodes the two reference subtleties shared by ``main.go:51-52`` and
    ``main.go:65-66``: the threshold test is inclusive (callers pass the
    already-evaluated ``threshold_met``), and cooldown is "still cooling"
    iff ``last + cooldown > now`` *strictly* — a tick landing exactly on
    the boundary fires.  Returns ``GATE_IDLE``/``GATE_FIRE``/
    ``GATE_COOLING``; all inputs may be Python scalars or numpy arrays.
    """
    cooling = last + cooldown > now
    return threshold_met * (GATE_FIRE + cooling)


@dataclass(frozen=True)
class PolicyConfig:
    """Thresholds and cooldowns (reference defaults, ``main.go:83-87``)."""

    scale_up_messages: int = 100  # --scale-up-messages
    scale_down_messages: int = 10  # --scale-down-messages
    scale_up_cooldown: float = 10.0  # --scale-up-cool-down (seconds)
    scale_down_cooldown: float = 30.0  # --scale-down-cool-down (seconds)


@dataclass(frozen=True)
class PolicyState:
    """The policy's entire memory: two cooldown timestamps (``main.go:37-38``)."""

    last_scale_up: float
    last_scale_down: float


@dataclass(frozen=True)
class TickPlan:
    """A whole tick's decisions as one pure value (both gates at one instant).

    Used for analysis and property tests.  The live loop instead calls
    :func:`gate_up` / :func:`gate_down` sequentially — the reference
    re-reads ``time.Now()`` when it reaches the down branch
    (``main.go:66``), after the scale-up RPCs, so under a real clock the
    down gate must be evaluated with a *fresh* timestamp, not the one the
    up gate saw.
    """

    up: Gate
    down: Gate


def initial_state(now: float) -> PolicyState:
    """Startup grace: both cooldowns start 'just scaled' (``main.go:37-38``)."""
    return PolicyState(last_scale_up=now, last_scale_down=now)


def gate_up(
    num_messages: int, now: float, config: PolicyConfig, state: PolicyState
) -> Gate:
    """The scale-up gate (``main.go:51-52``). Pure."""
    return GATE_BY_CODE[
        int(
            gate_code(
                num_messages >= config.scale_up_messages,
                now,
                state.last_scale_up,
                config.scale_up_cooldown,
            )
        )
    ]


def gate_down(
    num_messages: int, now: float, config: PolicyConfig, state: PolicyState
) -> Gate:
    """The scale-down gate (``main.go:65-66``). Pure."""
    return GATE_BY_CODE[
        int(
            gate_code(
                num_messages <= config.scale_down_messages,
                now,
                state.last_scale_down,
                config.scale_down_cooldown,
            )
        )
    ]


def plan_tick(
    num_messages: int,
    now: float,
    config: PolicyConfig,
    state: PolicyState,
) -> TickPlan:
    """Both gates at one instant. Pure; no clocks, no I/O, no mutation."""
    up = gate_up(num_messages, now, config, state)
    if up is Gate.COOLING:
        # the reference `continue`s: the down branch is never evaluated
        return TickPlan(up=up, down=Gate.SKIPPED)
    return TickPlan(up=up, down=gate_down(num_messages, now, config, state))


def mark_scaled_up(state: PolicyState, now: float) -> PolicyState:
    """State after a *successful* scale-up actuation (``main.go:62``)."""
    return replace(state, last_scale_up=now)


def mark_scaled_down(state: PolicyState, now: float) -> PolicyState:
    """State after a *successful* scale-down actuation (``main.go:76``)."""
    return replace(state, last_scale_down=now)
