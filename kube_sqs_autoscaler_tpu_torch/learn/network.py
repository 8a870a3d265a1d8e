"""The learned autoscaling policy's decision arithmetic, on torch tensors.

The port's copy of ``kube_sqs_autoscaler_tpu/learn/network.py``.  A tiny
MLP maps a fixed feature vector — observed depth, ring-buffer history
features (EWMA level + fitted trend, the forecasters' own functions),
tracked replicas, and the two cooldown states — to one of three actions:
*scale down*, *hold*, *scale up*.  The action is then expressed through
the :class:`~..core.types.DepthPolicy` seam as an **effective queue
depth**: ``scale_up_messages`` to trip the up gate,
``scale_down_messages`` to trip the down gate, or a value strictly
between the thresholds to trip neither (:func:`hold_depth`).  The
unchanged reference gates do the rest, so the network decides *when* to
scale but can never violate a cooldown or a bound.

The features and the network run in float32 on the device of the flat
parameter vector ``theta`` (the card unless the caller put it on the
CPU); the decision is read back as a host integer.  Below the warm-up the
decision is the observation and no device work is done.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..forecast.forecasters import ewma_level, lstsq_slope

#: Action codes — the argmax index over the network's output logits.
ACTION_DOWN, ACTION_HOLD, ACTION_UP = 0, 1, 2
N_ACTIONS = 3

#: Knob-head action codes.  A checkpoint saved with ``knob_head=True``
#: carries three extra output logits whose argmax is a knob DELTA — step
#: the armed engine knob (decode block, by default) down / hold / up one
#: rung of its ladder.
KNOB_ACTION_DOWN, KNOB_ACTION_HOLD, KNOB_ACTION_UP = 0, 1, 2
N_KNOB_ACTIONS = 3

#: The fixed feature vector (all float32, assembled in
#: :func:`policy_features`).
N_FEATURES = 8

#: Checkpoint/network geometry default.
DEFAULT_HIDDEN = 16

#: History-feature smoothing parameters, pinned here independently of
#: the forecasters' defaults: the features are part of the checkpoint
#: schema.
FEATURE_ALPHA = 0.3
FEATURE_WINDOW = 12

F32 = torch.float32


def n_outputs(knob_head: bool = False) -> int:
    """Output-layer width: 3 replica actions, +3 knob actions with the
    knob head armed."""
    return N_ACTIONS + (N_KNOB_ACTIONS if knob_head else 0)


def param_count(hidden: int = DEFAULT_HIDDEN,
                knob_head: bool = False) -> int:
    """Flat parameter vector length for one hidden layer of ``hidden``."""
    outputs = n_outputs(knob_head)
    return hidden * N_FEATURES + hidden + outputs * hidden + outputs


def init_params(seed: int, hidden: int = DEFAULT_HIDDEN,
                knob_head: bool = False) -> np.ndarray:
    """Seeded float32 init (scaled normal), deterministic per seed: the
    reference's numpy draw, so the same seed gives the same vector
    (:func:`params_from_numpy` puts it on a device)."""
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal(
        param_count(hidden, knob_head)
    ).astype(np.float32)
    theta[: hidden * N_FEATURES] *= np.float32(0.5 / np.sqrt(N_FEATURES))
    theta[hidden * N_FEATURES :] *= np.float32(0.5 / np.sqrt(hidden))
    return theta


def params_from_numpy(theta, device: str | torch.device) -> torch.Tensor:
    """A flat parameter vector (the reference's ``init_params`` or a
    checkpoint's numbers) as the port's float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(theta, dtype=np.float32),
                           device=device)


def hold_depth(scale_up_messages: int, scale_down_messages: int) -> int:
    """An effective depth that trips *neither* gate: strictly between the
    inclusive thresholds when the config leaves room, else the
    deterministic fallback ``down + 1``."""
    up, down = int(scale_up_messages), int(scale_down_messages)
    hold = (up + down) // 2
    if not down < hold < up:
        hold = down + 1
    return hold


def policy_logits(theta: torch.Tensor, features: torch.Tensor, hidden: int,
                  knob_head: bool = False) -> torch.Tensor:
    """MLP forward: ``features (F,) -> logits (3,)`` (or ``(6,)`` with the
    knob head — replica actions first, knob actions after); ``theta``
    flat.  The matvecs are broadcast-multiply + sum, as the reference
    writes them; the knob head only widens the output layer, so a
    headless theta's replica rows spliced into the knob-headed layout give
    the same replica logits."""
    f = N_FEATURES
    outputs = n_outputs(knob_head)
    o = 0
    w1 = theta[o : o + hidden * f].reshape(hidden, f)
    o += hidden * f
    b1 = theta[o : o + hidden]
    o += hidden
    w2 = theta[o : o + outputs * hidden].reshape(outputs, hidden)
    o += outputs * hidden
    b2 = theta[o : o + outputs]
    h = torch.tanh((w1 * features[None, :]).sum(1) + b1)
    return (w2 * h[None, :]).sum(1) + b2


def policy_features(
    times32: torch.Tensor,
    depths32: torch.Tensor,
    n: int,
    observed: int,
    replicas: int,
    frac_up32: float,
    frac_down32: float,
    scale_up_messages: int,
    max_pods: int,
    poll32: float,
    alpha32: float,
    window: int,
) -> torch.Tensor:
    """The fixed ``(8,)`` float32 feature vector on the history's device,
    in declaration order:

    0. observed depth / up threshold;
    1. EWMA depth level / up threshold (:func:`ewma_level`);
    2. fitted depth trend × poll interval / up threshold
       (:func:`lstsq_slope`);
    3. replicas / max pods;
    4. remaining up-cooldown fraction (1 = just fired, 0 = armed);
    5. remaining down-cooldown fraction;
    6. ``log1p(observed)/10``;
    7. constant 1.

    ``times32`` must be centered on the newest sample, as the
    forecasters require.  The host scalars are rounded to float32 as the
    reference's are; the two history features are computed on the
    device."""
    f32 = np.float32
    obs = f32(observed)
    up_scale = f32(max(int(scale_up_messages), 1))
    pods_scale = f32(max(int(max_pods), 1))
    level = ewma_level(depths32, n, float(alpha32))
    slope = lstsq_slope(times32, depths32, n, int(window))
    host = torch.tensor(
        [float(obs / up_scale), float(f32(replicas) / pods_scale),
         float(f32(frac_up32)), float(f32(frac_down32)),
         float(f32(math.log1p(float(obs))) * f32(0.1)), 1.0],
        dtype=F32).to(depths32.device, non_blocking=True)
    derived = torch.stack([level / float(up_scale),
                           slope * float(f32(poll32)) / float(up_scale)])
    return torch.cat([host[:1], derived, host[1:]])


def learned_decision(
    theta: torch.Tensor,
    times32: torch.Tensor,
    depths32: torch.Tensor,
    n: int,
    observed: int,
    replicas: int,
    frac_up32: float,
    frac_down32: float,
    scale_up_messages: int,
    scale_down_messages: int,
    hold: int,
    min_samples: int,
    max_pods: int,
    poll32: float,
    alpha32: float,
    window: int,
    *,
    hidden: int,
    knob_head: bool = False,
) -> int:
    """One tick's effective depth from history + state features.

    Below ``min_samples`` history observations the policy passes the
    observed depth through unchanged (the reactive warm-up), computing
    nothing on the device.  The result is clamped to ``>= 0``."""
    if n < min_samples:
        return max(0, int(observed))
    features = policy_features(
        times32, depths32, n, observed, replicas, frac_up32, frac_down32,
        scale_up_messages, max_pods, poll32, alpha32, window,
    )
    logits = policy_logits(theta, features, hidden, knob_head)
    action = int(torch.argmax(logits[:N_ACTIONS]))
    if action == ACTION_UP:
        decision = int(scale_up_messages)
    elif action == ACTION_DOWN:
        decision = int(scale_down_messages)
    else:
        decision = int(hold)
    return max(0, decision)


def knob_delta_decision(
    theta: torch.Tensor,
    times32: torch.Tensor,
    depths32: torch.Tensor,
    n: int,
    observed: int,
    replicas: int,
    frac_up32: float,
    frac_down32: float,
    scale_up_messages: int,
    min_samples: int,
    max_pods: int,
    poll32: float,
    alpha32: float,
    window: int,
    *,
    hidden: int,
) -> int:
    """The knob head's tick decision: a ladder DELTA in {-1, 0, +1} — step
    the armed engine knob down / hold / up.  Same feature vector, same
    warm-up contract as :func:`learned_decision` (below ``min_samples``
    the knob holds).  Requires a ``knob_head=True`` theta layout."""
    if n < min_samples:
        return 0
    features = policy_features(
        times32, depths32, n, observed, replicas, frac_up32, frac_down32,
        scale_up_messages, max_pods, poll32, alpha32, window,
    )
    logits = policy_logits(theta, features, hidden, knob_head=True)
    return int(torch.argmax(logits[N_ACTIONS : N_ACTIONS + N_KNOB_ACTIONS])) - 1


def cooldown_fraction(last: float, cooldown: float, now: float) -> float:
    """Remaining-cooldown fraction in [0, 1], computed in float64 on the
    host: ``((last + cooldown) - now) / cooldown`` with the zero floors
    (an epoch-sized ``now`` in float32 would lose the seconds that
    matter)."""
    if cooldown <= 0:
        return 0.0
    remaining = (last + cooldown) - now
    if remaining <= 0:
        return 0.0
    return remaining / cooldown
