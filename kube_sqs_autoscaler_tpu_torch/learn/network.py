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

Each step has a batched form over ``[B]`` rows with ``[B, P]`` thetas
(``*_rows``, what the compiled twins run inside their episodes, the
decision staying on the device); the live single-row functions are that
form with one row, every sum an elementwise chain whose order does not
depend on ``B``, so a live episode and a compiled one take the same
decisions bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..forecast.forecasters import ewma_level_rows, lstsq_slope_rows

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


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension left to right, one elementwise add a
    term: the same bits for a row alone and inside a batch (a matmul or
    library reduction picks its order from the shape)."""
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def policy_logits_rows(theta: torch.Tensor, features: torch.Tensor,
                       hidden: int, knob_head: bool = False) -> torch.Tensor:
    """MLP forward for ``[B]`` rows: ``theta [B, P]``, ``features [B, F]``
    -> logits ``[B, 3]`` (``[B, 6]`` with the knob head — replica actions
    first, knob actions after).  The matvecs are broadcast-multiply +
    :func:`seq_sum`, as the reference writes them; the knob head only
    widens the output layer, so a headless theta's replica rows spliced
    into the knob-headed layout give the same replica logits."""
    f = N_FEATURES
    outputs = n_outputs(knob_head)
    rows = theta.shape[0]
    o = 0
    w1 = theta[:, o : o + hidden * f].reshape(rows, hidden, f)
    o += hidden * f
    b1 = theta[:, o : o + hidden]
    o += hidden
    w2 = theta[:, o : o + outputs * hidden].reshape(rows, outputs, hidden)
    o += outputs * hidden
    b2 = theta[:, o : o + outputs]
    h = torch.tanh(seq_sum(w1 * features[:, None, :]) + b1)
    return seq_sum(w2 * h[:, None, :]) + b2


def policy_logits(theta: torch.Tensor, features: torch.Tensor, hidden: int,
                  knob_head: bool = False) -> torch.Tensor:
    """:func:`policy_logits_rows` for one row: ``features (F,) -> logits
    (3,)`` (or ``(6,)`` with the knob head); ``theta`` flat."""
    return policy_logits_rows(theta[None], features[None], hidden,
                              knob_head)[0]


def policy_features_rows(
    times32: torch.Tensor,
    depths32: torch.Tensor,
    n: torch.Tensor,
    observed: torch.Tensor,
    replicas: torch.Tensor,
    frac_up32: torch.Tensor,
    frac_down32: torch.Tensor,
    scale_up_messages: torch.Tensor,
    max_pods: torch.Tensor,
    poll32: torch.Tensor,
    ewma: tuple[torch.Tensor, torch.Tensor],
    window: torch.Tensor,
    width: int,
) -> torch.Tensor:
    """The fixed ``[B, 8]`` float32 feature vectors of ``[B]`` rows, in
    declaration order:

    0. observed depth / up threshold;
    1. EWMA depth level / up threshold (:func:`ewma_level_rows`);
    2. fitted depth trend × poll interval / up threshold
       (:func:`lstsq_slope_rows`);
    3. replicas / max pods;
    4. remaining up-cooldown fraction (1 = just fired, 0 = armed);
    5. remaining down-cooldown fraction;
    6. ``log1p(observed)/10``;
    7. constant 1.

    Every argument is a ``[B]`` (or ``[B, C]``) tensor on one device but
    ``ewma`` (:func:`~..forecast.forecasters.ewma_tables` of the feature
    alpha) and ``width`` (a host bound on ``window``).  ``times32`` must
    be centered on the newest sample, as the forecasters require."""
    obs = observed.to(F32)
    up_scale = scale_up_messages.clamp(min=1).to(F32)
    pods_scale = max_pods.clamp(min=1).to(F32)
    level = ewma_level_rows(depths32, n, *ewma)
    slope = lstsq_slope_rows(times32, depths32, n, window, width)
    log_obs = torch.log1p(observed.to(torch.float64)).to(F32) * 0.1
    return torch.stack([
        obs / up_scale, level / up_scale, slope * poll32 / up_scale,
        replicas.to(F32) / pods_scale, frac_up32, frac_down32, log_obs,
        torch.ones_like(obs)], dim=1)


def _argmax3(logits: torch.Tensor) -> torch.Tensor:
    """Index of the largest of three logits per row, the lowest index on
    a tie (``argmax``'s rule), from elementwise comparisons."""
    best = logits[:, 0]
    action = torch.zeros_like(best, dtype=torch.int64)
    for k in (1, 2):
        better = logits[:, k] > best
        action = torch.where(better, k, action)
        best = torch.where(better, logits[:, k], best)
    return action


def learned_decision_rows(
    theta: torch.Tensor,
    features: torch.Tensor,
    n: torch.Tensor,
    observed: torch.Tensor,
    scale_up_messages: torch.Tensor,
    scale_down_messages: torch.Tensor,
    hold: torch.Tensor,
    min_samples: torch.Tensor,
    *,
    hidden: int,
    knob_head: bool = False,
) -> torch.Tensor:
    """``[B]`` effective depths (int64) from ``[B, 8]`` features: the
    action's threshold, or the observation below ``min_samples`` history
    observations (the reactive warm-up); clamped to ``>= 0``."""
    logits = policy_logits_rows(theta, features, hidden, knob_head)
    action = _argmax3(logits[:, :N_ACTIONS])
    decision = torch.where(
        action == ACTION_UP, scale_up_messages,
        torch.where(action == ACTION_DOWN, scale_down_messages, hold))
    decision = torch.where(n < min_samples, observed, decision)
    return decision.clamp(min=0)


def _features_one(times32, depths32, n, observed, replicas, frac_up32,
                  frac_down32, scale_up_messages, max_pods, poll32, alpha32,
                  window):
    """One row's features: the host scalars in one upload, then
    :func:`policy_features_rows`."""
    from ..forecast.forecasters import one_row, ewma_tables

    device = depths32.device
    row = one_row(device, int(n), int(observed), int(replicas),
                   float(np.float32(frac_up32)),
                   float(np.float32(frac_down32)), int(scale_up_messages),
                   int(max_pods), float(np.float32(poll32)), int(window))
    ewma = ewma_tables([float(alpha32)], depths32.shape[0], device)
    return policy_features_rows(times32[None], depths32[None], row[0],
                                *row[1:8], ewma, row[8], int(window))


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
    """One snapshot's ``(8,)`` float32 feature vector on the history's
    device (:func:`policy_features_rows` with one row; the host scalars
    rounded to float32 as the reference's are)."""
    return _features_one(times32, depths32, n, observed, replicas,
                         frac_up32, frac_down32, scale_up_messages, max_pods,
                         poll32, alpha32, window)[0]


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
    nothing on the device.  The result is clamped to ``>= 0``.  Above it,
    the decision is :func:`learned_decision_rows`' for one row, read back
    as a host integer."""
    if n < min_samples:
        return max(0, int(observed))
    features = _features_one(
        times32, depths32, n, observed, replicas, frac_up32, frac_down32,
        scale_up_messages, max_pods, poll32, alpha32, window,
    )
    action = int(_argmax3(
        policy_logits_rows(theta[None], features, hidden,
                           knob_head)[:, :N_ACTIONS])[0])
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
    features = _features_one(
        times32, depths32, n, observed, replicas, frac_up32, frac_down32,
        scale_up_messages, max_pods, poll32, alpha32, window,
    )
    logits = policy_logits_rows(theta[None], features, hidden,
                                knob_head=True)
    return int(_argmax3(logits[:, N_ACTIONS : N_ACTIONS + N_KNOB_ACTIONS])[0]) - 1


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
