"""Queue-depth forecasters behind one protocol, on torch tensors.

The port's copy of ``kube_sqs_autoscaler_tpu/forecast/forecasters.py``.
Each forecaster's math is a plain function over the fixed-shape
``(times, depths, n)`` snapshot a :class:`~.history.DepthHistory`
produces, on tensors of an explicit device (the forecaster classes put the
snapshot on theirs: the card unless they are asked for the CPU).

The three families cover the classical trend spectrum:

- **EWMA** — exponentially weighted level, flat extrapolation.
- **Holt** — double exponential smoothing (level + trend), linear
  extrapolation ``level + trend * steps(horizon)``.
- **Windowed least squares** — exact line fit over the last ``window``
  samples against *actual* sample times, linear extrapolation.

All predictions are clamped to ``>= 0`` (queue depth is nonnegative).

The reference runs EWMA and Holt as masked ``lax.scan`` recurrences over
the ring's capacity.  The EWMA level is a closed form here: a weighted sum
of the ``n`` valid samples, weights and sum in float64, the level
float32 (a handful of launches).  Holt runs the reference's float32
recurrence step by step over the ``n`` valid samples (seven launches a
sample): its trend can cancel its level, and there the float32 rounding
of the scan is part of the value.  The least-squares fit runs the
reference's float32 sums over the window.  A forecast is one upload of
the snapshot and one read of its result.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..device import resolve_device

F32 = torch.float32
F64 = torch.float64


@runtime_checkable
class Forecaster(Protocol):
    """Predicts queue depth ``horizon`` seconds past the newest sample."""

    name: str

    def predict(
        self, times: np.ndarray, depths: np.ndarray, n: int, horizon: float
    ) -> float:
        """Forecast depth at ``times[n-1] + horizon`` from the first ``n``
        (chronological) samples of fixed-shape ``times``/``depths``."""
        ...


def _f32(value: float) -> float:
    """``value`` rounded to float32, as the reference's weak-typed
    scalars are inside its float32 programs."""
    return float(np.float32(value))


@functools.lru_cache(maxsize=64)
def _ewma_powers(alpha: float, capacity: int,
                 device: torch.device) -> torch.Tensor:
    """The EWMA's weights, newest sample last, float64 on ``device``: row
    ``j`` holds ``keep**k`` (what a first sample ``k`` samples before the
    newest contributes) and ``alpha * keep**k`` (a later one), ``k =
    capacity - 1 - j``."""
    keep = _f32(np.float32(1.0) - np.float32(alpha))
    powers = keep ** np.arange(capacity - 1, -1, -1, dtype=np.float64)
    table = np.stack([powers, _f32(alpha) * powers], axis=1)
    return torch.as_tensor(table, dtype=F64, device=device)


def ewma_level(depths: torch.Tensor, n: int, alpha: float) -> torch.Tensor:
    """The EWMA level after the first ``n`` entries (0 when ``n`` is 0), a
    float32 scalar on ``depths``' device.  The first sample sets the
    level; each later one moves it by ``alpha`` toward itself.  A closed
    form: the weighted sum of the samples, in float64."""
    if n <= 0:
        return torch.zeros((), dtype=F32, device=depths.device)
    capacity = depths.shape[0]
    weights = _ewma_powers(alpha, capacity, depths.device)[capacity - n:]
    d = depths[:n].to(F64)
    level = weights[0, 0] * d[0] + (weights[1:, 1] * d[1:]).sum()
    return level.to(F32)


def holt_forecast(
    times: torch.Tensor,
    depths: torch.Tensor,
    n: int,
    horizon: float,
    alpha: float,
    beta: float,
) -> torch.Tensor:
    """Holt level+trend over the first ``n`` entries, extrapolated: a
    float32 scalar on the tensors' device.

    The trend is per *sample step*; the horizon converts to steps via the
    mean observed inter-sample interval, so the forecast is calibrated in
    seconds whatever the poll cadence.  ``times`` must already be centered
    on the newest sample (:func:`_center_times`)."""
    zero = torch.zeros((), dtype=F32, device=depths.device)
    level = trend = zero
    if n > 0:
        # the reference's float32 recurrence, step by step: level and
        # trend are sequential, and a closed form (exact in float64)
        # differs from the float32 scan by more than the forecast's
        # tolerance where a drain's trend cancels its level
        a = _f32(alpha)
        keep_level = _f32(np.float32(1.0) - np.float32(alpha))
        b = _f32(beta)
        keep_trend = _f32(np.float32(1.0) - np.float32(beta))
        pulled = a * depths[:n]
        level = depths[0]
        for i in range(1, n):
            new_level = pulled[i] + keep_level * (level + trend)
            trend = b * (new_level - level) + keep_trend * trend
            level = new_level
    t_last = times[max(n - 1, 0)]
    mean_dt = (t_last - times[0]) / max(n - 1, 1)
    steps = torch.where(mean_dt > 0, _f32(horizon) / mean_dt, zero)
    return torch.clamp(level + trend * steps, min=0.0)


def _lstsq_fit(times, depths, n, window):
    """Normal-equations core of the windowed line fit, in float32:
    ``(slope, intercept, depth_last, degenerate)``, shared by
    :func:`lstsq_forecast` and :func:`lstsq_slope` (the learned policy's
    trend feature)."""
    last = max(n - 1, 0)
    start = min(max(n - window, 0), n)
    x = times[start:n] - times[last]
    y = depths[start:n]
    count = float(n - start)
    sx = x.sum()
    sy = y.sum()
    sxx = (x * x).sum()
    sxy = (x * y).sum()
    denom = count * sxx - sx * sx
    depth_last = depths[last]
    degenerate = denom.abs() < 1e-9  # < 2 samples or coincident times
    safe_denom = torch.where(degenerate, torch.ones_like(denom), denom)
    slope = (count * sxy - sx * sy) / safe_denom
    intercept = (sy - slope * sx) / max(count, 1.0)
    return slope, intercept, depth_last, degenerate


def lstsq_forecast(
    times: torch.Tensor,
    depths: torch.Tensor,
    n: int,
    horizon: float,
    window: int,
) -> torch.Tensor:
    """Line fit over the last ``min(window, n)`` samples, extrapolated
    ``horizon`` past the newest (centered ``times``, so the prediction is
    ``intercept + slope * horizon``)."""
    slope, intercept, depth_last, degenerate = _lstsq_fit(
        times, depths, n, window
    )
    fit = intercept + slope * _f32(horizon)
    return torch.clamp(torch.where(degenerate, depth_last, fit), min=0.0)


def lstsq_slope(times: torch.Tensor, depths: torch.Tensor, n: int,
                window: int) -> torch.Tensor:
    """Fitted depth trend (msg/s) over the last ``min(window, n)``
    samples; zero while degenerate (< 2 samples or coincident times)."""
    slope, _, _, degenerate = _lstsq_fit(times, depths, n, window)
    return torch.where(degenerate, torch.zeros_like(slope), slope)


def _center_times(times: np.ndarray, n: int) -> np.ndarray:
    """Times relative to the newest sample, in float64 on the host BEFORE
    the float32 cast.  Raw ``time.monotonic()`` stamps grow unboundedly
    (seconds since boot); at ~1e8 s float32 spacing is 8 s, which silently
    corrupts 5 s poll intervals.  Centered deltas are small and exact."""
    times = np.asarray(times, dtype=np.float64)
    return times - times[max(n - 1, 0)]


def snapshot_tensors(times: np.ndarray | None, depths: np.ndarray, n: int,
                     device: torch.device):
    """A history snapshot as the float32 tensors the functions take, on
    ``device``: centered times (``None`` when not given) and depths, in
    one upload."""
    depths = np.asarray(depths, dtype=np.float32)
    if times is None:
        return None, torch.as_tensor(depths, device=device)
    both = np.stack([_center_times(times, n).astype(np.float32), depths])
    both = torch.as_tensor(both, device=device)
    return both[0], both[1]


@dataclass(frozen=True)
class EwmaForecaster:
    """Flat extrapolation of an exponentially weighted level."""

    alpha: float = 0.3
    name: str = "ewma"
    device: str = "cuda"

    def predict(self, times, depths, n, horizon) -> float:
        del times, horizon  # EWMA's forecast is horizon-independent
        _, d = snapshot_tensors(None, depths, n, resolve_device(self.device))
        return float(max(0.0, float(ewma_level(d, n, self.alpha))))


@dataclass(frozen=True)
class HoltForecaster:
    """Double exponential smoothing: level + trend, linear extrapolation."""

    alpha: float = 0.5
    beta: float = 0.3
    name: str = "holt"
    device: str = "cuda"

    def predict(self, times, depths, n, horizon) -> float:
        t, d = snapshot_tensors(times, depths, n, resolve_device(self.device))
        return float(holt_forecast(t, d, n, horizon, self.alpha, self.beta))


@dataclass(frozen=True)
class LeastSquaresForecaster:
    """Exact line fit over the last ``window`` samples' actual times."""

    window: int = 12
    name: str = "lstsq"
    device: str = "cuda"

    def predict(self, times, depths, n, horizon) -> float:
        t, d = snapshot_tensors(times, depths, n, resolve_device(self.device))
        return float(lstsq_forecast(t, d, n, horizon, self.window))


_FORECASTERS = {
    "ewma": EwmaForecaster,
    "holt": HoltForecaster,
    "lstsq": LeastSquaresForecaster,
}

FORECASTER_NAMES: tuple[str, ...] = tuple(_FORECASTERS)


def make_forecaster(name: str, **params) -> Forecaster:
    """Build a forecaster by CLI name (``ewma``/``holt``/``lstsq``);
    ``device=`` picks where it runs (``"cuda"`` by default)."""
    try:
        cls = _FORECASTERS[name]
    except KeyError:
        raise ValueError(
            f"unknown forecaster {name!r}; choose from {FORECASTER_NAMES}"
        ) from None
    return cls(**params)
